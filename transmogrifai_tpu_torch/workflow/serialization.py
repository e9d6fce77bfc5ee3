"""Workflow model (de)serialization in the JAX package's format.

The port's counterpart of ``transmogrifai_tpu/workflow/serialization.py``
(reference: OpWorkflowModelWriter.scala:56, OpWorkflowModelReader.scala):
the JSON manifest names every stage by its importable class path, and the
fitted arrays go to the ``.npz`` bundle.  A class path of the JAX package
(``transmogrifai_tpu.<module>``) maps to the port's module of the same name
(``transmogrifai_tpu_torch.<module>``) at load, and back at save, so a model
either package saved loads in both.  The port's device placement (a stage's
``device``, a predictor's device copy of its parameters) is not saved.
"""
from __future__ import annotations

import importlib
import inspect
import json
import os
import tempfile
import textwrap
import weakref
from typing import Any, Dict

import numpy as np

from .. import types as T
from ..features.aggregators import (ConcatText, CustomMonoidAggregator, LogicalOr,
                                    MaxNumeric, MeanNumeric, MinNumeric, MonoidAggregator,
                                    SumNumeric, TimeBasedAggregator, UnionCollection, UnionMap)
from ..features.feature import Feature
from ..features.generator import (Extractor, FeatureGeneratorStage, FieldExtractor,
                                  FnExtractor)
from ..features.metadata import VectorMetadata
from ..stages.base import PipelineStage
from ..utils.device import resolve_device

MODEL_MANIFEST = "op_model.json"
MODEL_ARRAYS = "op_model_arrays.npz"
_JAX_PACKAGE = "transmogrifai_tpu"
_PORT_PACKAGE = "transmogrifai_tpu_torch"


_SKIP_ATTRS = {"operation_name", "output_type", "uid", "_params", "inputs", "_outputs",
               "metadata", "parent_uid", "input_type", "n_outputs",
               # the port's placement on a device, rebuilt at load; a
               # stage's keep-set of the running plan; its device constants
               "device", "_dparams", "_kept", "_device_constants"}


def port_module(mod_name: str) -> str:
    """The port's module for a saved module path: the JAX package's prefix
    maps to the port's; any other path (already the port's, or a user
    module) is kept."""
    if mod_name == _JAX_PACKAGE or mod_name.startswith(_JAX_PACKAGE + "."):
        return _PORT_PACKAGE + mod_name[len(_JAX_PACKAGE):]
    return mod_name


def jax_module(mod_name: str) -> str:
    """The saved module path of a port module: the inverse of
    ``port_module``, so the manifest names the JAX package's classes."""
    if mod_name == _PORT_PACKAGE or mod_name.startswith(_PORT_PACKAGE + "."):
        return _JAX_PACKAGE + mod_name[len(_PORT_PACKAGE):]
    return mod_name


def _class_path(cls: type) -> str:
    return f"{jax_module(cls.__module__)}:{cls.__qualname__}"


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    if hasattr(obj, "to_json"):
        return obj.to_json()
    return obj


def _encode(value: Any, arrays: Dict[str, np.ndarray], prefix: str) -> Any:
    if isinstance(value, np.ndarray):
        key = f"{prefix}#{len(arrays)}"
        arrays[key] = value
        return {"__array__": key}
    if isinstance(value, (np.floating, np.integer, np.bool_)):
        return value.item()
    if isinstance(value, VectorMetadata):
        return {"__vector_metadata__": value.to_json()}
    if isinstance(value, PipelineStage):
        return {"__stage__": _encode_stage(value, arrays)}
    if isinstance(value, type) and issubclass(value, T.FeatureType):
        return {"__ftype__": value.__name__}
    if isinstance(value, type):
        return {"__class_ref__": _class_path(value)}
    if isinstance(value, dict):
        return {"__dict__": {str(k): _encode(v, arrays, prefix) for k, v in value.items()}}
    if isinstance(value, tuple):
        return {"__tuple__": [_encode(v, arrays, prefix) for v in value]}
    if isinstance(value, list):
        return [_encode(v, arrays, prefix) for v in value]
    if isinstance(value, set):
        return {"__set__": [_encode(v, arrays, prefix) for v in sorted(value, key=repr)]}
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if hasattr(value, "to_json") and hasattr(type(value), "from_json"):
        return {"__jsonable__": {"class": _class_path(type(value)), "data": value.to_json()}}
    raise TypeError(f"Cannot serialize value of type {type(value).__name__}: {value!r}")


def _encode_stage(stage: PipelineStage, arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    state = {}
    for k, v in vars(stage).items():
        if k in _SKIP_ATTRS or k.startswith("__"):
            continue
        if callable(v) and not isinstance(v, (PipelineStage, Extractor, type)):
            continue
        if isinstance(v, Extractor):
            state[k] = {"__extractor__": _encode_extractor(v)}
            continue
        if isinstance(v, MonoidAggregator):
            state[k] = {"__aggregator__": _encode_aggregator(v)}
            continue
        state[k] = _encode(v, arrays, stage.uid)
    return {
        "class": _class_path(type(stage)),
        "uid": stage.uid,
        "operationName": stage.operation_name,
        "outputType": stage.output_type.__name__,
        "nOutputs": stage.n_outputs,
        "params": _encode(stage._params, arrays, stage.uid + "/params"),
        "parentUid": getattr(stage, "parent_uid", None),
        "inputUids": [f.uid for f in stage.inputs],
        "outputNames": [f.name for f in (stage._outputs or [])],
        "outputUids": [f.uid for f in (stage._outputs or [])],
        "metadata": _jsonable(stage.metadata),
        "state": state,
    }


#: the source of each callable recovered at load, so saving the model again
#: keeps it (such a callable has no source file ``inspect`` could read)
_LOADED_SOURCES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _encode_extractor(ex: Extractor) -> Dict[str, Any]:
    if isinstance(ex, FieldExtractor):
        return ex.spec
    if isinstance(ex, FnExtractor):
        try:
            src = textwrap.dedent(inspect.getsource(ex.fn)).strip()
        except (OSError, TypeError):
            # a callable recovered from a saved model keeps its source
            src = _LOADED_SOURCES.get(ex.fn)
        return {"kind": "fn_source", "type": ex.ftype.__name__, "source": src}
    raise TypeError(f"Unknown extractor {ex!r}")


def _encode_aggregator(agg: MonoidAggregator) -> Dict[str, Any]:
    if isinstance(agg, TimeBasedAggregator):
        return {"class": "TimeBasedAggregator", "last": agg.last}
    if isinstance(agg, ConcatText):
        return {"class": "ConcatText", "separator": agg.separator}
    if isinstance(agg, CustomMonoidAggregator):
        return {"class": "Custom"}
    return {"class": type(agg).__name__}


def _resolve_class(path: str) -> type:
    mod_name, qual = path.split(":")
    mod_name = port_module(mod_name)
    try:
        obj: Any = importlib.import_module(mod_name)
        for part in qual.split("."):
            obj = getattr(obj, part)
    except (ImportError, AttributeError) as e:
        raise NotImplementedError(
            f"{mod_name}:{qual} is not ported to {_PORT_PACKAGE} yet ({e})") from e
    return obj


def _decode(value: Any, arrays) -> Any:
    if isinstance(value, dict):
        if "__array__" in value:
            return arrays[value["__array__"]]
        if "__vector_metadata__" in value:
            return VectorMetadata.from_json(value["__vector_metadata__"])
        if "__stage__" in value:
            return _decode_stage(value["__stage__"], arrays)
        if "__ftype__" in value:
            return T.feature_type_by_name(value["__ftype__"])
        if "__class_ref__" in value:
            return _resolve_class(value["__class_ref__"])
        if "__dict__" in value:
            return {k: _decode(v, arrays) for k, v in value["__dict__"].items()}
        if "__tuple__" in value:
            return tuple(_decode(v, arrays) for v in value["__tuple__"])
        if "__set__" in value:
            return {_decode(v, arrays) for v in value["__set__"]}
        if "__jsonable__" in value:
            cls = _resolve_class(value["__jsonable__"]["class"])
            return cls.from_json(value["__jsonable__"]["data"])
        return {k: _decode(v, arrays) for k, v in value.items()}
    if isinstance(value, list):
        return [_decode(v, arrays) for v in value]
    return value


def _decode_stage(d: Dict[str, Any], arrays) -> PipelineStage:
    cls = _resolve_class(d["class"])
    stage: PipelineStage = cls.__new__(cls)
    stage.operation_name = d["operationName"]
    stage.output_type = T.feature_type_by_name(d["outputType"])
    stage.uid = d["uid"]
    stage._params = _decode(d["params"], arrays)
    stage.inputs = ()
    stage._outputs = None
    stage.metadata = d.get("metadata") or {}
    if d.get("parentUid") is not None:
        stage.parent_uid = d["parentUid"]
    for k, v in d["state"].items():
        if isinstance(v, dict) and "__extractor__" in v:
            setattr(stage, k, _decode_extractor(v["__extractor__"]))
        elif isinstance(v, dict) and "__aggregator__" in v:
            setattr(stage, k, _decode_aggregator(v["__aggregator__"]))
        else:
            setattr(stage, k, _decode(v, arrays))
    return stage


def _decode_extractor(spec: Dict[str, Any]) -> Extractor:
    if spec["kind"] == "field":
        return FieldExtractor(spec["field"], T.feature_type_by_name(spec["type"]))
    if spec["kind"] == "fn_source":
        ftype = T.feature_type_by_name(spec["type"])
        src = spec.get("source")
        if not src:
            raise ValueError(
                "This model was saved with a non-serializable extract function; "
                "re-create the feature with extract(field=...) for full save/load support")
        fn = _compile_extract_source(src)
        _LOADED_SOURCES[fn] = src
        return FnExtractor(fn, ftype)


def _compile_extract_source(src: str):
    """Recover a callable from captured source (lambda or def) — the analog of
    the reference's source-code-string stage reader."""
    if src.startswith("def "):
        ns: Dict[str, Any] = {}
        exec(src, {"T": T, "np": np}, ns)  # noqa: S102 — own-format model load
        return next(v for v in ns.values() if callable(v))
    # expression context: find the lambda inside an arbitrary enclosing line
    i = src.find("lambda")
    if i < 0:
        raise ValueError(f"Cannot recover extract function from source: {src!r}")
    expr = src[i:]
    for end in range(len(expr), 5, -1):
        try:
            fn = eval(compile(expr[:end], "<extract>", "eval"), {"T": T, "np": np})  # noqa: S307
            if callable(fn):
                return fn
        except Exception:  # truncated prefixes can fail in arbitrary ways
            continue
    raise ValueError(f"Cannot recover extract function from source: {src!r}")


_AGG_CLASSES = {c.__name__: c for c in
                (SumNumeric, MaxNumeric, MinNumeric, MeanNumeric, LogicalOr, ConcatText,
                 UnionCollection, UnionMap, TimeBasedAggregator)}


def _decode_aggregator(d: Dict[str, Any]) -> MonoidAggregator:
    name = d["class"]
    if name == "TimeBasedAggregator":
        return TimeBasedAggregator(last=d.get("last", True))
    if name == "ConcatText":
        return ConcatText(separator=d.get("separator", " "))
    if name == "Custom":
        raise ValueError("CustomMonoidAggregator cannot be restored from disk")
    return _AGG_CLASSES[name]()


def load_model(path: str, device=None):
    """Load a model the JAX package saved (``op_model.json`` +
    ``op_model_arrays.npz``) and place it on ``device`` (``None``: the CUDA
    card; raises when there is none)."""
    from .model import OpWorkflowModel

    dev = resolve_device(device)

    manifest_path = os.path.join(path, MODEL_MANIFEST)
    try:
        with open(manifest_path) as fh:
            manifest = json.load(fh)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"No model at {path!r}: missing {MODEL_MANIFEST} (an interrupted "
            f"save never produces a manifest — re-save the model)") from None
    except json.JSONDecodeError as e:
        raise ValueError(
            f"Corrupt model manifest at {manifest_path!r}: {e}. Saves are "
            f"atomic, so this file was damaged after the fact (bad disk or "
            f"manual edit) — re-save the model") from e
    arrays_path = os.path.join(path, MODEL_ARRAYS)
    try:
        arrays = dict(np.load(arrays_path, allow_pickle=False)) \
            if os.path.exists(arrays_path) else {}
    except Exception as e:
        raise ValueError(
            f"Corrupt model arrays at {arrays_path!r}: {e}. The manifest is "
            f"intact, so the arrays file was damaged after the save — "
            f"re-save the model") from e

    # 1. generator stages
    stages_by_uid: Dict[str, PipelineStage] = {}
    for g in manifest["generatorStages"]:
        st = FeatureGeneratorStage(
            extract_fn=_decode_extractor(g["extractor"]),
            output_type=T.feature_type_by_name(g["type"]),
            output_name=g["outputName"], is_response=g["isResponse"],
            aggregator=_decode_aggregator(g["aggregator"]),
            aggregate_window_ms=g["windowMs"], uid=g["uid"])
        stages_by_uid[st.uid] = st

    # 2. fitted stages
    for sd in manifest["stages"]:
        st = _decode_stage(sd, arrays)
        stages_by_uid[st.uid] = st

    # 3. features, resolved in dependency order
    feat_defs = {f["uid"]: f for f in manifest["features"]}
    features: Dict[str, Feature] = {}

    def build_feature(uid: str) -> Feature:
        if uid in features:
            return features[uid]
        d = feat_defs[uid]
        parents = tuple(build_feature(p) for p in d["parentUids"])
        f = Feature(name=d["name"], ftype=T.feature_type_by_name(d["type"]),
                    is_response=d["isResponse"],
                    origin_stage=stages_by_uid[d["originStageUid"]],
                    parents=parents, uid=uid)
        features[uid] = f
        return f

    for uid in feat_defs:
        build_feature(uid)

    # 4. rebind stage inputs/outputs
    for sd in manifest["stages"]:
        st = stages_by_uid[sd["uid"]]
        st.inputs = tuple(features[u] for u in sd["inputUids"])
        st._outputs = [features[u] for u in sd["outputUids"] if u in features] or None

    model = OpWorkflowModel()
    model.result_features = [features[u] for u in manifest["resultFeatureUids"]]
    model.raw_features = [features[u] for u in manifest["rawFeatureUids"]]
    model.blocklisted_features = [features[u] for u in manifest["blocklistedFeatureUids"]
                                  if u in features]
    model.blocklisted_map_keys = manifest.get("blocklistedMapKeys", {})
    model.stages = [stages_by_uid[sd["uid"]] for sd in manifest["stages"]]
    model.dag = [[stages_by_uid[u] for u in layer] for layer in manifest["dagLayers"]]
    from .params import OpParams

    model.parameters = OpParams.from_json(manifest.get("parameters", {}))
    return model.to(dev)


def save_model(model, path: str, overwrite: bool = True) -> None:
    """Save a fitted workflow model: arrays first, then the manifest, each
    through a temporary file and an atomic rename (a manifest implies a
    complete model)."""
    os.makedirs(path, exist_ok=True)
    manifest_path = os.path.join(path, MODEL_MANIFEST)
    if os.path.exists(manifest_path) and not overwrite:
        raise FileExistsError(f"Model already exists at {path}")
    arrays: Dict[str, np.ndarray] = {}
    all_features: Dict[str, Feature] = {}
    for rf in model.result_features:
        for f in rf.all_features():
            all_features[f.uid] = f
    for f in model.raw_features + model.blocklisted_features:
        all_features.setdefault(f.uid, f)
    gen_stages = {}
    for f in all_features.values():
        st = f.origin_stage
        if isinstance(st, FeatureGeneratorStage) and st.uid not in gen_stages:
            gen_stages[st.uid] = {
                "uid": st.uid, "outputName": st._output_name,
                "type": st.output_type.__name__, "isResponse": st.is_response,
                "extractor": _encode_extractor(st.extract_fn),
                "aggregator": _encode_aggregator(st.aggregator),
                "windowMs": st.aggregate_window_ms,
            }
    manifest = {
        "version": 1,
        "resultFeatureUids": [f.uid for f in model.result_features],
        "rawFeatureUids": [f.uid for f in model.raw_features],
        "blocklistedFeatureUids": [f.uid for f in model.blocklisted_features],
        "blocklistedMapKeys": model.blocklisted_map_keys,
        "features": [
            {"name": f.name, "uid": f.uid, "type": f.ftype.__name__,
             "isResponse": f.is_response, "originStageUid": f.origin_stage.uid,
             "parentUids": [p.uid for p in f.parents]}
            for f in all_features.values()
        ],
        "generatorStages": list(gen_stages.values()),
        "stages": [_encode_stage(s, arrays) for s in model.stages],
        "dagLayers": [[s.uid for s in layer] for layer in model.dag],
        "parameters": model.parameters.to_json(),
        "rffResults": None,
    }
    arrays_path = os.path.join(path, MODEL_ARRAYS)
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez_compressed(fh, **arrays)
        os.replace(tmp, arrays_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(manifest, fh, indent=1, default=str)
        os.replace(tmp, manifest_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
