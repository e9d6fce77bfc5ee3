"""Loading workflow models saved by the JAX package.

The port's counterpart of ``load_model`` in
``transmogrifai_tpu/workflow/serialization.py`` (reference:
OpWorkflowModelReader.scala): the JSON manifest names every stage by its
importable class path, and the fitted arrays come from the ``.npz``
bundle.  A class path of the JAX package (``transmogrifai_tpu.<module>``)
maps to the port's module of the same name
(``transmogrifai_tpu_torch.<module>``), so a model the JAX package saved
loads here and scores on the device.  Saving is not ported.
"""
from __future__ import annotations

import importlib
import json
import os
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


def port_module(mod_name: str) -> str:
    """The port's module for a saved module path: the JAX package's prefix
    maps to the port's; any other path (already the port's, or a user
    module) is kept."""
    if mod_name == _JAX_PACKAGE or mod_name.startswith(_JAX_PACKAGE + "."):
        return _PORT_PACKAGE + mod_name[len(_JAX_PACKAGE):]
    return mod_name


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
