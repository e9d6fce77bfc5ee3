"""Stage contracts — the estimator/transformer abstractions.

Reference parity: features/src/main/scala/com/salesforce/op/stages/OpPipelineStages.scala:55
(``OpPipelineStageBase``: operationName, setInput/getOutput, transformSchema)
and the arity traits (``OpPipelineStage1..4``, ``N``, ``2N`` — :218-523), plus
``OpTransformer`` (:526) — the row-function scoring interface.

The port's copy of ``transmogrifai_tpu.stages.base``: a stage is a pure
function pair —

- ``fit(dataset) -> Model``: the estimator's fit on a columnar dataset;
  the model is placed on the estimator's device,
- ``Model.transform_columns(columns) -> Column`` is a pure per-batch function;
  a DAG layer's stages run back to back on the device (the analog of
  FitStagesUtil.applyOpTransformations's fused rdd.map, FitStagesUtil.scala:96).

The uid counters stay deterministic so that uids read from a saved manifest
are kept exactly as they were written.

Row-wise scoring (``transform_row``) is derived from the batch path over
single-row columns — guaranteeing batch ≡ row parity by construction (the
property the reference asserts in every OpTransformerSpec).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type, TYPE_CHECKING

import numpy as np
import torch

from .. import types as T
from ..columns import Column, Dataset, column_from_scalars

if TYPE_CHECKING:
    from ..features.feature import Feature


_UID_LOCK = threading.Lock()
_UID_COUNTS: Dict[str, int] = {}


def make_uid(cls_name: str) -> str:
    """Reference-style stage uid: ``ClassName_<12 hex>`` (UID.scala analog).

    Deterministic — a per-class construction counter, not random hex: a
    restarted process that rebuilds the same pipeline reconstructs the SAME
    uids, so content-keyed checkpoint keys (stream chunk resume, sweep shard
    resume) survive preemption — a SIGKILLed host re-running its script
    finds its own completed work.  In-process uniqueness is unchanged (the
    counter never repeats a value for a class)."""
    with _UID_LOCK:
        n = _UID_COUNTS.get(cls_name, 0)
        _UID_COUNTS[cls_name] = n + 1
    return f"{cls_name}_{n:012x}"


class PipelineStage:
    """Base for all stages.

    A stage declares typed inputs (Features), produces one or more output
    Features, and carries serializable params.
    """

    #: number of output features this stage produces
    n_outputs: int = 1
    #: device the stage computes on; set by ``to`` (``load_model`` places
    #: every stage), ``None`` resolves to the CUDA card
    device: Optional[torch.device] = None

    def __init__(self, operation_name: str, output_type: Type[T.FeatureType],
                 uid: Optional[str] = None, **params: Any):
        self.operation_name = operation_name
        self.output_type = output_type
        self.uid = uid or make_uid(type(self).__name__)
        self._params: Dict[str, Any] = dict(params)
        self.inputs: Tuple["Feature", ...] = ()
        self._outputs: Optional[List["Feature"]] = None
        #: metadata attached to output columns (summaries, vector provenance)
        self.metadata: Dict[str, Any] = {}

    # ---- params ------------------------------------------------------------
    def get_param(self, name: str, default: Any = None) -> Any:
        return self._params.get(name, default)

    def set_param(self, name: str, value: Any) -> "PipelineStage":
        self._params[name] = value
        return self

    @property
    def params(self) -> Dict[str, Any]:
        return dict(self._params)

    # ---- placement ---------------------------------------------------------
    def to(self, device) -> "PipelineStage":
        """Place the stage (and any fitted tensors it holds) on ``device``."""
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        return self

    # ---- wiring ------------------------------------------------------------
    def set_input(self, *features: "Feature") -> "PipelineStage":
        self.check_input_types(features)
        self.inputs = tuple(features)
        self._outputs = None
        return self

    def check_input_types(self, features: Sequence["Feature"]) -> None:
        """Schema validation hook (transformSchema analog,
        OpPipelineStages.scala:112)."""

    @property
    def input_features(self) -> Tuple["Feature", ...]:
        return self.inputs

    def output_name(self, index: int = 0) -> str:
        base = "-".join(f.name for f in self.inputs) or self.operation_name
        suffix = f"_{index}" if self.n_outputs > 1 else ""
        return f"{base}_{self.operation_name}{suffix}_{self.uid.split('_')[-1]}"

    def output_is_response(self) -> bool:
        """Output is a response iff any input is (reference: OpPipelineStage
        outputIsResponse); stages with AllowLabelAsInput still produce
        predictors (OpPipelineStages.scala:203)."""
        if getattr(self, "allow_label_as_input", False):
            return False
        return any(f.is_response for f in self.inputs)

    def get_output(self) -> "Feature":
        assert self.n_outputs == 1, f"{self} has {self.n_outputs} outputs; use get_outputs()"
        return self.get_outputs()[0]

    def get_outputs(self) -> List["Feature"]:
        from ..features.feature import Feature

        if self._outputs is None:
            out_types = self.output_types()
            self._outputs = [
                Feature(
                    name=self.output_name(i),
                    ftype=out_types[i],
                    is_response=self.output_is_response(),
                    origin_stage=self,
                    parents=tuple(self.inputs),
                )
                for i in range(self.n_outputs)
            ]
        return self._outputs

    def output_types(self) -> List[Type[T.FeatureType]]:
        return [self.output_type] * self.n_outputs

    def __repr__(self) -> str:
        return f"{type(self).__name__}(uid={self.uid!r})"


class Transformer(PipelineStage):
    """A stage that needs no fitting — pure batch function.

    The batch function is the OpTransformer analog; ``transform_row`` derives
    the row function (transformKeyValue, OpPipelineStages.scala:550) from it.
    """

    def transform_columns(self, cols: Sequence[Column]) -> Column:
        raise NotImplementedError

    def transform_dataset(self, ds: Dataset) -> Column:
        return self.transform_columns([ds[f.name] for f in self.inputs])

    def transform_row(self, row: Dict[str, T.FeatureType]) -> T.FeatureType:
        cols = [column_from_scalars(f.ftype, [row[f.name]]) for f in self.inputs]
        return self.transform_columns(cols).to_scalar(0)


class Model(Transformer):
    """A fitted transformer produced by an Estimator."""

    def __init__(self, operation_name: str, output_type: Type[T.FeatureType],
                 uid: Optional[str] = None, parent_uid: Optional[str] = None, **params: Any):
        super().__init__(operation_name, output_type, uid=uid, **params)
        self.parent_uid = parent_uid


class Estimator(PipelineStage):
    """A stage that must be fitted; ``fit`` returns a Model.

    The returned model inherits the estimator's uid/inputs/outputs so the DAG
    node identity is stable across fitting (the reference swaps estimators for
    their fitted models in-place, FitStagesUtil.scala:251).
    """

    def fit_columns(self, cols: Sequence[Column], dataset: Dataset) -> Model:
        raise NotImplementedError

    def fit(self, ds: Dataset) -> Model:
        model = self.fit_columns([ds[f.name] for f in self.inputs], ds)
        model.uid = self.uid
        model.parent_uid = self.uid
        model.inputs = self.inputs
        model.operation_name = self.operation_name
        model._outputs = self._outputs
        if not model.metadata:
            model.metadata = self.metadata
        if self.device is not None:
            model.to(self.device)
        return model


class AllowLabelAsInput:
    """Marker mixin: stage may consume the label yet outputs a predictor
    (OpPipelineStages.scala:203 — used by SanityChecker, ModelSelector etc.)."""

    allow_label_as_input = True


# ---------------------------------------------------------------------------
# Arity bases (reference: stages/base/unary..quaternary, sequence)
# ---------------------------------------------------------------------------
class UnaryTransformer(Transformer):
    """1 -> 1 transformer defined by a scalar fn, vectorized over the column.

    Reference parity: base/unary/UnaryTransformer.scala:104.  Subclasses
    override either ``transform_fn`` (scalar) or ``transform_columns`` (batch,
    preferred for device execution).
    """

    def __init__(self, operation_name: str, input_type: Type[T.FeatureType],
                 output_type: Type[T.FeatureType], uid: Optional[str] = None, **params):
        super().__init__(operation_name, output_type, uid=uid, **params)
        self.input_type = input_type

    def check_input_types(self, features) -> None:
        if len(features) != 1:
            raise ValueError(f"{type(self).__name__} takes exactly 1 input")

    def transform_fn(self, value: T.FeatureType) -> T.FeatureType:
        raise NotImplementedError

    def transform_columns(self, cols: Sequence[Column]) -> Column:
        col = cols[0]
        out = [self.transform_fn(col.to_scalar(i)) for i in range(len(col))]
        return column_from_scalars(self.output_type, out)


class BinaryTransformer(Transformer):
    """(I1, I2) -> O (base/binary/BinaryTransformer.scala)."""

    def check_input_types(self, features) -> None:
        if len(features) != 2:
            raise ValueError(f"{type(self).__name__} takes exactly 2 inputs")

    def transform_fn(self, a: T.FeatureType, b: T.FeatureType) -> T.FeatureType:
        raise NotImplementedError

    def transform_columns(self, cols: Sequence[Column]) -> Column:
        a, b = cols
        out = [self.transform_fn(a.to_scalar(i), b.to_scalar(i)) for i in range(len(a))]
        return column_from_scalars(self.output_type, out)


class TernaryTransformer(Transformer):
    def check_input_types(self, features) -> None:
        if len(features) != 3:
            raise ValueError(f"{type(self).__name__} takes exactly 3 inputs")

    def transform_fn(self, a, b, c) -> T.FeatureType:
        raise NotImplementedError

    def transform_columns(self, cols: Sequence[Column]) -> Column:
        a, b, c = cols
        out = [self.transform_fn(a.to_scalar(i), b.to_scalar(i), c.to_scalar(i))
               for i in range(len(a))]
        return column_from_scalars(self.output_type, out)


class QuaternaryTransformer(Transformer):
    def check_input_types(self, features) -> None:
        if len(features) != 4:
            raise ValueError(f"{type(self).__name__} takes exactly 4 inputs")

    def transform_fn(self, a, b, c, d) -> T.FeatureType:
        raise NotImplementedError

    def transform_columns(self, cols: Sequence[Column]) -> Column:
        a, b, c, d = cols
        out = [self.transform_fn(a.to_scalar(i), b.to_scalar(i), c.to_scalar(i), d.to_scalar(i))
               for i in range(len(a))]
        return column_from_scalars(self.output_type, out)


class SequenceTransformer(Transformer):
    """N homogeneous inputs -> 1 output (base/sequence/)."""

    def check_input_types(self, features) -> None:
        if len(features) < 1:
            raise ValueError(f"{type(self).__name__} takes at least 1 input")


class UnaryEstimator(Estimator):
    """1 -> 1 estimator (base/unary/UnaryEstimator.scala:56)."""

    def __init__(self, operation_name: str, input_type: Type[T.FeatureType],
                 output_type: Type[T.FeatureType], uid: Optional[str] = None, **params):
        super().__init__(operation_name, output_type, uid=uid, **params)
        self.input_type = input_type

    def check_input_types(self, features) -> None:
        if len(features) != 1:
            raise ValueError(f"{type(self).__name__} takes exactly 1 input")


class BinaryEstimator(Estimator):
    def check_input_types(self, features) -> None:
        if len(features) != 2:
            raise ValueError(f"{type(self).__name__} takes exactly 2 inputs")


class SequenceEstimator(Estimator):
    """N homogeneous inputs -> 1 output (base/sequence/SequenceEstimator.scala:57)."""

    def check_input_types(self, features) -> None:
        if len(features) < 1:
            raise ValueError(f"{type(self).__name__} takes at least 1 input")


class BinarySequenceEstimator(Estimator):
    """1 fixed input + N homogeneous inputs (base/sequence/BinarySequenceEstimator)."""

    def check_input_types(self, features) -> None:
        if len(features) < 2:
            raise ValueError(f"{type(self).__name__} takes at least 2 inputs")
