"""Per-model input contracts: the serving plane's admission filter.

The port's copy of ``transmogrifai_tpu/serve/contract.py``.
``InputContract.from_model`` derives the validation surface from the fitted
model's raw features (``features/generator.py``'s extractors):

- **dtypes**: each non-response raw feature's ``FeatureType`` classes its
  record field as numeric scalar, text scalar or other (maps, lists and
  vectors pass through);
- **required columns**: the field names the extractors read.  Absence is
  counted (``contract_missing_required``), never rejected: sparse records
  and ``{}`` health probes are part of the contract;
- **finiteness**: NaN or Inf in a numeric field is a hard
  :class:`DataFault` (``non_finite``), as is type garbage
  (``type_mismatch``, ``non_scalar``);
- **value-range envelope**: the RawFeatureFilter's recorded training
  distributions bound each numeric field; out-of-envelope values are
  counted (``range_violations``), never rejected.  The port's models carry
  no such record (the filter and the drift baselines of ``continual/`` are
  not ported, ROADMAP Queue 1 items 5 and 8), so no envelope is derived.

Validation runs twice: a per-record check at admission (``check_record`` in
``MicroBatcher.submit``) and one sweep over the assembled batch before
dispatch (``check_batch``).  ``TMOG_VALIDATE=0`` turns both off.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import types as T
from ..features.generator import FeatureGeneratorStage, FieldExtractor
from ..obs import registry as obs_registry
from ..resilience.quarantine import DataFault
from ..utils import env as _env

__all__ = ["FieldSpec", "InputContract", "validation_enabled"]

_scope = obs_registry.scope("resilience")

_NON_SCALAR = (list, tuple, dict, set, frozenset)


def validation_enabled() -> bool:
    """``TMOG_VALIDATE`` toggle, default on.  ``0`` restores the legacy
    trust-everything path bit-identically (documented opt-out)."""
    return _env.env_flag("TMOG_VALIDATE", True)


class FieldSpec:
    """One record field's contract entry."""

    __slots__ = ("name", "numeric", "scalar", "required", "lo", "hi")

    def __init__(self, name: str, numeric: bool, scalar: bool,
                 required: bool = True, lo: Optional[float] = None,
                 hi: Optional[float] = None):
        self.name = name
        self.numeric = numeric
        self.scalar = scalar
        self.required = required
        self.lo = lo
        self.hi = hi

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "numeric": self.numeric,
                               "scalar": self.scalar,
                               "required": self.required}
        if self.lo is not None:
            out["envelope"] = [self.lo, self.hi]
        return out


def _numeric_fault(name: str, value: Any, index: Optional[int]
                   ) -> Optional[DataFault]:
    """Classify one numeric-field scalar; None when it conforms."""
    if value is None or isinstance(value, bool) or isinstance(value, int):
        return None
    if isinstance(value, float):
        if value != value or value in (float("inf"), float("-inf")):
            return DataFault("non_finite", index=index, field=name,
                             detail=repr(value))
        return None
    if isinstance(value, _NON_SCALAR):
        return DataFault("non_scalar", index=index, field=name,
                         detail=type(value).__name__)
    try:
        f = float(value)
    except (TypeError, ValueError):
        return DataFault("type_mismatch", index=index, field=name,
                         detail=f"{type(value).__name__}: {str(value)[:48]}")
    if f != f or abs(f) == float("inf"):
        return DataFault("non_finite", index=index, field=name,
                         detail=repr(value))
    return None


class InputContract:
    """Validation surface for one deployed model version."""

    def __init__(self, fields: Sequence[FieldSpec]):
        self.fields: Dict[str, FieldSpec] = {s.name: s for s in fields}
        self._numeric = [s for s in self.fields.values() if s.numeric]
        self._required = [s.name for s in self.fields.values() if s.required]

    @property
    def numeric_field_names(self) -> List[str]:
        return [s.name for s in self._numeric]

    # ---- derivation --------------------------------------------------------
    @classmethod
    def from_model(cls, model) -> "InputContract":
        """Derive the contract from a fitted ``OpWorkflowModel``."""
        envelopes: Dict[str, tuple] = {}
        rff = getattr(model, "rff_results", None)
        for dist in getattr(rff, "training_distributions", None) or []:
            info = np.asarray(getattr(dist, "summary_info", ()), float)
            if getattr(dist, "key", None) is None and getattr(dist, "is_numeric", False) \
                    and info.size >= 2 and np.isfinite(info[[0, -1]]).all():
                envelopes[dist.name] = (float(info[0]), float(info[-1]))
        specs: List[FieldSpec] = []
        for f in model.raw_features:
            if f.is_response:
                continue
            stage = f.origin_stage
            field = f.name
            if isinstance(stage, FeatureGeneratorStage) and \
                    isinstance(stage.extract_fn, FieldExtractor):
                field = stage.extract_fn.field_name
            numeric = issubclass(f.ftype, T.OPNumeric)
            scalar = numeric or issubclass(f.ftype, T.Text)
            lo, hi = envelopes.get(f.name, (None, None))
            specs.append(FieldSpec(field, numeric, scalar,
                                   required=True, lo=lo, hi=hi))
        return cls(specs)

    # ---- admission check (per record, O(record)) ---------------------------
    def check_record(self, record: Any, index: Optional[int] = None) -> None:
        """Cheap shape check at admission; raises :class:`DataFault`."""
        if not isinstance(record, dict):
            raise DataFault("not_an_object", index=index,
                            detail=type(record).__name__)
        missing = 0
        for name in self._required:
            if name not in record:
                missing += 1
        if missing:
            _scope.inc("contract_missing_required", missing)
        for name, value in record.items():
            spec = self.fields.get(name)
            if spec is None or not spec.scalar:
                continue
            if spec.numeric:
                fault = _numeric_fault(name, value, index)
                if fault is not None:
                    raise fault
            elif isinstance(value, _NON_SCALAR):
                raise DataFault("non_scalar", index=index, field=name,
                                detail=type(value).__name__)

    # ---- pre-dispatch check (vectorized over the batch) --------------------
    def check_batch(self, records: Sequence[Dict[str, Any]], n: int
                    ) -> List[Optional[DataFault]]:
        """One finiteness/range sweep over the assembled batch (first ``n``
        records are real; padding is ignored).  Returns per-row faults
        (None == clean); range violations only count, never fault."""
        faults: List[Optional[DataFault]] = [None] * n
        range_hits = 0
        for spec in self._numeric:
            col = np.full(n, np.nan)
            for i in range(n):
                rec = records[i]
                if not isinstance(rec, dict):
                    if faults[i] is None:
                        faults[i] = DataFault("not_an_object", index=i,
                                              detail=type(rec).__name__)
                    continue
                v = rec.get(spec.name)
                if v is None:
                    continue
                if isinstance(v, bool):
                    col[i] = float(v)
                    continue
                if isinstance(v, (int, float)):
                    col[i] = v
                    continue
                fault = _numeric_fault(spec.name, v, i)
                if fault is not None:
                    if faults[i] is None:
                        faults[i] = fault
                else:
                    col[i] = float(v)
            finite = np.isfinite(col)
            # non-finite slots are absent fields OR true NaN/Inf values;
            # only the latter fault, so re-check the raw value
            for i in range(n):
                if faults[i] is not None or finite[i]:
                    continue
                rec = records[i]
                v = rec.get(spec.name) if isinstance(rec, dict) else None
                if isinstance(v, float) and (v != v or abs(v) == float("inf")):
                    faults[i] = DataFault("non_finite", index=i,
                                          field=spec.name, detail=repr(v))
            if spec.lo is not None and spec.hi is not None:
                oor = finite & ((col < spec.lo) | (col > spec.hi))
                range_hits += int(oor.sum())
        if range_hits:
            _scope.inc("range_violations", range_hits)
        return faults

    def to_json(self) -> Dict[str, Any]:
        return {"fields": [s.to_json() for s in self.fields.values()]}
