"""Columnar data representation of the port.

The port's copy of ``transmogrifai_tpu/columns.py``, with one change of
substance: a ``VectorColumn`` holds its dense float32 matrix as a
``torch.Tensor`` on the model's device, so the assembled feature vectors
stay on the card from the vectorizer layer to the predictor.  The other
columns stay on the host as in the JAX package:

- numeric columns are ``(values: float64[n], mask: bool[n])`` numpy pairs,
- text/list/set/map columns are host-side object arrays,
- vector columns are ``float32[n, d]`` tensors with ``VectorMetadata``,
- prediction columns are numpy struct-of-arrays (prediction /
  rawPrediction / probability), computed in float64 on the host.

A ``Dataset`` is an ordered map of named columns plus a key column.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Type, Union

import numpy as np
import torch

from . import types as T
from .types import FeatureType

KEY_FIELD = "key"  # reference: DataFrameFieldNames.KeyFieldName


# ---------------------------------------------------------------------------
# Columns
# ---------------------------------------------------------------------------
class Column:
    """Base class: a typed column of n rows."""

    ftype: Type[FeatureType]

    def __len__(self) -> int:
        raise NotImplementedError

    def to_scalar(self, i: int) -> FeatureType:
        """Lift row i into the scalar FeatureType API (local scoring path)."""
        raise NotImplementedError

    def take(self, idx: np.ndarray) -> "Column":
        raise NotImplementedError

    def to_list(self) -> List[FeatureType]:
        return [self.to_scalar(i) for i in range(len(self))]


@dataclass
class NumericColumn(Column):
    """(values, mask) pair; mask True = present.

    Missing slots hold 0.0 in ``values`` so the array is always finite and
    device-safe; every consumer must honor ``mask``.
    """

    ftype: Type[FeatureType]
    values: np.ndarray  # float64[n] (f32 preserved for huge data)
    mask: np.ndarray    # bool[n]

    def __post_init__(self):
        # float32 sources keep their dtype (a 10M-row ingest must not 2x);
        # everything else normalizes to float64 as before
        v = np.asarray(self.values)
        self.values = v if v.dtype == np.float32 else np.asarray(v, np.float64)
        self.mask = np.asarray(self.mask, dtype=bool)
        assert self.values.shape == self.mask.shape

    def __len__(self) -> int:
        return int(self.values.shape[0])

    def to_scalar(self, i: int) -> FeatureType:
        if not self.mask[i]:
            return T.default_of(self.ftype)
        v = self.values[i]
        if issubclass(self.ftype, T.Binary):
            return self.ftype(bool(v))
        if issubclass(self.ftype, T.Integral):
            return self.ftype(int(v))
        return self.ftype(float(v))

    def take(self, idx: np.ndarray) -> "NumericColumn":
        return NumericColumn(self.ftype, self.values[idx], self.mask[idx])

    @staticmethod
    def from_scalars(ftype: Type[FeatureType], vals: Sequence[FeatureType]) -> "NumericColumn":
        n = len(vals)
        values = np.zeros(n, dtype=np.float64)
        mask = np.zeros(n, dtype=bool)
        for i, v in enumerate(vals):
            raw = v.value if isinstance(v, FeatureType) else v
            if raw is not None:
                values[i] = float(raw)
                mask[i] = True
        return NumericColumn(ftype, values, mask)


@dataclass
class ObjectColumn(Column):
    """Host-side object column for text / lists / sets / maps / geolocations.

    Missing is ``None`` for text, empty collection for collection types —
    matching the scalar types' empties.
    """

    ftype: Type[FeatureType]
    values: np.ndarray  # object[n]

    def __post_init__(self):
        v = self.values
        if not (isinstance(v, np.ndarray) and v.dtype == object and v.ndim == 1):
            v = np.empty(len(self.values), dtype=object)
            v[:] = list(self.values)
        self.values = v

    def __len__(self) -> int:
        return int(self.values.shape[0])

    def to_scalar(self, i: int) -> FeatureType:
        return self.ftype(self.values[i])

    def take(self, idx: np.ndarray) -> "ObjectColumn":
        return ObjectColumn(self.ftype, self.values[idx])

    @staticmethod
    def from_scalars(ftype: Type[FeatureType], vals: Sequence[FeatureType]) -> "ObjectColumn":
        out = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            out[i] = v.value if isinstance(v, FeatureType) else v
        return ObjectColumn(ftype, out)


@dataclass
class VectorColumn(Column):
    """Dense float32[n, d] feature matrix with per-column provenance.

    ``values`` is a float32 tensor; a numpy matrix handed in (the row path
    builds single-row columns from scalars) is wrapped on the host and moved
    to a stage's device by ``tensor(device)``.  The metadata sidecar is the
    OpVectorMetadata analog (OpVectorMetadata.scala:89).
    """

    ftype: Type[FeatureType]
    values: torch.Tensor  # float32[n, d]
    metadata: Optional["object"] = None  # VectorMetadata (vector.metadata)

    def __post_init__(self):
        v = self.values
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
        self.values = v if v.dtype == torch.float32 else v.to(torch.float32)
        if self.values.ndim != 2:
            raise ValueError(f"VectorColumn must be 2-D, got {tuple(self.values.shape)}")

    def __len__(self) -> int:
        return int(self.values.shape[0])

    @property
    def width(self) -> int:
        return int(self.values.shape[1])

    def tensor(self, device: torch.device) -> torch.Tensor:
        """The matrix as a contiguous float32 tensor on ``device``."""
        return self.values.to(device).contiguous()

    def numpy(self) -> np.ndarray:
        return self.values.detach().cpu().numpy()

    def to_scalar(self, i: int) -> FeatureType:
        return T.OPVector(self.values[i].detach().cpu().numpy())

    def take(self, idx: np.ndarray) -> "VectorColumn":
        idx_t = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=self.values.device)
        return VectorColumn(self.ftype, self.values.index_select(0, idx_t), self.metadata)

    @staticmethod
    def from_scalars(ftype: Type[FeatureType], vals: Sequence[FeatureType]) -> "VectorColumn":
        rows = [np.asarray(v.value if isinstance(v, FeatureType) else v, dtype=np.float32)
                for v in vals]
        width = max((r.shape[0] for r in rows), default=0)
        out = np.zeros((len(rows), width), dtype=np.float32)
        for i, r in enumerate(rows):
            out[i, :r.shape[0]] = r
        return VectorColumn(ftype, out)


@dataclass
class PredictionColumn(Column):
    """Struct-of-arrays model output (types.Prediction analog, Maps.scala:339)."""

    ftype: Type[FeatureType]
    prediction: np.ndarray                      # float64[n]
    raw_prediction: Optional[np.ndarray] = None  # float64[n, k]
    probability: Optional[np.ndarray] = None     # float64[n, k]
    #: producing stage's summary metadata (the reference stores model-selector
    #: summaries in the output column's schema metadata — SelectedModelCombiner
    #: reads them from its input columns, SelectedModelCombiner.scala:99)
    metadata: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        self.prediction = np.asarray(self.prediction, dtype=np.float64)
        if self.raw_prediction is not None:
            self.raw_prediction = np.atleast_2d(np.asarray(self.raw_prediction, dtype=np.float64))
        if self.probability is not None:
            self.probability = np.atleast_2d(np.asarray(self.probability, dtype=np.float64))

    def __len__(self) -> int:
        return int(self.prediction.shape[0])

    def to_scalar(self, i: int) -> FeatureType:
        return T.Prediction(
            prediction=float(self.prediction[i]),
            raw_prediction=None if self.raw_prediction is None else self.raw_prediction[i],
            probability=None if self.probability is None else self.probability[i],
        )

    def take(self, idx: np.ndarray) -> "PredictionColumn":
        return PredictionColumn(
            self.ftype,
            self.prediction[idx],
            None if self.raw_prediction is None else self.raw_prediction[idx],
            None if self.probability is None else self.probability[idx],
            metadata=self.metadata,
        )

    @staticmethod
    def from_scalars(ftype: Type[FeatureType], vals: Sequence[FeatureType]) -> "PredictionColumn":
        preds = np.array([v.prediction for v in vals], dtype=np.float64)
        raws = [v.raw_prediction for v in vals]
        probs = [v.probability for v in vals]
        raw = np.array(raws, dtype=np.float64) if raws and all(len(r) for r in raws) else None
        prob = np.array(probs, dtype=np.float64) if probs and all(len(p) for p in probs) else None
        return PredictionColumn(ftype, preds, raw, prob)


_NUMERIC_KINDS = ("numeric",)


def column_class_for(ftype: Type[FeatureType]) -> Type[Column]:
    if issubclass(ftype, T.Prediction):
        return PredictionColumn
    if issubclass(ftype, T.OPVector):
        return VectorColumn
    if issubclass(ftype, T.OPNumeric):
        return NumericColumn
    return ObjectColumn


def column_from_scalars(ftype: Type[FeatureType], vals: Sequence[Any]) -> Column:
    return column_class_for(ftype).from_scalars(ftype, vals)


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------
@dataclass
class Dataset:
    """Ordered named columns + key column; the DataFrame analog."""

    columns: Dict[str, Column] = field(default_factory=dict)
    key: Optional[np.ndarray] = None  # object[n] row keys

    def __post_init__(self):
        if self.key is not None:
            k = np.empty(len(self.key), dtype=object)
            k[:] = [str(x) for x in self.key]
            self.key = k

    def _derived(self, columns: Dict[str, Column], key: Optional[np.ndarray]) -> "Dataset":
        """A Dataset over keys that are already normalized (no re-conversion
        of every key per layer)."""
        out = Dataset(columns)
        out.key = key
        return out

    def __len__(self) -> int:
        if self.key is not None:
            return int(self.key.shape[0])
        for c in self.columns.values():
            return len(c)
        return 0

    @property
    def n_rows(self) -> int:
        return len(self)

    def column_names(self) -> List[str]:
        return list(self.columns)

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def with_column(self, name: str, col: Column) -> "Dataset":
        new = dict(self.columns)
        new[name] = col
        return self._derived(new, self.key)

    def with_columns(self, cols: Dict[str, Column]) -> "Dataset":
        new = dict(self.columns)
        new.update(cols)
        return self._derived(new, self.key)

    def select(self, names: Iterable[str]) -> "Dataset":
        return self._derived({n: self.columns[n] for n in names}, self.key)

    def drop(self, names: Iterable[str]) -> "Dataset":
        drop = set(names)
        return self._derived({n: c for n, c in self.columns.items() if n not in drop},
                             self.key)

    def take(self, idx: np.ndarray) -> "Dataset":
        idx = np.asarray(idx)
        return Dataset({n: c.take(idx) for n, c in self.columns.items()},
                       None if self.key is None else self.key[idx])

    def head(self, n: int) -> "Dataset":
        return self.take(np.arange(min(n, len(self))))

    def sample(self, fraction: float, seed: int = 42) -> "Dataset":
        rng = np.random.default_rng(seed)
        n = len(self)
        idx = np.where(rng.random(n) < fraction)[0]
        return self.take(idx)

    def row(self, i: int) -> Dict[str, FeatureType]:
        return {n: c.to_scalar(i) for n, c in self.columns.items()}

    def rows(self) -> Iterable[Dict[str, FeatureType]]:
        for i in range(len(self)):
            yield self.row(i)

    @staticmethod
    def concat(datasets: Sequence["Dataset"]) -> "Dataset":
        if not datasets:
            return Dataset()
        names = datasets[0].column_names()
        cols: Dict[str, Column] = {}
        for n in names:
            parts = [d[n] for d in datasets]
            c0 = parts[0]
            if isinstance(c0, NumericColumn):
                cols[n] = NumericColumn(c0.ftype,
                                        np.concatenate([p.values for p in parts]),
                                        np.concatenate([p.mask for p in parts]))
            elif isinstance(c0, VectorColumn):
                cols[n] = VectorColumn(c0.ftype,
                                       torch.cat([p.values for p in parts]), c0.metadata)
            elif isinstance(c0, PredictionColumn):
                cols[n] = PredictionColumn(
                    c0.ftype,
                    np.concatenate([p.prediction for p in parts]),
                    None if c0.raw_prediction is None else np.concatenate([p.raw_prediction for p in parts]),
                    None if c0.probability is None else np.concatenate([p.probability for p in parts]),
                )
            else:
                cols[n] = ObjectColumn(c0.ftype, np.concatenate([p.values for p in parts]))
        key = None
        if datasets[0].key is not None:
            key = np.concatenate([d.key for d in datasets])
        return Dataset(cols, key)
