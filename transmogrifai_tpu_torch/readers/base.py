"""Data readers — typed records to columnar Datasets.

The port's copy of the scoring half of ``transmogrifai_tpu/readers/base.py``
(reference: readers/.../DataReader.scala:174 ``generateDataFrame``).  The
columnar path takes a ``dict[str, np.ndarray]``; a pandas DataFrame is
turned into one inside its own branch, the only place pandas is imported.
Numeric fields are coerced with ``to_numeric``, a numpy replacement for
``pd.to_numeric(errors="coerce")`` that gives the same values and masks.

Not ported: the quarantine row policy, host sharding, the aggregate and
conditional readers and the join combinators.
"""
from __future__ import annotations

import decimal
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from .. import types as T
from ..columns import (Dataset, KEY_FIELD, NumericColumn, ObjectColumn,
                       column_from_scalars)
from ..features.feature import Feature
from ..features.generator import FeatureGeneratorStage, FieldExtractor

#: the literal forms ``pd.to_numeric`` parses: decimal and exponent notation
#: with optional sign and surrounding whitespace, inf/infinity and nan
#: (no digit separators, hex or non-ASCII digits, which Python's float takes)
_NUMBER_RE = re.compile(
    r"\s*[+-]?((\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?|inf|infinity|nan)\s*",
    re.IGNORECASE | re.ASCII)


def _to_float(v: Any) -> float:
    if v is None:
        return np.nan
    if isinstance(v, (bool, np.bool_, int, np.integer, float, np.floating,
                      decimal.Decimal)):
        return float(v)
    if isinstance(v, str) and _NUMBER_RE.fullmatch(v):
        return float(v)
    return np.nan


def to_numeric(values: np.ndarray) -> np.ndarray:
    """``pd.to_numeric(values, errors="coerce")`` as float (NaN = missing).

    float32 input stays float32 (no 2x copy of a large ingest); everything
    else becomes float64."""
    arr = np.asarray(values)
    if arr.dtype.kind in "biuf":
        return arr if arr.dtype == np.float32 else arr.astype(np.float64)
    return np.fromiter((_to_float(v) for v in arr.ravel()), np.float64,
                       count=arr.size).reshape(arr.shape)


def _is_null(v: Any) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and v != v)


def null_mask(values: np.ndarray) -> np.ndarray:
    """``pd.isnull`` of an object array: None, float NaN and NaT."""
    try:
        # elementwise in C: ``v != v`` holds for NaN and NaT only
        with np.errstate(invalid="ignore"):
            out = np.equal(values, None) | np.not_equal(values, values)
        if out.dtype == bool and out.shape == values.shape:
            return out
    except (TypeError, ValueError):
        pass  # cells whose comparison is not one bool (e.g. arrays)
    return np.array([_is_null(v) or (isinstance(v, (np.datetime64, np.timedelta64))
                                     and np.isnat(v)) for v in values], dtype=bool)


def _frame_columns(df) -> Dict[str, np.ndarray]:
    """A pandas DataFrame as numpy columns, nulls (NaN, None, NA, NaT) of
    object columns as ``None``."""
    import pandas as pd

    out = {}
    for name in df.columns:
        arr = df[name].to_numpy()
        if arr.dtype == object:
            arr = np.where(pd.isna(arr), None, arr)
        out[str(name)] = arr
    return out


def _columnar(data: Any) -> Optional[Dict[str, np.ndarray]]:
    """The input as numpy columns, or None for a list of records."""
    if isinstance(data, dict):
        return {str(k): np.asarray(v) for k, v in data.items()}
    if isinstance(data, Dataset):
        cols: Dict[str, np.ndarray] = {}
        for name, col in data.columns.items():
            if isinstance(col, NumericColumn):
                v = col.values.astype(object)
                v[~col.mask] = None
                cols[name] = v
            elif isinstance(col, ObjectColumn):
                cols[name] = col.values
        if data.key is not None:
            cols.setdefault(KEY_FIELD, data.key)
        return cols
    if type(data).__module__.split(".")[0] == "pandas":
        return _frame_columns(data)
    return None


def _extract_column(f: Feature, arr: np.ndarray):
    """One raw feature from its field's column (vectorized for numeric and
    text types, per value otherwise)."""
    stage = f.origin_stage
    if issubclass(f.ftype, T.OPNumeric):
        vals = to_numeric(arr)
        mask = ~np.isnan(vals)
        return NumericColumn(f.ftype, np.where(mask, vals, vals.dtype.type(0.0)), mask)
    if issubclass(f.ftype, T.Text):
        if arr.dtype.kind in "iuU":  # no nulls; str() of each value
            return ObjectColumn(f.ftype, arr.astype(str).astype(object))
        obj = arr.astype(object)
        null = null_mask(obj)
        if set(map(type, obj[~null])) <= {str}:
            return ObjectColumn(f.ftype, np.where(null, None, obj))
        out = np.empty(len(obj), dtype=object)
        for i, v in enumerate(obj):
            out[i] = None if null[i] else str(v)
        return ObjectColumn(f.ftype, out)
    name = stage.extract_fn.field_name
    return column_from_scalars(f.ftype, [stage.extract({name: v}) for v in arr])


class Reader:
    """Base reader (Reader.scala:96)."""

    def read(self, params: Optional[Dict[str, Any]] = None):
        """Return the raw data: numpy columns, a DataFrame or records."""
        raise NotImplementedError

    def generate_dataset(self, raw_features: Sequence[Feature],
                         params: Optional[Dict[str, Any]] = None) -> Dataset:
        raise NotImplementedError


class DataReader(Reader):
    """Simple (non-aggregating) reader (DataReader.scala:58): one record = one
    row; key from ``key_fn`` or a record field."""

    def __init__(self, key: Union[str, Callable[[Dict[str, Any]], str], None] = None):
        self.key = key

    def _key_of(self, record: Dict[str, Any], i: int) -> str:
        if self.key is None:
            return str(record.get(KEY_FIELD, i)) if isinstance(record, dict) else str(i)
        if callable(self.key):
            return str(self.key(record))
        return str(record.get(self.key, i))

    def generate_dataset(self, raw_features: Sequence[Feature],
                         params: Optional[Dict[str, Any]] = None) -> Dataset:
        data = self.read(params)
        limit = (params or {}).get("maybeReaderParams", {}).get("limit") \
            or (params or {}).get("limit")
        cols = _columnar(data)
        if cols is None or callable(self.key):
            records = list(data) if cols is None else _records(cols)
            if limit:
                records = records[: int(limit)]
            out = {f.name: column_from_scalars(
                       f.ftype, [f.origin_stage.extract(r) for r in records])
                   for f in raw_features}
            keys = np.array([self._key_of(r, i) for i, r in enumerate(records)],
                            dtype=object)
            return Dataset(out, keys)
        n = len(next(iter(cols.values()))) if cols else 0
        if limit:
            n = min(n, int(limit))
            cols = {k: v[:n] for k, v in cols.items()}
        out = {}
        for f in raw_features:
            stage = f.origin_stage
            if not isinstance(stage, FeatureGeneratorStage):
                raise TypeError(f"Raw feature {f.name} has non-generator origin {stage}")
            ex = stage.extract_fn
            if isinstance(ex, FieldExtractor) and ex.field_name in cols:
                out[f.name] = _extract_column(f, cols[ex.field_name])
            elif isinstance(ex, FieldExtractor):
                # a missing field is the type's default in every row
                # (nullable-everywhere semantics; RealNN defaults to 0.0)
                out[f.name] = column_from_scalars(f.ftype, [T.default_of(f.ftype)] * n)
            else:
                out[f.name] = column_from_scalars(
                    f.ftype, [stage.extract(r) for r in _records(cols)])
        return Dataset(out, self._column_keys(cols, n))

    def _column_keys(self, cols: Dict[str, np.ndarray], n: int) -> np.ndarray:
        if isinstance(self.key, str) and self.key in cols:
            return np.asarray(cols[self.key]).astype(str).astype(object)
        if self.key is None and KEY_FIELD in cols:
            return np.asarray(cols[KEY_FIELD]).astype(str).astype(object)
        return np.arange(n).astype(str).astype(object)


def _records(cols: Dict[str, np.ndarray]) -> List[Dict[str, Any]]:
    names = list(cols)
    n = len(cols[names[0]]) if names else 0
    return [{k: cols[k][i] for k in names} for i in range(n)]


class CustomReader(DataReader):
    """Wraps in-memory data (reference CustomReaders.scala)."""

    def __init__(self, data: Any, key: Union[str, Callable, None] = None):
        super().__init__(key=key)
        self._data = data

    def read(self, params: Optional[Dict[str, Any]] = None):
        return self._data
