"""Poison-row quarantine: the data-fault half of the resilience layer.

The port's copy of ``transmogrifai_tpu/resilience/quarantine.py``.  A data
fault (a malformed, non-finite or type-garbage record) is deterministic and
machine-independent, so unlike a system fault it is never retried and never
counted against a replica's circuit breaker or the SLO's error budget: it
is rejected per row (HTTP 422 with the row index) and audited.

- :class:`DataFault`: the exception (``transient = False``, ``status = 422``);
- :class:`QuarantineStore`: a bounded in-memory dead-letter ring with an
  optional JSONL audit file (``TMOG_QUARANTINE_PATH``).

The JAX package's ``policy()`` (the ``TMOG_QUARANTINE`` row policy of its
reader and streaming executor) is not ported: no training path of the port
scans rows yet (ROADMAP Queue 1 item 8).

Audit rows also land in the ``resilience`` obs scope (counter
``quarantined``, event list ``quarantine``).
"""
from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from ..obs import registry as obs_registry
from ..utils import env as _env

__all__ = ["DataFault", "QuarantineStore", "store", "reset_store", "REASONS"]

_scope = obs_registry.scope("resilience")

# Reason codes stamped on every audit row (stable strings: they end up in
# telemetry records and HTTP error payloads).
REASONS = (
    "not_an_object",    # list-of-records item is not a dict
    "non_scalar",       # field value is a list/dict/other non-scalar
    "type_mismatch",    # wrong dtype (text in a numeric column, ...)
    "non_finite",       # NaN/Inf in a numeric field
    "out_of_range",     # outside the training envelope
    "coerce_failure",   # reader-side to_numeric coercion produced NaN
    "score_failure",    # row isolated by batch bisection
    "injected_poison",  # planted by the chaos layer (resilience.inject)
)

class DataFault(ValueError):
    """A non-transient, machine-independent data fault.

    Never retried (``transient = False`` — :func:`retry.is_transient`
    checks the attribute first), never counted against the breaker, the
    supervisor or the SLO.
    """

    transient = False
    status = 422

    def __init__(self, reason: str, *, index: Optional[int] = None,
                 field: Optional[str] = None,
                 detail: Optional[str] = None):
        self.reason = reason
        self.index = index
        self.field = field
        self.detail = detail
        bits = [reason]
        if index is not None:
            bits.append(f"row {index}")
        if field is not None:
            bits.append(f"field {field!r}")
        if detail:
            bits.append(detail)
        super().__init__("data fault: " + ", ".join(bits))

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"reason": self.reason}
        if self.index is not None:
            out["index"] = self.index
        if self.field is not None:
            out["field"] = self.field
        if self.detail:
            out["detail"] = self.detail
        return out


def _json_safe(value: Any, depth: int = 0) -> Any:
    """Best-effort JSON projection of a quarantined record: audit rows must
    never crash on the very garbage they are recording."""
    if depth > 3:
        return repr(value)[:128]
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        # json.dump(allow_nan=False) would choke on the poison itself.
        return value if value == value and abs(value) != float("inf") \
            else repr(value)
    if isinstance(value, dict):
        return {str(k)[:64]: _json_safe(v, depth + 1)
                for k, v in list(value.items())[:32]}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v, depth + 1) for v in list(value)[:32]]
    try:
        return _json_safe(float(value), depth + 1)   # numpy scalars
    except Exception:
        return repr(value)[:128]


class QuarantineStore:
    """Bounded dead-letter store with an optional JSONL audit file.

    The in-memory ring holds the most recent ``cap`` audit rows (oldest
    evicted first); when ``TMOG_QUARANTINE_PATH`` is set every row is also
    appended to that JSONL file so a long fit leaves a complete audit
    trail even after the ring wraps.
    """

    def __init__(self, cap: Optional[int] = None,
                 path: Optional[str] = None):
        self.cap = cap if cap is not None else max(
            1, _env.env_int("TMOG_QUARANTINE_CAP", 1000))
        self.path = path if path is not None else _env.env_str(
            "TMOG_QUARANTINE_PATH", "")
        self._rows: Deque[Dict[str, Any]] = deque(maxlen=self.cap)
        self._lock = threading.Lock()
        self.total = 0   # lifetime count, survives ring eviction

    def put(self, source: str, reason: str, *,
            index: Optional[int] = None, field: Optional[str] = None,
            record: Any = None, detail: Optional[str] = None
            ) -> Dict[str, Any]:
        """Quarantine one row; returns the audit record."""
        row: Dict[str, Any] = {"source": source, "reason": reason}
        if index is not None:
            row["index"] = index
        if field is not None:
            row["field"] = field
        if detail:
            row["detail"] = detail
        if record is not None:
            row["record"] = _json_safe(record)
        with self._lock:
            self.total += 1
            row["seq"] = self.total
            self._rows.append(row)
        _scope.inc("quarantined")
        _scope.append("quarantine", row)
        if self.path:
            try:
                line = json.dumps(row, sort_keys=True, default=repr)
                with self._lock:
                    with open(self.path, "a", encoding="utf-8") as fh:
                        fh.write(line + "\n")
            except OSError:
                pass   # a full disk must not take down scoring
        return row

    def rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._rows)

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"total": self.total, "held": len(self._rows),
                    "cap": self.cap, "path": self.path or None}


_store: Optional[QuarantineStore] = None
_store_lock = threading.Lock()


def store() -> QuarantineStore:
    """The process-global dead-letter store (lazily built so env knobs set
    by tests are honored)."""
    global _store
    with _store_lock:
        if _store is None:
            _store = QuarantineStore()
        return _store


def reset_store() -> None:
    """Drop the global store (tests re-read env knobs on next access)."""
    global _store
    with _store_lock:
        _store = None
