"""One metrics registry for the port's telemetry: the serving plane's.

The port's copy of ``transmogrifai_tpu/obs/registry.py`` (pure Python, no
device work), for the parts the serving plane reads:

- **Scopes** (:class:`Scope`): a named, lock-guarded bag of counters,
  values and event lists (``scope("resilience")`` holds the breaker,
  retry and quarantine counters, ``scope("serve")`` the serving plane's
  recorded routes, ``scope("slo")`` the SLO monitor's judgment);
- **Providers** (:func:`register_provider`): a snapshot callable for a
  subsystem with its own structure (the merged ``ServeMetrics``).

``obs.snapshot()`` composes both into one schema-versioned dict, and
:func:`prometheus_text` renders it in Prometheus text exposition format for
the server's ``GET /metrics?format=prometheus``.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Counter", "Gauge", "LogHistogram", "Scope", "Registry",
           "REGISTRY", "scope", "register_provider", "snapshot",
           "record_fallback", "prometheus_text", "SCHEMA_VERSION"]

#: bump when the snapshot/JSONL record layout changes incompatibly
SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# Metric primitives
# ---------------------------------------------------------------------------
class Counter:
    """Monotonic float counter; one lock per instance."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, by: float = 1.0) -> None:
        with self._lock:
            self._value += by

    def get(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge:
    """Last-write-wins value, or a callable polled at snapshot time."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self, fn: Optional[Callable[[], Any]] = None) -> None:
        self._lock = threading.Lock()
        self._value: Any = 0.0
        self._fn = fn

    def set(self, value: Any) -> None:
        with self._lock:
            self._value = value

    def get(self) -> Any:
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:
                return None
        with self._lock:
            return self._value


class LogHistogram:
    """Log-spaced histogram (the serve latency histogram, promoted here).

    64 buckets geometric from 0.05 with ratio 1.25 (~60 s span in ms units,
    ~12% resolution).  Percentiles interpolate to the geometric midpoint of
    the hit bucket.  NOT internally locked — callers guard it (ServeMetrics
    takes one lock around all its mutators; registry scopes likewise).
    """

    BASE_MS = 0.05
    RATIO = 1.25
    N_BUCKETS = 64

    def __init__(self):
        self.counts = [0] * self.N_BUCKETS
        self.n = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0

    def _bucket(self, ms: float) -> int:
        if ms <= self.BASE_MS:
            return 0
        i = int(math.log(ms / self.BASE_MS) / math.log(self.RATIO)) + 1
        return min(i, self.N_BUCKETS - 1)

    def record(self, ms: float) -> None:
        self.counts[self._bucket(ms)] += 1
        self.n += 1
        self.sum_ms += ms
        if ms > self.max_ms:
            self.max_ms = ms

    def merge(self, other: "LogHistogram") -> None:
        """Accumulate another histogram into this one (multi-instance
        ServeMetrics aggregation)."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        self.sum_ms += other.sum_ms
        if other.max_ms > self.max_ms:
            self.max_ms = other.max_ms

    def percentile(self, p: float) -> float:
        """p in [0, 100]; 0.0 when empty."""
        if self.n == 0:
            return 0.0
        target = p / 100.0 * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                lo = self.BASE_MS * self.RATIO ** (i - 1) if i else 0.0
                hi = self.BASE_MS * self.RATIO ** i
                return math.sqrt(max(lo, self.BASE_MS * 0.5) * hi) if lo else hi
        return self.max_ms

    def to_json(self) -> Dict[str, Any]:
        return {
            "count": self.n,
            "mean_ms": (self.sum_ms / self.n) if self.n else 0.0,
            "max_ms": self.max_ms,
            "p50_ms": self.percentile(50),
            "p95_ms": self.percentile(95),
            "p99_ms": self.percentile(99),
        }


# ---------------------------------------------------------------------------
# Scopes
# ---------------------------------------------------------------------------
class Scope:
    """A named bag of numeric counters, last-write values, and event lists,
    guarded by one lock; readers take a consistent copy via
    :meth:`snapshot` / :meth:`list`."""

    def __init__(self, name: str, defaults: Optional[Dict[str, Any]] = None):
        self.name = name
        self._lock = threading.Lock()
        self._defaults: Dict[str, Any] = dict(defaults or {})
        self._data: Dict[str, Any] = {}
        self.reset()

    def set_defaults(self, defaults: Dict[str, Any]) -> None:
        """Declare the keys a fresh/reset scope starts with (lists are
        copied per reset, never shared)."""
        with self._lock:
            self._defaults = dict(defaults)
            for k, v in self._defaults.items():
                if k not in self._data:
                    self._data[k] = list(v) if isinstance(v, list) else v

    def reset(self) -> None:
        with self._lock:
            self._data = {k: (list(v) if isinstance(v, list) else v)
                          for k, v in self._defaults.items()}

    def inc(self, key: str, by: float = 1.0) -> None:
        with self._lock:
            self._data[key] = self._data.get(key, 0) + by

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            self._data[key] = value

    def append(self, key: str, item: Any) -> None:
        with self._lock:
            self._data.setdefault(key, []).append(item)

    def get(self, key: str, default: Any = 0) -> Any:
        with self._lock:
            v = self._data.get(key, default)
            return list(v) if isinstance(v, list) else v

    def list(self, key: str) -> List[Any]:
        """Shallow-copied event list (each dict entry copied too, so callers
        may mutate their view freely)."""
        with self._lock:
            return [dict(e) if isinstance(e, dict) else e
                    for e in self._data.get(key, [])]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {k: ([dict(e) if isinstance(e, dict) else e for e in v]
                        if isinstance(v, list) else v)
                    for k, v in self._data.items()}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
class Registry:
    """Scopes + snapshot providers behind one process-global instance."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._scopes: Dict[str, Scope] = {}
        self._providers: Dict[str, Callable[[], Any]] = {}

    def scope(self, name: str,
              defaults: Optional[Dict[str, Any]] = None) -> Scope:
        with self._lock:
            sc = self._scopes.get(name)
            if sc is None:
                sc = self._scopes[name] = Scope(name, defaults)
                return sc
        if defaults and not sc._defaults:
            sc.set_defaults(defaults)
        return sc

    def register_provider(self, name: str, fn: Callable[[], Any]) -> None:
        """``snapshot()[name] = fn()`` — for subsystems with their own rich
        snapshot structure (the merged ServeMetrics)."""
        with self._lock:
            self._providers[name] = fn

    def snapshot(self) -> Dict[str, Any]:
        """One consistent-per-scope point-in-time view of everything.

        Scope keys and provider keys share the namespace; providers win on
        collision (none today).  Always carries ``schema_version``.
        """
        with self._lock:
            scopes = dict(self._scopes)
            providers = dict(self._providers)
        out: Dict[str, Any] = {"schema_version": SCHEMA_VERSION}
        for name, sc in scopes.items():
            out[name] = sc.snapshot()
        for name, fn in providers.items():
            try:
                out[name] = fn()
            except Exception as e:  # a broken provider must not kill snapshot
                out[name] = {"provider_error": repr(e)}
        return out


REGISTRY = Registry()


def scope(name: str, defaults: Optional[Dict[str, Any]] = None) -> Scope:
    return REGISTRY.scope(name, defaults)


def register_provider(name: str, fn: Callable[[], Any]) -> None:
    REGISTRY.register_provider(name, fn)


def snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


def record_fallback(domain: str, reason: str, **detail: Any) -> Dict[str, Any]:
    """Append ``{"reason": ..., **detail}`` to ``scope(domain)``'s
    ``fallbacks`` list and return the entry: a path that takes another
    route records why (the serving plane's ``aot_unsupported``: a model
    whose scoring DAG fuses fewer than two stages serves through
    ``BatchScoreFunction`` on the same card)."""
    entry: Dict[str, Any] = {"reason": reason}
    entry.update(detail)
    REGISTRY.scope(domain).append("fallbacks", entry)
    return entry


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------
def _prom_name(*parts: str) -> str:
    name = "_".join(p for p in parts if p)
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _prom_walk(prefix: str, obj: Any, lines: List[str]) -> None:
    if isinstance(obj, bool):
        lines.append(f"{prefix} {int(obj)}")
    elif isinstance(obj, (int, float)):
        if isinstance(obj, float) and not math.isfinite(obj):
            return
        lines.append(f"{prefix} {obj}")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _prom_walk(_prom_name(prefix, str(k)), v, lines)
    elif isinstance(obj, list):
        # event lists (launches, fallbacks) export as their length only;
        # full detail lives in the JSON snapshot / JSONL record
        lines.append(f"{_prom_name(prefix, 'total')} {len(obj)}")


def prometheus_text(snap: Optional[Dict[str, Any]] = None,
                    prefix: str = "tmog") -> str:
    """Flatten a snapshot into Prometheus text format (one numeric leaf per
    line, dict paths joined with ``_``).  Served by ``GET /metrics?format=
    prometheus`` off the same registry as the JSON payload."""
    if snap is None:
        from . import snapshot as full_snapshot

        snap = full_snapshot()
    lines: List[str] = []
    for k, v in snap.items():
        _prom_walk(_prom_name(prefix, str(k)), v, lines)
    return "\n".join(lines) + "\n"
