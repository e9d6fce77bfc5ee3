"""Host span tracer: nested wall-clock spans -> Chrome trace-event JSON.

The port's copy of ``transmogrifai_tpu/obs/trace.py``.  The serving plane's
host steps (``serve.warmup``, ``serve.swap``, ``serve.drain``,
``serve.batch``, ``serve.request``, ``serve.aot.capture``) are wrapped in
:func:`span`.  When tracing is off (the default) ``span()`` returns one
shared no-op singleton: one module-global bool check per call.  When on
(``TMOG_TRACE=path.json``, or :func:`enable` in tests) each span records a
Chrome trace-event "complete" event (``ph: "X"``) into a bounded ring
buffer (``TMOG_TRACE_BUF`` events, default 65536), and :func:`export`
writes the Perfetto-loadable ``{"traceEvents": [...]}`` JSON (with
``TMOG_TRACE`` set, also at interpreter exit).  These are host spans: the
card's own timeline comes from ``torch.profiler``.

All timestamps come from one process-wide ``time.monotonic`` origin, so
spans of different threads share a timeline (the batcher passes the
monotonic times captured at enqueue through :func:`complete`).
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Optional

__all__ = ["enabled", "enable", "disable", "span", "instant", "complete",
           "now", "export", "reset", "events", "DEFAULT_BUF_EVENTS"]

DEFAULT_BUF_EVENTS = 65536

_enabled: bool = False
_path: Optional[str] = None
_buf: Deque[Dict[str, Any]] = deque(maxlen=DEFAULT_BUF_EVENTS)
#: one origin for every thread: ts fields are microseconds since this
_origin: float = time.monotonic()
_atexit_registered = False


def now() -> float:
    """The tracer's clock (``time.monotonic`` seconds).  Callers that span
    across queues capture ``now()`` at entry and pass it to :func:`complete`."""
    return time.monotonic()


def enabled() -> bool:
    return _enabled


def _buf_events() -> int:
    v = os.environ.get("TMOG_TRACE_BUF", "").strip()
    try:
        return max(1, int(float(v))) if v else DEFAULT_BUF_EVENTS
    except ValueError:
        return DEFAULT_BUF_EVENTS


def enable(path: Optional[str] = None, buf_events: Optional[int] = None) -> None:
    """Turn tracing on, ringing at ``buf_events`` (default TMOG_TRACE_BUF).

    ``path`` (or ``TMOG_TRACE``) is where :func:`export` writes by default;
    tests may pass ``path=None`` and export explicitly."""
    global _enabled, _path, _buf, _atexit_registered
    _path = path or os.environ.get("TMOG_TRACE") or _path
    _buf = deque(_buf, maxlen=buf_events or _buf_events())
    _enabled = True
    if _path and not _atexit_registered:
        atexit.register(_export_atexit)
        _atexit_registered = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    _buf.clear()


def events() -> list:
    """A snapshot copy of the buffered events (the timeline/bubble
    profiler's input; same dicts :func:`export` would write)."""
    return list(_buf)


class _NullSpan:
    """Shared do-nothing context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:  # same surface as _Span
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "t0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. a chosen bucket)."""
        self.attrs.update(attrs)

    def __exit__(self, *exc):
        t1 = time.monotonic()
        _buf.append({
            "name": self.name, "ph": "X", "cat": "tmog",
            "ts": (self.t0 - _origin) * 1e6,
            "dur": (t1 - self.t0) * 1e6,
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": self.attrs,
        })
        return False


def span(name: str, **attrs):
    """Context manager timing one nested span.  No-op singleton when off."""
    if not _enabled:
        return _NULL
    return _Span(name, attrs)


def instant(name: str, **attrs) -> None:
    """A zero-duration marker event (``ph: "i"``)."""
    if not _enabled:
        return
    _buf.append({
        "name": name, "ph": "i", "cat": "tmog", "s": "t",
        "ts": (time.monotonic() - _origin) * 1e6,
        "pid": os.getpid(), "tid": threading.get_ident(),
        "args": attrs,
    })


def complete(name: str, t_start: float, t_end: float, **attrs) -> None:
    """Record a span whose endpoints were captured elsewhere (both from
    :func:`now`) — the serve path spans enqueue->response across threads."""
    if not _enabled:
        return
    _buf.append({
        "name": name, "ph": "X", "cat": "tmog",
        "ts": (t_start - _origin) * 1e6,
        "dur": max(0.0, (t_end - t_start)) * 1e6,
        "pid": os.getpid(), "tid": threading.get_ident(),
        "args": attrs,
    })


def export(path: Optional[str] = None) -> Optional[str]:
    """Write the buffered events as Chrome trace-event JSON; returns the
    path written (None if no path is known).  Safe to call repeatedly."""
    path = path or _path
    if not path:
        return None
    events = list(_buf)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path


def _export_atexit() -> None:
    try:
        if _enabled:
            export()
    except Exception:
        pass


# env activation: TMOG_TRACE=path.json turns tracing on at import
if os.environ.get("TMOG_TRACE", "").strip():
    enable(os.environ["TMOG_TRACE"].strip())
