"""Observability of the port: host span tracing, one metrics registry, the
serve SLO monitor.

The port's copy of the parts of ``transmogrifai_tpu/obs/`` that the serving
plane reads:

- :mod:`.trace`: thread-safe nested host spans with Chrome trace-event
  JSON export (``TMOG_TRACE=path.json``; no allocation when off);
- :mod:`.registry`: named scopes of counters and event lists, snapshot
  providers, and the Prometheus text rendering;
- :mod:`.slo`: the rolling-window latency and error-budget judgment over
  the serving metrics.

``obs.snapshot()`` returns the union of every scope and provider.  The JAX
package's per-run telemetry records, launch ledger and timeline profiler
are not ported (ROADMAP Queue 1 item 8); the card's own timeline comes from
``torch.profiler``.
"""
from __future__ import annotations

from typing import Any, Dict

from . import registry, slo, trace
from .registry import (REGISTRY, SCHEMA_VERSION, prometheus_text, record_fallback,
                       register_provider, scope)
from .slo import SLOMonitor
from .trace import complete, instant, span

__all__ = ["trace", "registry", "slo", "snapshot", "span", "instant", "complete", "scope",
           "register_provider", "record_fallback", "prometheus_text", "REGISTRY",
           "SCHEMA_VERSION", "SLOMonitor"]


def snapshot() -> Dict[str, Any]:
    """Every telemetry surface in one dict: the sink modules are imported
    first so their scopes and providers exist even when nothing else
    touched them this run."""
    for mod in ("transmogrifai_tpu_torch.serve.metrics", "transmogrifai_tpu_torch.resilience"):
        __import__(mod)
    return registry.snapshot()
