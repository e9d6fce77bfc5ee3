"""Rolling-window serve SLO monitor: p50/p99 latency and error-budget burn.

The port's copy of ``transmogrifai_tpu/obs/slo.py``.  A ring of timestamped
samples of the serving plane's cumulative counters and latency histogram
(:meth:`~transmogrifai_tpu_torch.serve.metrics.ServeMetrics.slo_sample`),
differenced at the configured window, gives the rolling p50/p99 request
latency, the windowed bad-event rate (errors and shed requests) and the
error-budget **burn rate** (windowed bad rate / (1 - target)).  Alerts are
edge-triggered (one ``firing``, one ``resolved`` event an episode) into the
``slo`` registry scope, which the ``ReplicaSupervisor`` ticks from its probe
loop and ``GET /metrics`` reports.

``sample_fn`` supplies the cumulative sample and ``clock`` the time
source, so a test drives the windows with a fake clock.

Knobs: ``TMOG_SLO_P99_MS`` (threshold), ``TMOG_SLO_TARGET`` (availability
target), ``TMOG_SLO_BURN_WINDOW_S`` (rolling window), ``TMOG_SLO_BURN_RATE``
(burn alert threshold), ``TMOG_SLO_MIN_COUNT`` (events before judging).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from ..utils import env as _env
from . import registry as obs_registry
from . import trace
from .registry import LogHistogram

__all__ = ["SLOMonitor", "DEFAULT_P99_MS", "DEFAULT_TARGET",
           "DEFAULT_WINDOW_S", "DEFAULT_BURN_RATE", "DEFAULT_MIN_COUNT"]

DEFAULT_P99_MS = 250.0
DEFAULT_TARGET = 0.999
DEFAULT_WINDOW_S = 300.0
DEFAULT_BURN_RATE = 14.4
DEFAULT_MIN_COUNT = 10

_scope = obs_registry.scope("slo", defaults={
    "ticks": 0, "alerts_fired": 0, "alerts_resolved": 0, "alerts_active": 0,
    "window_p50_ms": 0.0, "window_p99_ms": 0.0, "window_error_rate": 0.0,
    "burn_rate": 0.0, "error_budget_remaining": 1.0, "events": []})


def _zero_sample() -> Dict[str, Any]:
    return {"requests": 0, "responses": 0, "errors": 0, "shed": 0,
            "latency_counts": [0] * LogHistogram.N_BUCKETS,
            "latency_n": 0, "latency_sum_ms": 0.0, "latency_max_ms": 0.0}


class SLOMonitor:
    """Rolling-window latency/burn judgment over a cumulative sample feed.

    ``sample_fn()`` must return the shape of
    :meth:`~transmogrifai_tpu_torch.serve.metrics.ServeMetrics.slo_sample`:
    cumulative ``requests`` / ``responses`` / ``errors`` / ``shed`` plus the
    request-latency histogram's raw bucket ``latency_counts`` (cumulative
    monotone — differencing two samples yields the traffic between them).
    """

    def __init__(self, sample_fn: Callable[[], Dict[str, Any]],
                 clock: Callable[[], float] = time.monotonic,
                 p99_ms: Optional[float] = None,
                 target: Optional[float] = None,
                 window_s: Optional[float] = None,
                 burn_rate: Optional[float] = None,
                 min_count: Optional[int] = None):
        self.sample_fn = sample_fn
        self.clock = clock
        self.p99_ms = (p99_ms if p99_ms is not None
                       else _env.env_float("TMOG_SLO_P99_MS", DEFAULT_P99_MS))
        self.target = min(1.0 - 1e-9, max(0.0, (
            target if target is not None
            else _env.env_float("TMOG_SLO_TARGET", DEFAULT_TARGET))))
        self.window_s = max(1e-3, (
            window_s if window_s is not None
            else _env.env_float("TMOG_SLO_BURN_WINDOW_S", DEFAULT_WINDOW_S)))
        self.burn_threshold = (
            burn_rate if burn_rate is not None
            else _env.env_float("TMOG_SLO_BURN_RATE", DEFAULT_BURN_RATE))
        self.min_count = max(1, (
            min_count if min_count is not None
            else _env.env_int("TMOG_SLO_MIN_COUNT", DEFAULT_MIN_COUNT)))
        #: (t, cumulative sample) ring: everything inside the window plus
        #: ONE older entry as the window-start baseline
        self._ring: deque = deque()
        #: alert name -> {"since": t, **detail} while firing
        self._active: Dict[str, Dict[str, Any]] = {}
        self._status: Dict[str, Any] = self._empty_status()

    def _empty_status(self) -> Dict[str, Any]:
        return {
            "target": self.target, "window_s": self.window_s,
            "p99_threshold_ms": self.p99_ms,
            "burn_threshold": self.burn_threshold,
            "samples": 0, "window": {
                "requests": 0, "bad": 0, "count": 0, "error_rate": 0.0,
                "p50_ms": 0.0, "p99_ms": 0.0},
            "burn_rate": 0.0, "error_budget_remaining": 1.0,
            "alerts": {}, "breaching": False,
        }

    # ---- the periodic judgment ---------------------------------------------
    def tick(self) -> Dict[str, Any]:
        """Sample, difference at the window, judge, record transitions."""
        now = float(self.clock())
        cur = dict(self.sample_fn())
        self._ring.append((now, cur))
        horizon = now - self.window_s
        # drop entries that are no longer needed as the window baseline:
        # keep the NEWEST entry at-or-before the horizon (so the diff spans
        # at most window_s) plus everything after it
        while len(self._ring) >= 2 and self._ring[1][0] <= horizon:
            self._ring.popleft()
        # the window baseline is the newest sample at-or-before the horizon;
        # until the ring spans a full window the zero sample stands in, so
        # traffic that arrived before the first tick stays IN the window
        # (an alert burst must not resolve on the very next tick)
        base = (self._ring[0][1]
                if len(self._ring) > 1 and self._ring[0][0] <= horizon
                else _zero_sample())

        d_req = max(0, cur["requests"] - base["requests"])
        d_bad = max(0, (cur["errors"] + cur["shed"])
                    - (base["errors"] + base["shed"]))
        h = LogHistogram()
        h.counts = [max(0, c - b) for b, c in
                    zip(base["latency_counts"], cur["latency_counts"])]
        h.n = max(0, cur["latency_n"] - base["latency_n"])
        h.sum_ms = max(0.0, cur["latency_sum_ms"] - base["latency_sum_ms"])
        h.max_ms = cur["latency_max_ms"]
        p50, p99 = h.percentile(50), h.percentile(99)
        err_rate = (d_bad / d_req) if d_req > 0 else 0.0
        budget = max(1e-9, 1.0 - self.target)
        burn = err_rate / budget
        tot_req = cur["requests"]
        tot_bad = cur["errors"] + cur["shed"]
        remaining = (1.0 - tot_bad / (budget * tot_req)) if tot_req else 1.0

        alerts: Dict[str, Dict[str, Any]] = {}
        if h.n >= self.min_count and p99 > self.p99_ms:
            alerts["p99_latency"] = {
                "value_ms": round(p99, 3), "threshold_ms": self.p99_ms}
        if d_req >= self.min_count and burn >= self.burn_threshold:
            alerts["burn_rate"] = {
                "value": round(burn, 3), "threshold": self.burn_threshold,
                "window_error_rate": round(err_rate, 6)}
        self._transition(alerts, now)

        status = {
            "target": self.target, "window_s": self.window_s,
            "p99_threshold_ms": self.p99_ms,
            "burn_threshold": self.burn_threshold,
            "samples": len(self._ring),
            "window": {
                "requests": d_req, "bad": d_bad, "count": h.n,
                "error_rate": round(err_rate, 6),
                "p50_ms": round(p50, 3), "p99_ms": round(p99, 3)},
            "burn_rate": round(burn, 4),
            "error_budget_remaining": round(remaining, 6),
            "alerts": {k: dict(v) for k, v in self._active.items()},
            "breaching": bool(self._active),
        }
        self._status = status
        _scope.inc("ticks")
        _scope.set("window_p50_ms", status["window"]["p50_ms"])
        _scope.set("window_p99_ms", status["window"]["p99_ms"])
        _scope.set("window_error_rate", status["window"]["error_rate"])
        _scope.set("burn_rate", status["burn_rate"])
        _scope.set("error_budget_remaining",
                   status["error_budget_remaining"])
        _scope.set("alerts_active", len(self._active))
        return status

    def _transition(self, alerts: Dict[str, Dict[str, Any]],
                    now: float) -> None:
        """Edge-triggered firing/resolved events into the obs scope."""
        for name, info in alerts.items():
            if name in self._active:
                self._active[name].update(info)  # refresh the live values
                continue
            self._active[name] = {"since": round(now, 3), **info}
            _scope.inc("alerts_fired")
            _scope.append("events", {
                "alert": name, "state": "firing", "at": round(now, 3),
                **info})
            trace.instant("slo.alert", alert=name, state="firing", **info)
        for name in [n for n in self._active if n not in alerts]:
            fired = self._active.pop(name)
            _scope.inc("alerts_resolved")
            _scope.append("events", {
                "alert": name, "state": "resolved", "at": round(now, 3),
                "active_s": round(now - fired["since"], 3)})
            trace.instant("slo.alert", alert=name, state="resolved")

    # ---- views --------------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """The last computed judgment (empty-shape before the first tick)."""
        return dict(self._status)

    def breaching(self) -> bool:
        return bool(self._active)
