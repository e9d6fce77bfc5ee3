"""Self-healing replica supervisor: health probes, circuit breakers, rebuild.

The port's copy of ``transmogrifai_tpu/serve/supervisor.py``.  One daemon
thread watches every replica slot behind a per-slot
:class:`~transmogrifai_tpu_torch.resilience.circuit.CircuitBreaker`:

- the batcher reports scoring outcomes (:meth:`note_success` /
  :meth:`note_failure`); ``TMOG_CIRCUIT_THRESHOLD`` consecutive failures
  open the slot's circuit and traffic routes to the other slots;
- after ``TMOG_CIRCUIT_COOLDOWN_S`` the supervisor takes the half-open
  trial: it rebuilds the slot from the active version
  (``registry.rebuild_slot``: a fresh replica on the same card, its bucket
  graphs from the memo) and probes it with a null-record score; a success
  closes the circuit, a failure re-opens it for another cooldown;
- a heartbeat (``TMOG_SUPERVISOR_HEARTBEAT_S``) records its liveness in the
  ``resilience`` scope, and each tick judges the SLO window
  (:class:`~transmogrifai_tpu_torch.obs.slo.SLOMonitor`).

When every slot is down the batcher serves on the per-record row path
(``degraded_batches``): ``ScoreFunction`` on the replica's card.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..obs import registry as obs_registry
from ..obs import trace
from ..obs.slo import SLOMonitor
from ..resilience.circuit import CircuitBreaker
from ..utils import env as _env

__all__ = ["ReplicaSupervisor"]

_scope = obs_registry.scope("resilience")


class ReplicaSupervisor:
    """Per-slot circuit breakers + the probe/rebuild daemon thread."""

    def __init__(self, registry, metrics=None,
                 interval_s: Optional[float] = None,
                 heartbeat_s: Optional[float] = None):
        self.registry = registry
        self.metrics = metrics
        self.interval_s = (interval_s if interval_s is not None
                           else max(0.05, _env.env_float(
                               "TMOG_SUPERVISOR_INTERVAL_S", 0.2)))
        self.heartbeat_s = (heartbeat_s if heartbeat_s is not None
                            else max(1.0, _env.env_float(
                                "TMOG_SUPERVISOR_HEARTBEAT_S", 30.0)))
        self.breakers = [CircuitBreaker(name=f"serve.slot{i}")
                         for i in range(registry.n_replicas)]
        #: rolling-window SLO judgment over the batcher's ServeMetrics,
        #: ticked from the probe loop (None when no metrics were attached)
        self.slo: Optional[SLOMonitor] = (
            SLOMonitor(metrics.slo_sample)
            if metrics is not None and hasattr(metrics, "slo_sample")
            else None)
        self.recoveries = 0
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._last_beat = 0.0

    # ---- batcher-facing outcome reports ------------------------------------
    def breaker(self, slot: int) -> CircuitBreaker:
        return self.breakers[slot]

    def routable(self, slot: int) -> bool:
        """May the batcher send this slot normal traffic?  Closed circuits
        always; open ones only when due a half-open trial (the batcher's
        dispatch then races the probe loop for the single trial token)."""
        b = self.breakers[slot]
        return b.available or b.probe_ready()

    def any_routable(self) -> bool:
        return any(self.routable(i) for i in range(len(self.breakers)))

    def note_success(self, slot: int) -> None:
        if self.breakers[slot].record_success():
            self.recoveries += 1
            _scope.inc("replica_recoveries")

    def note_failure(self, slot: int, error: Any = "") -> None:
        if self.metrics is not None:
            self.metrics.inc("replica_failures")
        self.breakers[slot].record_failure(repr(error))

    # ---- probe / rebuild ----------------------------------------------------
    def _probe(self, slot: int, brk: CircuitBreaker) -> None:
        """The half-open trial: rebuild the slot from the active artifact and
        null-record health-probe the fresh replica."""
        with trace.span("serve.probe", slot=slot):
            try:
                rep = self.registry.rebuild_slot(slot)
                if rep is None:  # nothing deployed yet
                    brk.record_failure("no active model")
                    return
                rep.score([{}])
            except Exception as e:  # noqa: BLE001 — any probe failure re-opens
                if self.metrics is not None:
                    self.metrics.inc("replica_failures")
                brk.record_failure(repr(e))
                return
        if brk.record_success():
            self.recoveries += 1
            _scope.inc("replica_recoveries")
            _scope.append("faults", {
                "event": "replica_recovered", "slot": slot,
                "outage_s": round(brk.last_outage_s, 4)})

    def _loop(self) -> None:
        while self._running:
            now = time.monotonic()
            if now - self._last_beat >= self.heartbeat_s:
                self._last_beat = now
                _scope.inc("supervisor_beats")
            if self.slo is not None:
                try:
                    self.slo.tick()
                except Exception:  # judgment must never kill the probe loop
                    pass
            for slot, brk in enumerate(self.breakers):
                if not self._running:
                    break
                if brk.probe_ready() and brk.try_trial():
                    self._probe(slot, brk)
            time.sleep(self.interval_s)

    # ---- lifecycle -----------------------------------------------------------
    def start(self) -> "ReplicaSupervisor":
        if self._running:
            return self
        self._running = True
        self._last_beat = time.monotonic()
        _scope.inc("supervisor_beats")  # beat 1: started
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-supervisor", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None

    # ---- export --------------------------------------------------------------
    def health(self) -> List[Dict[str, Any]]:
        """Per-slot health: circuit snapshot + the live replica's identity."""
        slots = self.registry.slots()
        out = []
        for i, brk in enumerate(self.breakers):
            rep = slots[i] if i < len(slots) else None
            out.append({
                "slot": i,
                "replica": None if rep is None else rep.id,
                "healthy": brk.available,
                "circuit": brk.snapshot(),
            })
        return out

    def snapshot(self) -> Dict[str, Any]:
        return {
            "running": self._running,
            "recoveries": self.recoveries,
            "interval_s": self.interval_s,
            "slots": self.health(),
            "slo": None if self.slo is None else self.slo.status(),
        }
