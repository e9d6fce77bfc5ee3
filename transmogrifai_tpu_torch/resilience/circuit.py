"""A closed -> open -> half-open circuit breaker.

The port's copy of ``transmogrifai_tpu/resilience/circuit.py``, used per
serve replica slot: consecutive scoring failures past the threshold
(``TMOG_CIRCUIT_THRESHOLD``) open the circuit and traffic routes around the
slot; after the cooldown (``TMOG_CIRCUIT_COOLDOWN_S``) one trial request is
admitted (half-open); a trial success closes the circuit, a trial failure
re-opens it for another cooldown.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from ..obs import registry as obs_registry
from ..utils import env as _env

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]

_scope = obs_registry.scope("resilience")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(self, name: str = "", threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None, clock=time.monotonic):
        self.name = name
        self.threshold = (threshold if threshold is not None
                          else max(1, _env.env_int("TMOG_CIRCUIT_THRESHOLD", 3)))
        self.cooldown_s = (cooldown_s if cooldown_s is not None
                           else max(0.0, _env.env_float(
                               "TMOG_CIRCUIT_COOLDOWN_S", 1.0)))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0      # when the current outage began
        self._trial_inflight = False
        self.opens = 0
        self.closes = 0
        self.total_failures = 0
        self.last_error = ""
        self.last_outage_s = 0.0   # duration of the most recent recovered outage

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def available(self) -> bool:
        """True only when fully closed — the normal-routing predicate."""
        with self._lock:
            return self._state == CLOSED

    def probe_ready(self) -> bool:
        """Non-mutating: is this breaker due a half-open trial request?"""
        with self._lock:
            if self._state == OPEN:
                return self._clock() - self._opened_at >= self.cooldown_s
            return self._state == HALF_OPEN and not self._trial_inflight

    def try_trial(self) -> bool:
        """Admit exactly one in-flight trial request once the cooldown has
        elapsed; the caller must follow with record_success/record_failure."""
        with self._lock:
            if (self._state == OPEN
                    and self._clock() - self._opened_at >= self.cooldown_s):
                self._state = HALF_OPEN
                self._trial_inflight = True
                return True
            if self._state == HALF_OPEN and not self._trial_inflight:
                self._trial_inflight = True
                return True
            return False

    def record_failure(self, error: str = "") -> bool:
        """Returns True when this failure OPENED the circuit."""
        with self._lock:
            self.total_failures += 1
            self._consecutive += 1
            self.last_error = error
            self._trial_inflight = False
            was_open = self._state != CLOSED
            if self._state == HALF_OPEN or (
                    self._state == CLOSED
                    and self._consecutive >= self.threshold):
                # a failed trial re-opens without resetting the outage clock
                if not was_open:
                    self._opened_at = self._clock()
                self._state = OPEN
                if not was_open:
                    self.opens += 1
                    opened = True
                else:
                    opened = False
            else:
                opened = False
        if opened:
            _scope.inc("circuit_opens")
            _scope.append("faults", {
                "event": "circuit_open", "name": self.name, "error": error})
        return opened

    def record_success(self) -> bool:
        """Returns True when this success CLOSED a previously open circuit."""
        with self._lock:
            self._consecutive = 0
            self._trial_inflight = False
            closed = self._state != CLOSED
            if closed:
                self.last_outage_s = self._clock() - self._opened_at
                self._state = CLOSED
                self.closes += 1
        if closed:
            _scope.inc("circuit_closes")
            _scope.append("faults", {
                "event": "circuit_close", "name": self.name,
                "outage_s": round(self.last_outage_s, 4)})
        return closed

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "total_failures": self.total_failures,
                "opens": self.opens,
                "closes": self.closes,
                "last_error": self.last_error,
                "last_outage_s": round(self.last_outage_s, 4),
            }
            if self._state != CLOSED:
                out["open_for_s"] = round(self._clock() - self._opened_at, 4)
            return out
