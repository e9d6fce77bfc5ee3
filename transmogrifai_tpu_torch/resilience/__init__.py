"""Fault tolerance of the serving plane: fault injection, retries with
backoff, circuit breakers, and the data-fault quarantine.

The port's copy of the parts of ``transmogrifai_tpu/resilience/`` that
``serve/`` reads:

- :mod:`.inject`: env-driven deterministic fault injection
  (``TMOG_FAULTS="site:kind:prob:seed,..."``) at named hook sites;
- :mod:`.retry`: one retry-with-exponential-backoff-and-jitter wrapper
  (deadline-aware, transient-vs-fatal classification);
- :mod:`.circuit`: a closed / open / half-open circuit breaker (one per
  serve replica slot);
- :mod:`.quarantine`: :class:`DataFault` and the dead-letter store.

Everything is off by default: with ``TMOG_FAULTS`` unset every hook is one
boolean test.  The JAX package's checkpoints, health tracker and hedged
dispatch are not ported (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from ..obs import registry as _obs_registry

# One shared obs scope for the whole layer, created before the submodules
# import so every module sees the same defaulted scope.
scope = _obs_registry.scope("resilience", defaults=dict(
    faults_injected=0,
    attempts=0,
    retries=0,
    recoveries=0,
    gave_up=0,
    circuit_opens=0,
    circuit_closes=0,
    replica_recoveries=0,
    supervisor_beats=0,
    data_faults=0,
    quarantined=0,
    range_violations=0,
    contract_missing_required=0,
    bisect_probes=0,
    faults=[],
    quarantine=[],
))

from .circuit import CLOSED, HALF_OPEN, OPEN, CircuitBreaker  # noqa: E402
from .inject import (InjectedFault, InjectedFatal, active, add_rule,  # noqa: E402
                     clear_rules, configure, maybe_fail, poison_plan)
from .quarantine import DataFault, QuarantineStore  # noqa: E402
from .quarantine import reset_store as reset_quarantine_store  # noqa: E402
from .quarantine import store as quarantine_store  # noqa: E402
from .retry import RetryPolicy, is_transient, with_retry  # noqa: E402

__all__ = [
    "scope",
    "InjectedFault", "InjectedFatal", "maybe_fail", "configure", "add_rule",
    "clear_rules", "active", "poison_plan",
    "DataFault", "QuarantineStore", "quarantine_store", "reset_quarantine_store",
    "RetryPolicy", "with_retry", "is_transient",
    "CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN",
]
