"""One retry wrapper: exponential backoff with jitter, deadline-aware,
transient-vs-fatal classification.

The port's copy of ``transmogrifai_tpu/resilience/retry.py``.  An exception
carrying a boolean ``transient`` attribute decides for itself (the
injection layer sets it); otherwise only the conventional I/O-transient
builtins are retried.  Anything else (shape errors, a ``KernelError``, a
failed graph capture) is fatal and propagates on the first attempt.  Every
attempt is an obs span (``resilience.attempt``) and a counter in the
``resilience`` scope.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

from ..obs import registry as obs_registry
from ..obs import trace
from ..utils import env as _env
from .quarantine import DataFault

__all__ = ["RetryPolicy", "with_retry", "is_transient"]

_scope = obs_registry.scope("resilience")

# Jitter desynchronizes concurrent retriers; it shifts *timing* only and
# never any computed value, so it cannot perturb bit-identity.
_jitter = random.Random(0x7E57AB1E)

_TRANSIENT_DEFAULT: Tuple[Type[BaseException], ...] = (
    ConnectionError, TimeoutError, InterruptedError, BlockingIOError)


def is_transient(exc: BaseException) -> bool:
    # A data fault replays identically on every attempt and every machine:
    # never transient, whatever a subclass says about its flags.
    if isinstance(exc, DataFault):
        return False
    flag = getattr(exc, "transient", None)
    if flag is not None:
        return bool(flag)
    return isinstance(exc, _TRANSIENT_DEFAULT)


class RetryPolicy:
    """Knobs resolve through utils/env so ``""`` == unset everywhere."""

    def __init__(self, attempts: Optional[int] = None,
                 base_s: Optional[float] = None,
                 max_s: Optional[float] = None,
                 deadline_s: Optional[float] = None):
        self.attempts = (attempts if attempts is not None
                         else max(1, _env.env_int("TMOG_RETRY_ATTEMPTS", 3)))
        self.base_s = (base_s if base_s is not None
                       else max(0.0, _env.env_float("TMOG_RETRY_BASE_S", 0.05)))
        self.max_s = (max_s if max_s is not None
                      else max(0.0, _env.env_float("TMOG_RETRY_MAX_S", 2.0)))
        self.deadline_s = (deadline_s if deadline_s is not None
                           else max(0.0, _env.env_float(
                               "TMOG_RETRY_DEADLINE_S", 60.0)))


def with_retry(site: str, fn: Callable, *args,
               policy: Optional[RetryPolicy] = None,
               deadline_s: Optional[float] = None, **kwargs):
    """Call ``fn(*args, **kwargs)``; retry transient failures with
    exponential backoff + jitter until the attempt budget or wall deadline
    runs out.  Fatal exceptions propagate immediately.

    ``deadline_s`` clamps the policy deadline for this one call.
    """
    pol = policy or RetryPolicy()
    deadline = pol.deadline_s
    if deadline_s is not None:
        deadline = min(deadline, max(0.0, deadline_s))
    t0 = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        _scope.inc("attempts")
        try:
            with trace.span("resilience.attempt", site=site, attempt=attempt):
                out = fn(*args, **kwargs)
        except Exception as exc:
            transient = is_transient(exc)
            exhausted = attempt >= pol.attempts
            overdue = (time.monotonic() - t0) >= deadline
            if not transient or exhausted or overdue:
                if transient:
                    _scope.inc("gave_up")
                    _scope.append("faults", {
                        "event": "gave_up", "site": site,
                        "attempts": attempt, "error": repr(exc)})
                raise
            _scope.inc("retries")
            _scope.append("faults", {
                "event": "retry", "site": site, "attempt": attempt,
                "error": repr(exc)})
            delay = min(pol.max_s, pol.base_s * (2.0 ** (attempt - 1)))
            delay *= 0.5 + _jitter.random()  # jitter in [0.5, 1.5)x
            remaining = deadline - (time.monotonic() - t0)
            if delay > 0:
                time.sleep(max(0.0, min(delay, remaining)))
            continue
        if attempt > 1:
            _scope.inc("recoveries")
            _scope.append("faults", {
                "event": "recovered", "site": site, "attempts": attempt})
        return out
