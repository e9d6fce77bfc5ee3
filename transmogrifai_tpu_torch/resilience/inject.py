"""Deterministic, env-driven fault injection.

The port's copy of ``transmogrifai_tpu/resilience/inject.py``.
``TMOG_FAULTS`` arms a comma-separated list of rules::

    site[#key]:kind[:prob[:seed[:after[:fires]]]]
    site[#key]:delay:seconds[:prob[:seed[:after[:fires]]]]
    site[#key]:poison:rows[:prob[:seed[:after[:fires]]]]

- ``site``: a named hook site; the port's are ``serve.score`` and
  ``serve.warm``.  An optional ``#key`` suffix narrows the rule to one
  instance (``serve.score#1`` fails only replica slot 1).
- ``kind``: ``error`` (raises :class:`InjectedFault`, transient, so the
  retry wrapper absorbs it), ``fatal`` (:class:`InjectedFatal`, never
  retried), ``kill`` (``SIGKILL`` to the current process), ``delay``
  (sleeps ``seconds`` then proceeds: a straggler), or ``poison`` (corrupts
  ``rows`` records of the batch at the site with NaN / Inf / type garbage,
  consumed by :func:`poison_plan`, never raised by :func:`maybe_fail`).
  ``delay`` and ``poison`` take one extra leading field (seconds, rows).
- ``prob``: firing probability per eligible invocation (default 1);
  ``seed``: the rule's private ``random.Random`` seed (default 0);
  ``after``: skip the first N matching invocations (default 0);
  ``fires``: stop after N injected faults (default 0 = unlimited).

``maybe_fail(site, key=...)`` is the hook; with ``TMOG_FAULTS`` unset it is
one module-global boolean test.
"""
from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import List, Optional

from ..obs import registry as obs_registry
from ..utils import env as _env

__all__ = ["InjectedFault", "InjectedFatal", "maybe_fail", "configure",
           "add_rule", "clear_rules", "active", "poison_plan",
           "garbage_value", "GARBAGE_KINDS"]

_scope = obs_registry.scope("resilience")


class InjectedFault(RuntimeError):
    """A transient injected failure: the retry wrapper may absorb it."""

    transient = True


class InjectedFatal(RuntimeError):
    """A permanent injected failure: never retried."""

    transient = False


_KINDS = ("error", "fatal", "kill", "delay", "poison")

#: deterministic garbage cycle for kind="poison" (one per poisoned row)
GARBAGE_KINDS = ("nan", "inf", "type", "text")


class _Rule:
    __slots__ = ("site", "key", "kind", "prob", "seed", "after", "fires",
                 "seconds", "rng", "count", "fired")

    def __init__(self, site: str, key: Optional[str], kind: str,
                 prob: float, seed: int, after: int, fires: int = 0,
                 seconds: float = 0.0):
        self.site = site
        self.key = key
        self.kind = kind
        self.prob = prob
        self.seed = seed
        self.after = after
        self.fires = fires   # max injections (0 = unlimited)
        self.seconds = seconds   # sleep length for kind="delay"
        self.rng = random.Random(seed)
        self.count = 0   # eligible invocations seen
        self.fired = 0   # faults actually injected

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        tgt = self.site + (f"#{self.key}" if self.key is not None else "")
        return (f"_Rule({tgt}:{self.kind}:{self.prob}:{self.seed}"
                f":{self.after}:{self.fires} "
                f"count={self.count} fired={self.fired})")


_rules: List[_Rule] = []
_active = False
_lock = threading.Lock()


def parse_rules(spec: str) -> List[_Rule]:
    rules: List[_Rule] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(
                f"bad TMOG_FAULTS rule {part!r}: want "
                "site[#key]:kind[:prob[:seed[:after[:fires]]]]")
        site = fields[0].strip()
        key: Optional[str] = None
        if "#" in site:
            site, key = site.split("#", 1)
        kind = fields[1].strip().lower()
        if kind not in _KINDS:
            raise ValueError(f"bad TMOG_FAULTS kind {kind!r} in {part!r}: "
                             f"want one of {_KINDS}")
        seconds = 0.0
        if kind in ("delay", "poison"):
            # delay/poison take an extra leading field (sleep seconds /
            # poisoned-row count); prob/seed/after/fires shift right by one.
            what = "seconds" if kind == "delay" else "rows"
            if len(fields) < 3 or not fields[2].strip():
                raise ValueError(f"bad TMOG_FAULTS rule {part!r}: {kind} "
                                 f"wants site[#key]:{kind}:{what}[:prob[...]]")
            seconds = float(fields[2])
            if seconds <= 0.0:
                raise ValueError(f"bad TMOG_FAULTS rule {part!r}: {kind} "
                                 f"{what} must be positive, got {seconds}")
            fields = fields[:2] + fields[3:]
        prob = float(fields[2]) if len(fields) > 2 and fields[2].strip() else 1.0
        seed = int(fields[3]) if len(fields) > 3 and fields[3].strip() else 0
        after = int(fields[4]) if len(fields) > 4 and fields[4].strip() else 0
        fires = int(fields[5]) if len(fields) > 5 and fields[5].strip() else 0
        rules.append(_Rule(site, key, kind, prob, seed, after, fires, seconds))
    return rules


def configure(spec: Optional[str] = None) -> int:
    """(Re)arm the registry from ``spec`` (or ``$TMOG_FAULTS`` when None);
    returns the number of active rules.  ``configure("")`` disarms."""
    global _rules, _active
    if spec is None:
        spec = _env.env_str("TMOG_FAULTS", "")
    with _lock:
        _rules = parse_rules(spec) if spec else []
        _active = bool(_rules)
    return len(_rules)


def add_rule(rule_spec: str) -> None:
    """Arm extra rules programmatically (probe_serve ``--kill-replica``)."""
    global _active
    new = parse_rules(rule_spec)
    with _lock:
        _rules.extend(new)
        _active = bool(_rules)


def clear_rules(site: Optional[str] = None) -> None:
    """Disarm every rule, or only the rules for one site."""
    global _rules, _active
    with _lock:
        _rules = [] if site is None else [r for r in _rules if r.site != site]
        _active = bool(_rules)


def active() -> bool:
    return _active


def maybe_fail(site: str, key=None) -> None:
    """Fault hook: raise/kill if an armed rule matches this invocation."""
    if not _active:  # the TMOG_FAULTS-unset fast path: one boolean test
        return
    skey = None if key is None else str(key)
    for r in _rules:
        if r.site != site or (r.key is not None and r.key != skey):
            continue
        if r.kind == "poison":
            continue   # consumed by poison_plan at batch sites, never raised
        with _lock:
            r.count += 1
            hit = (r.count > r.after
                   and (r.fires <= 0 or r.fired < r.fires)
                   and r.rng.random() < r.prob)
            if hit:
                r.fired += 1
        if not hit:
            continue
        _scope.inc("faults_injected")
        record = {
            "event": "injected", "site": site, "key": skey,
            "kind": r.kind, "hit": r.fired, "invocation": r.count,
        }
        if r.kind == "delay":
            record["seconds"] = r.seconds
        _scope.append("faults", record)
        if r.kind == "delay":
            time.sleep(r.seconds)
            continue   # a straggler proceeds after the stall
        if r.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        cls = InjectedFault if r.kind == "error" else InjectedFatal
        where = site if skey is None else f"{site}#{skey}"
        raise cls(f"injected {r.kind} at {where} "
                  f"(hit {r.fired}, invocation {r.count})")


def garbage_value(kind: str):
    """The planted value for one poisoned row (``GARBAGE_KINDS`` member).
    Numeric-array sites that can't represent type/text garbage map those
    kinds to NaN."""
    if kind == "nan":
        return float("nan")
    if kind == "inf":
        return float("inf")
    if kind == "type":
        return ["not", "a", "scalar"]
    return "!!poison!!"


def poison_plan(site: str, n: int, key=None):
    """Data-fault hook for batch sites: the poison rows for this invocation.

    Returns ``[(row_index, garbage_kind), ...]`` (empty when no armed
    poison rule fires).  Row choice and garbage assignment come from the
    rule's private RNG, so a fixed ``TMOG_FAULTS`` string poisons the same
    rows with the same garbage on every run — the clean-row bit-parity
    chaos assertion depends on that.  ``maybe_fail`` never raises for
    poison rules; the batch sites apply this plan to their own rows.
    """
    if not _active or n <= 0:
        return []
    skey = None if key is None else str(key)
    plan = []
    for r in _rules:
        if r.kind != "poison" or r.site != site or \
                (r.key is not None and r.key != skey):
            continue
        with _lock:
            r.count += 1
            hit = (r.count > r.after
                   and (r.fires <= 0 or r.fired < r.fires)
                   and r.rng.random() < r.prob)
            if hit:
                r.fired += 1
                k = max(1, min(n, int(r.seconds)))
                rows = sorted(r.rng.sample(range(n), k))
        if not hit:
            continue
        _scope.inc("faults_injected")
        _scope.append("faults", {
            "event": "injected", "site": site, "key": skey, "kind": "poison",
            "rows": rows, "hit": r.fired, "invocation": r.count,
        })
        for j, idx in enumerate(rows):
            plan.append((idx, GARBAGE_KINDS[(r.fired - 1 + j)
                                            % len(GARBAGE_KINDS)]))
    return plan


# Arm from the environment at import so subprocess chaos runs need no code.
configure()
