"""The port's copy of the JAX package's ``TMOG_*`` knob parsers
(``transmogrifai_tpu/utils/env.py``), for the knobs the port reads:
``TMOG_GBT_ROUND_COLLAPSE`` (``impl/trees_common.round_collapse_default``)
and the serving plane's (``TMOG_SERVE_REPLICAS``, the breaker, retry,
supervisor, SLO and quarantine-store knobs, ``TMOG_VALIDATE``, ``TMOG_FAULTS``).

Contract shared by every helper: the value is stripped first; empty or
unset gives ``default``; a value that does not parse gives ``default``
instead of raising; the numeric helpers take float syntax for an integer
(``"1e1"`` is 10).
"""
from __future__ import annotations

import os

__all__ = ["env_str", "env_int", "env_float", "env_flag"]


def env_str(name: str, default: str = "") -> str:
    """Stripped string value; empty/unset → ``default``."""
    v = os.environ.get(name, "").strip()
    return v if v else default


def env_int(name: str, default: int) -> int:
    """Int knob; accepts float syntax; empty/garbage → ``default``."""
    v = os.environ.get(name, "").strip()
    if not v:
        return default
    try:
        return int(float(v))
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    """Float knob; empty/garbage → ``default``."""
    v = os.environ.get(name, "").strip()
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean knob: ``0/false/off/no`` (any case) is False, anything else
    non-empty is True, empty/unset is ``default``."""
    v = os.environ.get(name, "").strip().lower()
    if not v:
        return default
    return v not in ("0", "false", "off", "no")
