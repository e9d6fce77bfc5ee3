"""The port's own copy of the JAX package's ``TMOG_*`` integer knob parser
(``transmogrifai_tpu/utils/env.py::env_int``), for the one knob the port
reads: ``TMOG_GBT_ROUND_COLLAPSE`` (``impl/trees_common.round_collapse_default``).

The value is stripped first; empty or unset gives ``default``; float syntax
is taken for an integer (``"1e1"`` is 10); a value that does not parse gives
``default`` instead of raising.
"""
from __future__ import annotations

import os

__all__ = ["env_int"]


def env_int(name: str, default: int) -> int:
    """Int knob; accepts float syntax; empty/garbage → ``default``."""
    v = os.environ.get(name, "").strip()
    if not v:
        return default
    try:
        return int(float(v))
    except ValueError:
        return default
