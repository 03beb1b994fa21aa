"""Environment-variable readers.

The port reads the same ``SDNQ_TPU_*`` knobs as the JAX package where a
knob applies to it (e.g. ``SDNQ_TPU_MIN_MATMUL_ROWS``,
``SDNQ_TPU_ATTN_MATMUL_DTYPE``).  Values are read at call time.
"""

from __future__ import annotations

import os

__all__ = ["env_str", "env_int", "env_bool"]


def env_str(name: str, default: str | None = None) -> str | None:
    v = os.environ.get(name)
    return v if v not in (None, "") else default


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    try:
        return int(v)
    except ValueError:
        return default


def env_bool(name: str, default: bool | None = None) -> bool | None:
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    return v.lower() in ("1", "true", "yes", "on")
