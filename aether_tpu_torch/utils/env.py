"""Env-var knob parsing shared by every AETHER_* boolean toggle.

One parser, one truthiness rule: unset -> the caller's default; set -> truthy
iff the value is in {1, true, on, yes} (case-insensitive, whitespace
stripped). Advisor round 4 flagged that the toggles previously disagreed on
unrecognized values ('yes' switched features in opposite directions).

Copy of ``aether_tpu/utils/env.py``."""

from __future__ import annotations

import os

_TRUTHY = ("1", "true", "on", "yes")


def env_flag(name: str, default: bool) -> bool:
    mode = os.environ.get(name)
    if mode is None:
        return default
    return mode.strip().lower() in _TRUTHY
