"""The card's name and power limit, as ``nvidia-smi`` prints them: a copy
of the port's ``bench.card_line``.  A card may run below its 700 W, and
slower under load, so every number is kept beside this line."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"
    return out[0].strip()
