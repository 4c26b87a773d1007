"""Name and power limit of the GPU, read with nvidia-smi.

Recorded beside every measured rate: a card set below its power limit runs
slower under load. Imports no JAX, so a parent process that must not hold a
device (chip_smoke.py) can call it.
"""

from __future__ import annotations

import subprocess


def card_info() -> str:
    """``name, power limit`` of the first card as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them, or ``unknown (...)`` where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({type(e).__name__})"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "unknown (no card listed)"
