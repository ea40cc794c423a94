"""What card a measurement ran on."""
from __future__ import annotations

import subprocess


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi` reports them, one line
    per card; raises if nvidia-smi is missing or fails."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip()
