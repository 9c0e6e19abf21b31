"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), at its full
power limit of 700 W: HBM bandwidth 3.35 TB/s; 32-bit integer rate 64
lanes x 132 SMs x 1,980 MHz (the boost clock). A run prints the card's
power limit beside them (`power_limit`), since a card set lower runs
slower under load.
"""

from __future__ import annotations

import shutil
import subprocess

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
SMS = 132
SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = INT32_LANES_PER_SM * SMS * SM_CLOCK_HZ


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or
    "unknown"."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "unknown"
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"
