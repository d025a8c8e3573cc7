"""Device identity for the measurement entry points (bench.py, chip_smoke.py).

Every time they print names the device it ran on, and a measurement that finds
no GPU stops instead of timing the CPU.
"""

from __future__ import annotations

import subprocess


def require_gpu(devices) -> None:
    """Exit (non-zero, with a message) unless the first device is a GPU."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise SystemExit(f"no GPU found (first JAX device: {found}); "
                         "this entry point measures the GPU only")


def card_identity() -> str:
    """``name, power limit`` of the first card, as nvidia-smi reports them.

    Runs nvidia-smi in a child process, which does not import JAX.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
