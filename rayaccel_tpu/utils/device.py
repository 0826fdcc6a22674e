"""The device a measurement runs on, named in every line that reports it.

A time or a rate means something only on the accelerator, so the
measurement entry points (bench.py, chip_smoke.py) refuse to run on
anything but a GPU, and label each number with the card and its power
limit (a card set below its maximum power runs slower under load).
"""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> dict:
    """The JAX device set as ``{"platform", "kind", "count"}``; raises
    RuntimeError unless the first device is a GPU (no CPU fallback)."""
    devices = jax.devices()
    d0 = devices[0]
    if d0.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found {d0.platform} "
                           f"({d0.device_kind}); refusing to measure")
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devices)}


def card_info() -> str:
    """Name and power limit of every card as nvidia-smi reports them, one
    card per line, read by a child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
