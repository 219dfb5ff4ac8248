"""The accelerator a measurement runs on.

A time, a rate or an agreement figure is only about the card it was taken
on, so measurement entry points (``bench.py``, ``chip_smoke.py``) start
with ``require_gpu`` and record the card's name and power limit beside
their numbers; there is no CPU fallback.
"""

from __future__ import annotations

import subprocess

__all__ = ["require_gpu", "gpu_name_and_power_limit"]


def require_gpu(devices=None):
    """Return the first JAX device, or raise ``RuntimeError`` unless it is
    a GPU (``platform == "gpu"``)."""
    if devices is None:
        import jax

        devices = jax.devices()
    dev = devices[0] if devices else None
    if dev is None or dev.platform != "gpu":
        raise RuntimeError(
            "an NVIDIA GPU is required: JAX's default device is "
            f"{getattr(dev, 'platform', None)!r} ({dev!r})")
    return dev


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` as it prints them, one
    line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
