"""Which device a measurement ran on.

Every number the benchmark and the smoke test print names its device:
JAX's platform, device kind and count, plus the card's name and power limit
as ``nvidia-smi`` reports them (a card set below its maximum power runs
slower under load). A measurement path that finds no GPU fails; it never
falls back to the CPU.
"""

from __future__ import annotations

import subprocess


def card_info() -> str:
    """``name, power.limit`` of the visible cards, one line per card, or a
    note that nvidia-smi could not be read. Runs nvidia-smi as a child
    process that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.strip()


def device_stamp() -> dict:
    """Platform, device kind and count as JAX reports them, and the card
    line from nvidia-smi."""
    import jax
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "card": card_info()}


def require_gpu() -> dict:
    """``device_stamp()`` when JAX's default devices are GPUs; otherwise
    raise SystemExit with a non-zero code."""
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default platform is {platform!r}")
    return device_stamp()
