"""Which device a measurement ran on.

Every timing the entry points print names the device beside it: JAX's own description
(`platform`, `device_kind`, device count) and, on an NVIDIA card, the card's name and
power limit as `nvidia-smi` reports them — a card set below its maximum power runs
slower under load, so a time without its power limit cannot be compared with another.
"""

from __future__ import annotations

import shutil
import subprocess


def jax_device() -> dict:
    """{"platform", "kind", "count"} of the default backend."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}


def nvidia_smi_cards() -> list[str]:
    """One `name, power.limit` line per card (`nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`); empty when `nvidia-smi` is absent or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]
