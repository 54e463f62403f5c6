"""What the entry-point scripts report about the device they ran on."""

from __future__ import annotations

import subprocess

import jax


def device_record() -> dict:
    """Platform, kind and count of JAX's devices."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi`` name and power limit of each card, one line per card.

    A card set below its top power limit runs slower under load, so every
    timing is reported beside this line.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()
