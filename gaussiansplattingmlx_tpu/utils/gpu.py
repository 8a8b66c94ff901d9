"""The card a measurement runs on."""

from __future__ import annotations

import subprocess

import jax


def card_description() -> str:
    """`name, power.limit` of every visible card, as nvidia-smi reports it.
    A card set below its maximum power runs slower under load, so every
    number this program reports is printed beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu():
    """The first JAX device, which must be a GPU: a measurement never falls
    back to the CPU (including JAX's own fallback when the CUDA plugin fails
    to start)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs a GPU, but JAX runs on {dev.platform!r} ({dev.device_kind})"
        )
    return dev
