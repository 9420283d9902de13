"""The device a measurement runs on.

A measurement path that finds no GPU fails: it never falls back to the CPU,
whose times say nothing about the card.  The card's name and power limit
are read by ``nvidia-smi`` in a child process that does not import JAX, so
the read never competes with this process for the card."""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def require_gpu(device=None):
    """The first JAX device (or ``device``), when it is a GPU.  Raises
    ``SystemExit`` with a message (exit status 1) otherwise."""
    if device is None:
        import jax

        device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(f"needs a GPU, but JAX runs on {device.platform!r} "
                         f"({device.device_kind})")
    return device


def device_summary(device) -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports them."""
    import jax

    return {"platform": device.platform, "kind": device.device_kind,
            "count": len(jax.devices())}


def card_info() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line,
    e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``.  Raises when ``nvidia-smi``
    is missing or fails."""
    out = subprocess.run(NVIDIA_SMI_QUERY, check=True, capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()
