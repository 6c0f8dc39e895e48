"""The GPU a measurement runs on.

``require_gpu`` refuses any other device, so a measurement never silently
runs on the CPU; ``card_info`` names the card and its power limit as
``nvidia-smi`` reports them, without touching JAX (a card may be set below
its maximum power and then runs slower, so every number is kept beside
it)."""
from __future__ import annotations

import subprocess


def card_info() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output, one card per
    line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def require_gpu(count: int | None = None) -> list:
    """``jax.devices()`` when they are GPUs (exactly ``count`` of them when
    given); otherwise ``SystemExit`` with the reason."""
    import jax
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {len(devices)} {platform} "
                         "device(s); this measurement runs only on a GPU")
    if count is not None and len(devices) != count:
        raise SystemExit(f"expected {count} GPUs, JAX found {len(devices)}")
    return devices


def device_record(devices) -> dict:
    """The device as JAX reports it: platform, kind and count."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}
