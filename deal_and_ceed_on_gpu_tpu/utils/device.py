"""The accelerator a measurement runs on: a refusal without a GPU, the
card's name and power limit, and the device record every result names."""

from __future__ import annotations

import json
import subprocess

import jax

__all__ = ["require_gpu", "card_line", "device_record", "result_line"]


def require_gpu() -> None:
    """Exit non-zero unless JAX's first device is a GPU: a measurement
    taken elsewhere is not a number for the card."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {platform!r}; refusing to measure")


def card_line() -> str:
    """``name, power.limit`` of each card as ``nvidia-smi`` reports them
    (power limits below 700 W slow an H100 under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip()


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}


def result_line(**extra) -> str:
    """The one-line JSON result of a run that passed:
    ``{"ok": true, "device": {...}, ...extra}``."""
    return json.dumps({"ok": True, "device": device_record(), **extra})
