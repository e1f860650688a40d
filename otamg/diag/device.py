"""The device a measurement runs on.

Measurements (``bench.py``, ``chip_smoke.py``) run on the GPU only: a
number taken on the CPU is not a device number, so these helpers refuse
the CPU instead of falling back to it.
"""

from __future__ import annotations

import subprocess


def require_gpu() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's devices; raises
    ``SystemExit`` (non-zero exit) when JAX found no GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform!r} devices; "
                         f"this measurement runs only on the GPU")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_power() -> str:
    """``name, power.limit`` of the cards as ``nvidia-smi`` reports them,
    read by a child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
