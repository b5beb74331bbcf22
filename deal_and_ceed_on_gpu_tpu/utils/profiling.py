"""Tracing/profiling utilities (reference aux subsystem: nvprof/NVVP
workflow documented in README.md:50-88, ``-lineinfo`` builds, Timer +
cudaDeviceSynchronize fencing).

Equivalents here:
- :func:`trace` — context manager around ``jax.profiler`` producing an
  xplane trace viewable in XProf/Perfetto/TensorBoard (the nvprof timeline
  analog).
- :func:`op_stats` — quick wall-clock + achieved-throughput numbers for a
  jitted function with ``block_until_ready`` fencing (the Timer analog).
- :func:`roofline` — bytes/FLOP accounting helper for matrix-free applies.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import jax

__all__ = ["trace", "op_stats", "roofline"]


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a device trace: ``with trace('trace_dir'): f(x)``; inspect
    with XProf/TensorBoard ('Trace Viewer'). The default directory is
    ``jax_trace`` under :func:`tempfile.gettempdir` (honours ``TMPDIR``)."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "jax_trace")
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def op_stats(fn: Callable, *args, n_warmup=2, n_iter=10, work_items=None):
    """Time a jitted callable with proper fencing; returns dict with
    best/mean seconds and items/s if ``work_items`` given."""
    for _ in range(n_warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(n_iter):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    best = min(times)
    stats = {
        "best_s": best,
        "mean_s": sum(times) / len(times),
        "n_iter": n_iter,
    }
    if work_items:
        stats["items_per_s"] = work_items / best
    return stats


# Published peaks, keyed by ``jax.devices()[0].device_kind``. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates without
# sparsity, at the full 700 W power limit (a card set below it cannot hold
# its top clock under load).
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350.0,
        "f64_tflops": 34.0,  # CUDA cores
        "f64_tensor_tflops": 67.0,
        "f32_tflops": 67.0,  # CUDA cores
        "tf32_tensor_tflops": 495.0,
        "bf16_tensor_tflops": 989.0,
    },
}


def device_peaks(device_kind: str) -> dict:
    """The peak table entry for ``device_kind``; an unknown device is an
    error, not a default."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            "utils.profiling.DEVICE_PEAKS with its source"
        ) from None


def roofline(n_dofs, degree, device_kind: str, dtype_bytes=4):
    """Bounds for one BP5 operator apply on the stencil/separable paths:
    ideal traffic = read + write of the nodal grid; FLOPs = three banded
    1D sweeps (2(2p+1) each) on the CUDA cores. Returns ceilings in
    GDoF/s against ``device_kind``'s published peaks."""
    peaks = device_peaks(device_kind)
    flops_tps = peaks["f64_tflops" if dtype_bytes == 8 else "f32_tflops"]
    traffic = 2 * n_dofs * dtype_bytes
    flops = 6 * (2 * degree + 1) * n_dofs
    return {
        "bandwidth_bound_gdofs": n_dofs / (traffic / (peaks["hbm_gbps"] * 1e9)) / 1e9,
        "compute_bound_gdofs": n_dofs / (flops / (flops_tps * 1e12)) / 1e9,
    }
