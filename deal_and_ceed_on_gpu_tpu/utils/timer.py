"""Wall-clock timing with device fencing (reference ``Timer`` +
``cudaDeviceSynchronize``, ``bp5/step-64.cu:442-457``): here the fence is
``jax.block_until_ready`` on the result."""

from __future__ import annotations

import time

import jax

__all__ = ["Timer"]


class Timer:
    def __init__(self):
        self._t0 = None
        self.elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, fence=None):
        if fence is not None:
            jax.block_until_ready(fence)
        self.elapsed += time.perf_counter() - self._t0
        self._t0 = None
        return self.elapsed

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
