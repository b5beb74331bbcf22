from . import checkpoint, native, oracle, profiling, vtk
from .hoist import jit_hoisted
from .logging import pcout0, rank0_print
from .timer import Timer

__all__ = [
    "oracle",
    "native",
    "vtk",
    "profiling",
    "checkpoint",
    "pcout0",
    "rank0_print",
    "Timer",
    "ensure_x64",
    "enable_compilation_cache",
    "jit_hoisted",
]


def ensure_x64(dtype) -> None:
    """Enable ``jax_enable_x64`` when ``dtype`` is a 64-bit type.

    Driver CLIs take ``--dtype float64``; without this, JAX silently
    truncates every f64 array to f32 — the step-64 golden fingerprint (60
    iterations, L2 0.0205268514) is an f64 result and quietly degrades to
    64 its otherwise."""
    import jax

    if "64" in str(dtype):
        jax.config.update("jax_enable_x64", True)


def enable_compilation_cache() -> str:
    """Persistent XLA compilation cache for the drivers, ``bench.py`` and
    ``chip_smoke.py``: repeated runs hit identical programs.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and this sets
    no directory of its own; otherwise the cache is the fixed directory
    ``.jax_cache`` at the root of the checkout (a fixed path, since the
    path is part of the cache key). Returns the directory in use."""
    import os

    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    d = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ".jax_cache",
    )
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    return d
