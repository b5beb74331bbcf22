"""Baseline preconditioned conjugate gradients — the "pcg-standard" mode.

Textbook PCG as a ``lax.while_loop`` (rebuild of deal.II ``SolverCG`` as
used at ``bp5/step-64.cu:434-475``): separate AXPY-style updates and 2-3
reductions per iteration. This is deliberately the *unfused* comparator the
reference benchmarks the merged solver against; the optimized solver lives in
``cg_merged.py``. All scalars stay on device — there is never a host
round-trip inside the loop.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ._dispatch import dispatch
from .control import SolverControl

__all__ = ["solve_cg"]


def solve_cg(
    A: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    control: SolverControl,
    diag: Optional[jnp.ndarray] = None,
    x0: Optional[jnp.ndarray] = None,
    dot_weight: Optional[jnp.ndarray] = None,
    psum_axis: Optional[str] = None,
):
    """Solve A x = b with Jacobi-preconditioned CG.

    Returns ``(x, info)`` with ``info = {"n_iterations", "res_norm"}`` (both
    device scalars). ``diag`` is multiplied like the reference's
    ``DiagonalMatrix`` (both drivers fill it with 1.0,
    ``bp5/step-64.cu:428-432``); it may also be a CALLABLE preconditioner
    (FDM inverse, multigrid V-cycle).

    Eager calls are routed through a per-(A, control, diag) jit cache
    (``solvers._dispatch``): repeated solves with the same operator and
    preconditioner objects reuse one compiled executable instead of
    re-tracing the while_loop every call. Inside an existing trace the
    solve inlines unchanged.

    Distributed use (inside ``shard_map``): pass ``dot_weight`` to zero out
    ghost-duplicated entries and ``psum_axis`` to all-reduce the scalars over
    the device mesh axis (the ``MPI_Allreduce`` equivalent)."""
    return dispatch(_solve_cg, A, b, control, diag, x0, dot_weight, psum_axis)


def _solve_cg(
    A,
    b,
    control,
    diag=None,
    x0=None,
    dot_weight=None,
    psum_axis=None,
):
    dt = b.dtype

    def dot(u, v):
        uv = u * v if dot_weight is None else u * v * dot_weight
        s = jnp.sum(uv)
        return jax.lax.psum(s, psum_axis) if psum_axis else s

    if callable(diag):
        precond = diag
    else:
        diag_a = 1.0 if diag is None else diag
        precond = lambda r: diag_a * r  # noqa: E731

    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - A(x0)

    res0 = jnp.sqrt(dot(r, r))
    d = precond(r)
    rz = dot(r, d)

    def cond(state):
        x, r, d, rz, it, res = state
        return control.continue_pred(it, res, res0)

    def body(state):
        x, r, d, rz, it, res = state
        h = A(d)
        dh = dot(d, h)
        alpha = jnp.where(dh != 0.0, rz / jnp.where(dh != 0.0, dh, 1.0), 0.0).astype(dt)
        x = x + alpha * d
        r = r - alpha * h
        z = precond(r)
        rz_new = dot(r, z)
        beta = jnp.where(rz != 0.0, rz_new / jnp.where(rz != 0.0, rz, 1.0), 0.0).astype(dt)
        d = z + beta * d
        res = jnp.sqrt(dot(r, r)).astype(res.dtype)
        return (x, r, d, rz_new, it + 1, res)

    state = (x, r, d, rz, jnp.int32(0), res0.astype(dt))
    x, r, d, rz, it, res = jax.lax.while_loop(cond, body, state)
    return x, {"n_iterations": it, "res_norm": res, "res0": res0}
