"""Mixed-precision iterative refinement: f32 CG inner solves, f64 true
residuals.

f32 CG stagnates near a true relative residual of ~1e-4 (the recurrence
residual free-falls below the true one), while f64 moves twice the bytes.
Classical iterative refinement gets the best of both where f64 is slow —
an extension over the reference, whose double-precision solver never
faces the tradeoff (SURVEY.md "hard parts"). Whether it beats native f64
on the GPU is not measured yet:

    repeat:  r = b - A x          (f64 operator, true residual)
             solve A e ~= r       (f32 merged CG, loose reduction)
             x += e               (f64 accumulation)

Each cycle multiplies the error by roughly the f32 stagnation level, so a
handful of cheap f32 solves (plus one emulated-f64 apply each) reach
1e-10 like the all-f64 CG at a fraction of its cost. The outer loop is a
host loop over jitted steps — a few iterations, not per-CG-step traffic.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .cg_merged import solve_cg_merged
from .control import NoConvergence, ReductionControl

__all__ = ["solve_cg_ir"]


def solve_cg_ir(
    op32,
    op64,
    b64: jnp.ndarray,
    rtol: float = 1e-10,
    inner_reduction: float = 1e-4,
    inner_max: int = 1000,
    max_outer: int = 25,
    diag32: Optional[jnp.ndarray] = None,
):
    """Solve ``A x = b`` to a TRUE f64 relative residual ``rtol``.

    ``op32``/``op64`` are the same operator built at the two precisions
    (same mesh/degree/quadrature). ``diag32`` may be a vector (Jacobi,
    default) or a callable preconditioner such as ``FDMSolver.apply`` —
    callables route the inner solve through the plain CG (merged CG is
    diagonal-only). Returns ``(x64, info)`` with ``n_outer``, total
    ``n_inner`` CG iterations, and the final true relative residual."""
    assert b64.dtype == jnp.float64, "b must be f64 (the accumulation dtype)"
    inner_control = ReductionControl(
        inner_max, tolerance=0.0, reduction=inner_reduction,
        success_on_max_steps=True,
    )
    if diag32 is None:
        diag32 = op32.jacobi_preconditioner()

    # jitted steps are cached on the operator: repeated solves (timed
    # benchmark loops) must not re-trace
    cache = getattr(op32, "_ir_cache", None)
    if cache is None:
        cache = {}
        op32._ir_cache = cache
    key = (id(op64), inner_control, callable(diag32))
    fns = cache.get(key)
    if fns is None:
        # eager entry-point calls: the solver dispatch layer jit-caches
        # the whole inner solve with closure constants HOISTED to runtime
        # arguments (solvers/_dispatch._HoistedJit) — wrapping in a local
        # jax.jit here would re-embed the operator/preconditioner tables
        # (e.g. a dense MG coarse inverse) as HLO literals in the compile
        # payload
        if callable(diag32):
            from .cg import solve_cg

            inner = lambda r32: solve_cg(  # noqa: E731
                op32.vmult, r32, inner_control, diag=diag32
            )
        else:
            inner = lambda r32: solve_cg_merged(  # noqa: E731
                op32.vmult, r32, inner_control, diag=diag32
            )
        # one fused jitted update: true f64 residual, correction add, norm
        @jax.jit
        def refine(x, b, e32):
            x = x + e32.astype(jnp.float64)
            r = b - op64.vmult(x)
            return x, r, jnp.linalg.norm(r)

        fns = (inner, refine)
        cache[key] = fns
    inner, refine = fns

    bnorm = float(jnp.linalg.norm(b64))
    if bnorm == 0.0:
        return jnp.zeros_like(b64), {
            "n_outer": 0,
            "n_inner": 0,
            "res_rel": 0.0,
        }
    x = jnp.zeros_like(b64)
    r = b64
    n_inner = 0
    res_rel = 1.0
    for outer in range(1, max_outer + 1):
        e32, info = inner(r.astype(jnp.float32))
        n_inner += int(info["n_iterations"])
        x, r, rnorm = refine(x, b64, e32)
        res_rel = float(rnorm) / bnorm
        if res_rel <= rtol:
            return x, {
                "n_outer": outer,
                "n_inner": n_inner,
                "res_rel": res_rel,
            }
    raise NoConvergence(max_outer, res_rel)
