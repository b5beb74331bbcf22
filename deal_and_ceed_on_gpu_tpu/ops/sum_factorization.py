"""Sum-factorized tensor-product evaluation/integration sweeps.

Equivalent of ``internal::EvaluatorTensorProduct``
(``gradient_at_quad_pts`` / ``value_at_quad_pts`` / ``integrate_value`` /
``integrate_gradient``; used at ``bp5/fe_evaluation_gl.h:192-250``): each
sweep contracts one local tensor axis of a batch of elements with a tiny
1D basis matrix. Batching over elements (and the two passive local axes)
makes every sweep one large matrix product that XLA hands to its GEMM
emitters — no hand-written one-thread-per-qpoint shared-memory scheme.

All functions are shape-polymorphic over leading batch axes: the three local
(z, y, x) axes can sit anywhere, identified by an ``axes`` tuple, so the same
sweeps serve both the element-batched layout ``[E, p1, p1, p1]`` (gather
backend) and the interleaved structured layout ``[mz, p1, my, p1, mx, p1]``
(index-free backend).

Matrices follow the convention ``S[q, a]``, ``D[q, a]``: rows = quadrature
points, columns = nodal coefficients. ``evaluate`` contracts with the node
axis (forward), ``integrate`` contracts with the quadrature axis (transpose).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

__all__ = ["sweep", "evaluate", "integrate", "set_matmul_precision"]

# Default HIGHEST: full f32 products. On the GPU, XLA may run an f32
# matrix product at a lower precision in TF32 (10-bit mantissa, ~1e-3
# relative error per product), which is far too coarse for FEM operator
# application. "high" and "default" are benchmark-only levels, selectable
# via set_matmul_precision / the drivers' --matmul-precision flag. f64
# products are unaffected.
_MATMUL_PRECISION = jax.lax.Precision.HIGHEST


def set_matmul_precision(precision: str | jax.lax.Precision) -> None:
    """Set the matmul precision used by all subsequent sweep traces
    ("highest" | "high" | "default"). Takes effect at TRACE time — call
    before jitting operators, not between calls to an already-jitted one."""
    global _MATMUL_PRECISION
    if isinstance(precision, str):
        precision = {
            "highest": jax.lax.Precision.HIGHEST,
            "high": jax.lax.Precision.HIGH,
            "default": jax.lax.Precision.DEFAULT,
        }[precision.lower()]
    _MATMUL_PRECISION = precision


def sweep(t: jnp.ndarray, mat: jnp.ndarray, axis: int, transpose: bool = False,
          precision=None):
    """Contract ``axis`` of ``t`` with ``mat`` (``[q, a]``); the contracted
    axis is replaced in place (size a -> q, or q -> a when transpose)."""
    axis = axis % t.ndim
    contract_dim = 0 if transpose else 1
    out = jnp.tensordot(
        t, mat, axes=((axis,), (contract_dim,)),
        precision=_MATMUL_PRECISION if precision is None else precision,
    )
    return jnp.moveaxis(out, -1, axis)


def evaluate(
    u: jnp.ndarray,
    S: jnp.ndarray,
    D: jnp.ndarray,
    axes: Sequence[int],
    values: bool,
    gradients: bool,
    collocation: bool,
):
    """Element evaluation: nodal coefficients -> (values, reference-cell
    gradients) at quadrature points. Mirrors ``FEEvaluation::evaluate``
    (``bp5/fe_evaluation_gl.h:192-219``).

    axes = (az, ay, ax) positions of the local z/y/x axes in ``u``.
    Returns (vals | None, (gx, gy, gz) | None); reference-cell gradients,
    i.e. d/d(unit coordinate) — metric terms are applied by the caller's
    quad-point operation (merged-coefficient design, ``bp5/step-64.cu:47``).
    """
    az, ay, ax = axes
    if collocation:
        # S == I: values are nodal values; gradients are single D sweeps
        # (the FEEvaluationGL fast path, bp5/fe_evaluation_gl.h:26-44)
        vals = u if values else None
        grads = None
        if gradients:
            grads = (sweep(u, D, ax), sweep(u, D, ay), sweep(u, D, az))
        return vals, grads

    tx = sweep(u, S, ax)
    txy = sweep(tx, S, ay)
    vals = sweep(txy, S, az) if values else None
    grads = None
    if gradients:
        gz = sweep(txy, D, az)
        gy = sweep(sweep(tx, D, ay), S, az)
        gx = sweep(sweep(sweep(u, D, ax), S, ay), S, az)
        grads = (gx, gy, gz)
    return vals, grads


def integrate(
    vals: Optional[jnp.ndarray],
    grads,
    S: jnp.ndarray,
    D: jnp.ndarray,
    axes: Sequence[int],
    collocation: bool,
) -> jnp.ndarray:
    """Transpose of :func:`evaluate`: quadrature-point (values, gradients)
    -> nodal residual contributions. Mirrors ``FEEvaluation::integrate``
    (``bp5/fe_evaluation_gl.h:222-250``). Quadrature weights / JxW must
    already be folded into the inputs (merged-coefficient convention)."""
    az, ay, ax = axes
    if collocation:
        out = vals
        if grads is not None:
            gx, gy, gz = grads
            gsum = (
                sweep(gx, D, ax, transpose=True)
                + sweep(gy, D, ay, transpose=True)
                + sweep(gz, D, az, transpose=True)
            )
            out = gsum if out is None else out + gsum
        return out

    acc = None
    if grads is not None:
        gx, gy, gz = grads
        # pair the x/y gradient sweeps before the shared z sweep
        txy = sweep(sweep(gx, D, ax, transpose=True), S, ay, transpose=True) + sweep(
            sweep(gy, S, ax, transpose=True), D, ay, transpose=True
        )
        acc = sweep(txy, S, az, transpose=True) + sweep(
            sweep(sweep(gz, S, ax, transpose=True), S, ay, transpose=True),
            D,
            az,
            transpose=True,
        )
    if vals is not None:
        v = sweep(
            sweep(sweep(vals, S, ax, transpose=True), S, ay, transpose=True),
            S,
            az,
            transpose=True,
        )
        acc = v if acc is None else acc + v
    return acc
