"""Fused-kernel preconditioned CG — the "pcg-merged" solver.

Rebuild of ``SolverCGFullMerge`` (``bp5/solver.h:15-542``), the reference's
centerpiece optimization, re-expressed for XLA. Per iteration exactly:

1. one fused vector-update pass (the ``update_a*`` kernels,
   ``bp5/solver.h:48-140``),
2. one operator apply ``h = A d``,
3. one fused pass producing all **seven** simultaneous dot products
   (``update_b``, ``bp5/solver.h:142-311``):
   ``d.h, h.h, g.h, g.g, g.(diag h), h.(diag h), g.diag.g``,
4. scalar recurrences — alpha, the **reduction-free residual norm**
   ``|g_new| = sqrt(g.g + 2 a g.h + a^2 h.h)`` (``bp5/solver.h:504-505``)
   and ``beta = a (g.Mh + a h.Mh) / (g.Mg)`` (``bp5/solver.h:533``).

Where the reference pays one 7-double D2H memcpy + ``MPI_Allreduce`` per
iteration (``bp5/solver.h:488-494``), here every scalar lives on device
inside the ``lax.while_loop``; under sharding the seven sums become a single
fused ``psum``.

``deferred_x_update=True`` implements the Kronbichler data-locality scheme
(``OPTIMIZED_UPDATE``, ``bp5/solver.h:106-140,509-526``; cf. arXiv
2205.08909): x is touched only every second iteration via the merged
two-step formula. Default False: the parity ``lax.cond`` phases can break
XLA's loop-body fusion and cost more than the skipped x-writes save; on
the GPU the tradeoff is not measured yet. The scheme is kept (and
parity-tested) because it is the reference's centerpiece trick.

    x += (a_j + a_{j-1}/b_{j-1}) d_j + (a_{j-1}/b_{j-1}) * diag * g_{j-1}

which equals ``a_{j-1} d_{j-1} + a_j d_j`` by the direction recurrence.
NOTE a reference quirk (not reproduced): ``bp5/solver.h:413-472`` selects
``update_a1`` on *every* iteration once ``alpha_old != 0``, double-counting
``alpha*d`` terms; benign for the fixed-iteration throughput benchmark but
wrong for the solution. Here the two-step update fires exactly on even
iterations, and the final fix-up on convergence at an odd iteration is
``x += a d`` (the ``update_c``/``x.add`` epilogue, ``bp5/solver.h:509-526``).

Sign conventions follow the reference (``bp5/solver.h:375-381``):
``g = A x - b``, ``d = -diag g + beta d``, ``g += alpha h``.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ._dispatch import dispatch
from .control import SolverControl

__all__ = ["solve_cg_merged"]


def solve_cg_merged(
    A: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    control: SolverControl,
    diag: Optional[jnp.ndarray] = None,
    x0: Optional[jnp.ndarray] = None,
    deferred_x_update: bool = False,
    dot_weight: Optional[jnp.ndarray] = None,
    psum_axis: Optional[str] = None,
):
    """Solve A x = b. Returns ``(x, info)``; see ``solve_cg`` for the diag
    convention, the distributed ``dot_weight``/``psum_axis`` knobs, and the
    eager-call jit cache (``solvers._dispatch``) both entry points share.
    The whole solve is one jittable expression."""
    return dispatch(
        _solve_cg_merged,
        A,
        b,
        control,
        diag,
        x0,
        dot_weight,
        psum_axis,
        deferred_x_update=deferred_x_update,
    )


def _solve_cg_merged(
    A,
    b,
    control,
    diag=None,
    x0=None,
    dot_weight=None,
    psum_axis=None,
    deferred_x_update=False,
):
    dt = b.dtype

    def _reduce(*scalars):
        if psum_axis:
            return jax.lax.psum(jnp.stack(scalars), psum_axis)
        return jnp.stack(scalars)

    # diag == None is the reference's identity DiagonalMatrix; a python
    # scalar broadcasts through every use below WITHOUT materializing (or
    # streaming) an all-ones vector
    diag_a = 1.0 if diag is None else diag

    # init (bp5/solver.h:373-383): g = A x - b, short-circuit for x0 == None
    if x0 is None:
        x = jnp.zeros_like(b)
        g = -b
    else:
        x = x0
        g = A(x0) - b

    def dots7(da, ga, ha):
        """One fused pass: the update_b seven-way
        reduction. Elementwise products share the four input reads; XLA
        fuses the sibling sums, and under sharding the stacked psum is ONE
        7-scalar all-reduce — the reference's single
        ``MPI_Allreduce(…, 7, …)``."""
        w = 1.0 if dot_weight is None else dot_weight
        dg = diag_a * ha
        gd = ga * w
        s = _reduce(
            jnp.sum(da * w * ha),        # 0: d.h     (p.v)
            jnp.sum(ha * w * ha),        # 1: h.h     (v.v)
            jnp.sum(gd * ha),            # 2: g.h     (r.v)
            jnp.sum(gd * ga),            # 3: g.g     (r.r)
            jnp.sum(gd * dg),            # 4: g.Mh    (r.diag v)
            jnp.sum(ha * w * dg),        # 5: h.Mh    (v.diag v)
            jnp.sum(gd * (diag_a * ga)), # 6: g.Mg    (r.diag r)
        )
        return s[0], s[1], s[2], s[3], s[4], s[5], s[6]

    w0 = 1.0 if dot_weight is None else dot_weight
    res0_sq = jnp.sum(g * w0 * g)
    if psum_axis:
        res0_sq = jax.lax.psum(res0_sq, psum_axis)
    res0 = jnp.sqrt(res0_sq)
    d = -diag_a * g  # update_a0 (bp5/solver.h:48-72)

    zero = jnp.zeros((), dtype=dt)

    def cond(state):
        return control.continue_pred(state["it"], state["res"], res0)

    def body(state):
        x, g, d = state["x"], state["g"], state["d"]
        alpha_prev, beta_prev = state["alpha"], state["beta"]
        it = state["it"] + 1

        h = A(d)
        s0, s1, s2, s3, s4, s5, s6 = dots7(d, g, h)
        # safe divides: at exact convergence (g == 0) the reference would
        # trip ExcDivideByZero (bp5/solver.h:501); here alpha/beta collapse
        # to 0, the residual recurrence yields |g| = 0 and the loop exits.
        alpha = jnp.where(s0 != 0.0, s6 / jnp.where(s0 != 0.0, s0, 1.0), zero)
        # reduction-free |g + alpha h| (bp5/solver.h:504-505); clamp tiny
        # negative roundoff before the sqrt
        res = jnp.sqrt(jnp.maximum(s3 + 2.0 * alpha * s2 + alpha * alpha * s1, 0.0))
        beta = jnp.where(
            s6 != 0.0, alpha * (s4 + alpha * s5) / jnp.where(s6 != 0.0, s6, 1.0), zero
        )

        will_stop = jnp.logical_not(control.continue_pred(it, res, res0))
        a = alpha.astype(dt)

        if deferred_x_update:
            ratio = jnp.where(beta_prev != zero, alpha_prev / beta_prev, zero).astype(dt)

            def x_two_step(x):
                # x += (a + a_prev/b_prev) d + (a_prev/b_prev) diag g_old
                return x + (a + ratio) * d + ratio * (diag_a * g)

            def x_odd(x):
                # complete through it on early exit (update_c epilogue)
                return jax.lax.cond(
                    will_stop, lambda x: x + a * d, lambda x: x, x
                )

            x = jax.lax.cond(it % 2 == 0, x_two_step, x_odd, x)
        else:
            x = x + a * d  # update_a<true> (bp5/solver.h:74-104)

        g_new = g + a * h
        d_new = beta.astype(dt) * d - diag_a * g_new

        out = {
            "x": x,
            "g": g_new,
            "d": d_new,
            "alpha": alpha,
            "beta": beta,
            "it": it,
            "res": res,
        }
        return out

    state = {
        "x": x,
        "g": g,
        "d": d,
        "alpha": zero,
        "beta": zero,
        "it": jnp.int32(0),
        "res": res0,
    }
    state = jax.lax.while_loop(cond, body, state)
    return state["x"], {
        "n_iterations": state["it"],
        "res_norm": state["res"],
        "res0": res0,
    }
