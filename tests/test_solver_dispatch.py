"""Solver auto-jit dispatch (solvers/_dispatch.py).

Acceptance: repeated EAGER solve_cg / solve_cg_merged calls with the same
operator/control/preconditioner objects must not re-trace (the round-3
mapped-MG finding: each eager call re-traced + re-compiled the whole
while_loop); calls inside an existing trace inline and still produce
identical results.
"""

import jax
import jax.numpy as jnp
import numpy as np

from deal_and_ceed_on_gpu_tpu import (
    BrickMesh,
    FESpace,
    ReductionControl,
    solve_cg,
    solve_cg_merged,
)
from deal_and_ceed_on_gpu_tpu.models import PoissonOperator, assemble_rhs


def _setup():
    mesh = BrickMesh((3, 3, 3))
    space = FESpace.create(mesh, 2, rule="gauss_lobatto", dtype=jnp.float64)
    op = PoissonOperator(space, backend="separable")
    b = assemble_rhs(space, 1.0)
    return op, b


def test_eager_calls_trace_once():
    op, b = _setup()
    control = ReductionControl(200, tolerance=0.0, reduction=1e-10)
    traces = {"n": 0}

    def vmult(u):
        traces["n"] += 1  # Python side effect: counts TRACES, not applies
        return op.vmult(u)

    x1, _ = solve_cg_merged(vmult, b, control)
    first = traces["n"]
    assert first >= 1
    x2, _ = solve_cg_merged(vmult, b, control)
    assert traces["n"] == first, "second eager solve must hit the jit cache"
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))


def test_callable_preconditioner_cached():
    op, b = _setup()
    control = ReductionControl(200, tolerance=0.0, reduction=1e-10)
    dinv = op.jacobi_preconditioner()
    traces = {"n": 0}

    def precond(r):
        traces["n"] += 1
        return dinv * r

    x1, _ = solve_cg(op.vmult, b, control, diag=precond)
    first = traces["n"]
    x2, _ = solve_cg(op.vmult, b, control, diag=precond)
    assert traces["n"] == first
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))


def test_inline_under_user_jit_matches_eager():
    op, b = _setup()
    control = ReductionControl(200, tolerance=0.0, reduction=1e-10)
    x_eager, info_e = solve_cg_merged(op.vmult, b, control)
    x_jit, info_j = jax.jit(
        lambda b: solve_cg_merged(op.vmult, b, control)
    )(b)
    assert int(info_e["n_iterations"]) == int(info_j["n_iterations"])
    np.testing.assert_allclose(
        np.asarray(x_eager), np.asarray(x_jit), rtol=1e-12, atol=1e-14
    )


def test_distinct_controls_do_not_collide():
    op, b = _setup()
    c10 = ReductionControl(10, tolerance=0.0, reduction=1e-30)
    c20 = ReductionControl(20, tolerance=0.0, reduction=1e-30)
    _, i1 = solve_cg_merged(op.vmult, b, c10)
    _, i2 = solve_cg_merged(op.vmult, b, c20)
    assert int(i1["n_iterations"]) == 10
    assert int(i2["n_iterations"]) == 20
