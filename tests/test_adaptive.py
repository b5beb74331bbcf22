"""Hanging-node constraints on adaptive (2:1-refined) meshes.

Oracle: scipy assembly of the full non-conforming system + explicit
constraint matrix C; the matrix-free vmult must equal the condensed
``C^T A C`` application (the reference's ``resolve_hanging_nodes`` /
``constraint_mask`` semantics, ``bp5/fe_evaluation_gl.h:150-151,167-168``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from deal_and_ceed_on_gpu_tpu import BrickMesh, SolverControl, solve_cg_merged
from deal_and_ceed_on_gpu_tpu.adaptive import (
    AdaptiveMesh,
    AdaptivePoissonOperator,
    AdaptiveSpace,
    assemble_rhs_adaptive,
)
from deal_and_ceed_on_gpu_tpu.utils.oracle import element_matrix


def _space(shape=(2, 2, 2), marks=(0,), p=2):
    amesh = AdaptiveMesh.refine(BrickMesh(shape), marks)
    return AdaptiveSpace(amesh, p)


def _assemble_full(space):
    """Sparse stiffness over all active cells (no constraints)."""
    mesh, basis = space.mesh, space.basis
    rows, cols, vals = [], [], []
    base = BrickMesh((1, 1, 1))
    for e in range(mesh.n_cells):
        h = tuple(mesh.sizes[e])
        Ae = element_matrix(base, basis, "stiffness", h_cell=h)
        idx = space._dof_map_np[e]
        rows.append(np.repeat(idx, idx.size))
        cols.append(np.tile(idx, idx.size))
        vals.append(Ae.reshape(-1))
    n = space.n_dofs
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    ).tocsr()


def _oracle_vmult(space, A, u):
    """Reference semantics: zero constrained -> distribute (C) -> apply ->
    condense (C^T) -> identity on constrained rows."""
    C = space.constraint_matrix()
    mask = space.constrained_mask_np
    u1 = np.where(mask, 0.0, u)
    v = C.T @ (A @ (C @ u1))
    v = np.where(space.hanging_mask_np, 0.0, v)
    return np.where(mask, u, v)


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize(
    "shape,marks",
    [((2, 2, 2), (0,)), ((2, 2, 2), (0, 3)), ((2, 2, 1), (0, 1, 2))],
)
def test_adaptive_vmult_matches_oracle(shape, marks, p):
    space = _space(shape, marks, p)
    assert space.hanging_mask_np.sum() > 0, "test mesh must have hanging nodes"
    op = AdaptivePoissonOperator(space)
    A = _assemble_full(space)
    rng = np.random.default_rng(0)
    for _ in range(2):
        u = rng.standard_normal(space.n_dofs)
        want = _oracle_vmult(space, A, u)
        got = np.asarray(op.vmult(jnp.asarray(u)))
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)


def test_hanging_interpolation_exact_for_polynomials():
    """distribute() must reproduce any tensor polynomial of degree <= p
    exactly at the hanging nodes (the constraints ARE that interpolation)."""
    space = _space((2, 2, 2), (0, 1), p=3)
    x = space.node_coords

    def f(x):
        return (
            1.0
            + 2.0 * x[:, 0] ** 3
            - x[:, 1] ** 2 * x[:, 0]
            + 0.5 * x[:, 2] ** 3 * x[:, 1] ** 3
        )

    u = jnp.asarray(f(x))
    u_dist = np.asarray(space.distribute(u))
    np.testing.assert_allclose(u_dist, f(x), rtol=1e-12, atol=1e-12)


def test_adaptive_operator_is_symmetric():
    space = _space((2, 2, 1), (1,), p=2)
    op = AdaptivePoissonOperator(space)
    n = space.n_dofs
    M = np.column_stack(
        [np.asarray(op.vmult(jnp.eye(n, dtype=jnp.float64)[:, i])) for i in range(n)]
    )
    np.testing.assert_allclose(M, M.T, atol=1e-12)


def test_adaptive_solve_matches_direct():
    """Full pipeline: condensed RHS + merged CG on the adaptive operator ==
    sparse direct solve of the constrained system."""
    import scipy.sparse.linalg as spla

    space = _space((2, 2, 2), (0, 7), p=2)
    op = AdaptivePoissonOperator(space)
    A = _assemble_full(space)
    b = assemble_rhs_adaptive(space, 1.0)

    # effective matrix with identity on constrained rows
    C = space.constraint_matrix()
    mask = space.constrained_mask_np
    P = sp.diags((~mask).astype(float))
    Ic = sp.diags(mask.astype(float))
    A_eff = (P @ C.T @ A @ C @ P + Ic).tocsc()
    x_direct = spla.spsolve(A_eff, np.asarray(b))

    control = SolverControl(500, 1e-12 * float(jnp.linalg.norm(b)))
    x, info = solve_cg_merged(op.vmult, b, control)
    np.testing.assert_allclose(np.asarray(x), x_direct, rtol=1e-9, atol=1e-11)
    # the conforming solution is continuous: hanging values interpolate
    xd = np.asarray(space.distribute(x))
    Cx = C @ np.asarray(x)
    np.testing.assert_allclose(xd, Cx, rtol=1e-12, atol=1e-13)


def test_two_level_refinement_balanced_and_matches_oracle():
    """Multi-level: refine a cell, then one of its children; the 2:1
    balance step refines coarse neighbors automatically, and the chained
    hanging constraints still match the explicit C^T A C oracle."""
    amesh = AdaptiveMesh.refine(BrickMesh((2, 2, 2)), (0,))
    # refine the first child of cell 0 (level-1 cell) -> level 2 appears
    child = int(np.flatnonzero(amesh.levels == 1)[0])
    amesh2 = amesh.refine_active((child,))
    assert amesh2.is_balanced()
    assert amesh2.levels.max() == 2
    for p in (2, 3):
        space = AdaptiveSpace(amesh2, p)
        assert space.hanging_mask_np.sum() > 0
        op = AdaptivePoissonOperator(space)
        A = _assemble_full(space)
        u = np.random.default_rng(11).standard_normal(space.n_dofs)
        want = _oracle_vmult(space, A, u)
        got = np.asarray(op.vmult(jnp.asarray(u)))
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)


def test_two_level_polynomial_exactness_through_chains():
    """Chained constraints must still reproduce tensor polynomials of
    degree <= p exactly at every hanging node."""
    amesh = AdaptiveMesh.refine(BrickMesh((2, 2, 2)), (0, 1))
    child = int(np.flatnonzero(amesh.levels == 1)[0])
    amesh2 = amesh.refine_active((child,))
    space = AdaptiveSpace(amesh2, 2)
    x = space.node_coords

    def f(x):
        return 0.5 + x[:, 0] ** 2 - 2.0 * x[:, 1] * x[:, 2] + x[:, 2] ** 2 * x[:, 0]

    u_dist = np.asarray(space.distribute(jnp.asarray(f(x))))
    np.testing.assert_allclose(u_dist, f(x), rtol=1e-12, atol=1e-12)
    # no chain survives: every master of a hanging row is conforming
    assert not space.hanging_mask_np[np.asarray(space.hang_cols)].any()


def test_two_level_solve_matches_direct():
    import scipy.sparse.linalg as spla

    amesh = AdaptiveMesh.refine(BrickMesh((2, 2, 1)), (0,))
    child = int(np.flatnonzero(amesh.levels == 1)[3])
    amesh2 = amesh.refine_active((child,))
    space = AdaptiveSpace(amesh2, 2)
    op = AdaptivePoissonOperator(space)
    A = _assemble_full(space)
    b = assemble_rhs_adaptive(space, 1.0)
    C = space.constraint_matrix()
    mask = space.constrained_mask_np
    P = sp.diags((~mask).astype(float))
    Ic = sp.diags(mask.astype(float))
    A_eff = (P @ C.T @ A @ C @ P + Ic).tocsc()
    x_direct = spla.spsolve(A_eff, np.asarray(b))
    control = SolverControl(800, 1e-12 * float(jnp.linalg.norm(b)))
    x, info = solve_cg_merged(op.vmult, b, control)
    np.testing.assert_allclose(np.asarray(x), x_direct, rtol=1e-9, atol=1e-11)


def test_refined_everything_matches_uniform():
    """Refining EVERY cell gives a conforming mesh: no hanging nodes, and
    the solve matches the uniformly refined BrickMesh solve."""
    from deal_and_ceed_on_gpu_tpu import FESpace
    from deal_and_ceed_on_gpu_tpu.models import PoissonOperator, assemble_rhs

    p = 2
    space_a = _space((2, 2, 2), tuple(range(8)), p=p)
    assert space_a.hanging_mask_np.sum() == 0
    op_a = AdaptivePoissonOperator(space_a)
    b_a = assemble_rhs_adaptive(space_a, 1.0)

    mesh_u = BrickMesh((4, 4, 4))
    space_u = FESpace.create(mesh_u, p, dtype=jnp.float64)
    op_u = PoissonOperator(space_u, backend="structured")
    b_u = assemble_rhs(space_u, 1.0)

    control = SolverControl(500, 1e-12 * float(jnp.linalg.norm(b_u)))
    x_a, _ = solve_cg_merged(op_a.vmult, b_a, control)
    x_u, _ = solve_cg_merged(op_u.vmult, b_u, control)

    # same solution values at identical nodal coordinates
    coords_u = space_u.node_coords()
    order = {}
    for i, c in enumerate(np.round(np.asarray(space_a.node_coords) / 1e-9)):
        order[tuple(c.astype(np.int64))] = i
    perm = np.array(
        [order[tuple(c)] for c in np.round(coords_u / 1e-9).astype(np.int64)]
    )
    np.testing.assert_allclose(
        np.asarray(x_a)[perm], np.asarray(x_u), rtol=1e-9, atol=1e-11
    )


def test_adaptive_backend_auto_is_xla():
    """auto resolves to the einsum path, the only adaptive backend."""
    space = _space((2, 2, 2), (0,), p=2)
    assert AdaptivePoissonOperator(space, backend="auto").backend == "xla"
