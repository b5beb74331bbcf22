"""fold_scale: in-place operator rescaling used by the chained-vmult
benchmarks (drivers fold the 1/lambda normalization into the coefficient
tables so each benchmark iteration is one pure apply)."""

import jax.numpy as jnp
import numpy as np
import pytest

from deal_and_ceed_on_gpu_tpu import BrickMesh, FESpace
from deal_and_ceed_on_gpu_tpu.models import MassOperator, PoissonOperator
from deal_and_ceed_on_gpu_tpu.models.vector import VectorOperator


@pytest.mark.parametrize("backend", ["structured", "gather", "separable", "stencil"])
def test_poisson_fold_scale(stencil_interpret, backend):
    mesh = BrickMesh((2, 3, 2))
    space = FESpace.create(mesh, 2, rule="gauss_lobatto", dtype=jnp.float64)
    u = jnp.asarray(np.random.default_rng(0).standard_normal(space.n_dofs))

    op = PoissonOperator(space, backend=backend)
    before = np.asarray(op.vmult(u))
    op.fold_scale(0.25)
    after = np.asarray(op.vmult(u))

    mask = np.asarray(space.mesh.boundary_dof_mask(space.degree))
    # identity (constrained) rows unaffected, the rest scaled by s
    np.testing.assert_allclose(after[mask], before[mask], rtol=0, atol=0)
    np.testing.assert_allclose(after[~mask], 0.25 * before[~mask], rtol=1e-14)


@pytest.mark.parametrize("backend", ["structured", "gather"])
def test_fold_scale_keeps_diagonal_consistent(backend):
    """compute_diagonal/jacobi_preconditioner after fold_scale must reflect
    the scaled operator (advisor r2: a Jacobi/MG preconditioner built from
    a folded operator was silently wrong by the fold factor)."""
    from deal_and_ceed_on_gpu_tpu.models import HelmholtzOperator

    mesh = BrickMesh((2, 2, 2))
    space = FESpace.create(mesh, 2, rule="gauss", dtype=jnp.float64)
    for op_cls in (PoissonOperator, HelmholtzOperator):
        op = op_cls(space, backend=backend)
        d_before = np.asarray(op.compute_diagonal())
        op.fold_scale(0.5)
        d_after = np.asarray(op.compute_diagonal())
        mask = np.asarray(space.mesh.boundary_dof_mask(space.degree))
        np.testing.assert_allclose(d_after[mask], d_before[mask], rtol=0, atol=0)
        np.testing.assert_allclose(d_after[~mask], 0.5 * d_before[~mask], rtol=1e-14)
        # the preconditioner matches the scaled operator's true diagonal
        u = jnp.asarray(np.random.default_rng(2).standard_normal(space.n_dofs))
        e0 = jnp.zeros(space.n_dofs).at[len(u) // 2].set(1.0)
        true_diag_entry = float(op.vmult(e0)[len(u) // 2])
        np.testing.assert_allclose(
            d_after[len(u) // 2], true_diag_entry, rtol=1e-12
        )


@pytest.mark.parametrize("backend", ["structured", "separable"])
def test_mass_and_vector_fold_scale(backend):
    mesh = BrickMesh((2, 2, 2))
    space = FESpace.create(mesh, 2, n_q=4, rule="gauss", dtype=jnp.float64)
    op = VectorOperator(MassOperator(space, backend=backend), 3)
    u = jnp.asarray(
        np.random.default_rng(1).standard_normal((3, space.n_dofs))
    )
    before = np.asarray(op.vmult(u))
    op.fold_scale(3.0)
    after = np.asarray(op.vmult(u))
    mask = np.asarray(space.mesh.boundary_dof_mask(space.degree))
    np.testing.assert_allclose(after[:, mask], before[:, mask], rtol=0, atol=0)
    # table-side scaling is not bitwise identical to output-side scaling
    np.testing.assert_allclose(
        after[:, ~mask], 3.0 * before[:, ~mask], rtol=1e-13, atol=1e-16
    )


def test_fold_scale_invalidates_solver_cache():
    """Eager solves are jit-cached by operator IDENTITY; fold_scale mutates
    the tables in place, so it must drop the cache — a second eager solve
    on the mutated operator has to solve the SCALED system, not replay the
    executable built from the old tables."""
    from deal_and_ceed_on_gpu_tpu import PoissonOperator, SolverControl, solve_cg
    from deal_and_ceed_on_gpu_tpu.models import assemble_rhs

    mesh = BrickMesh((3, 3, 3))
    space = FESpace.create(mesh, 2, dtype=jnp.float64)
    op = PoissonOperator(space, backend="structured")
    b = assemble_rhs(space, 1.0)
    control = SolverControl(300, 1e-12)
    x1, _ = solve_cg(op.vmult, b, control)  # populates the jit cache
    op.fold_scale(2.0)
    x2, _ = solve_cg(op.vmult, b, control)  # must NOT hit the stale entry
    np.testing.assert_allclose(
        np.asarray(x2), 0.5 * np.asarray(x1), rtol=1e-9, atol=1e-12
    )
