"""BP registry, vector operators, and true Jacobi diagonals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deal_and_ceed_on_gpu_tpu import (
    BrickMesh,
    FESpace,
    SolverControl,
    solve_cg,
    solve_cg_merged,
)
from deal_and_ceed_on_gpu_tpu.models import (
    HelmholtzOperator,
    MassOperator,
    PoissonOperator,
    assemble_rhs,
    make_bp_operator,
)
from deal_and_ceed_on_gpu_tpu.models.helmholtz import default_coefficient
from deal_and_ceed_on_gpu_tpu.utils import oracle


@pytest.mark.parametrize("bp", ["bp1", "bp2", "bp3", "bp4", "bp5", "bp6"])
def test_bp_registry_builds_and_applies(bp):
    mesh = BrickMesh((2, 2, 2))
    space, op = make_bp_operator(bp, mesh, 2, dtype=jnp.float64)
    if hasattr(op, "n_components") and op.n_components > 1:
        u = jnp.asarray(
            np.random.default_rng(0).standard_normal((3, space.n_dofs))
        )
        out = op.vmult(u)
        assert out.shape == (3, space.n_dofs)
        # components are independent and identical forms
        for c in range(3):
            np.testing.assert_allclose(
                np.asarray(out[c]),
                np.asarray(op.scalar_op.vmult(u[c])),
                rtol=1e-13,
            )
    else:
        u = jnp.asarray(np.random.default_rng(0).standard_normal(space.n_dofs))
        assert op.vmult(u).shape == (space.n_dofs,)


def test_vector_cg_solves():
    mesh = BrickMesh((2, 2, 2))
    space, op = make_bp_operator("bp6", mesh, 2, dtype=jnp.float64)
    b1 = assemble_rhs(space, 1.0)
    b = jnp.stack([b1, 2.0 * b1, -b1])
    control = SolverControl(300, 1e-10)
    x, info = solve_cg_merged(op.vmult, b, control)
    x1, _ = solve_cg_merged(op.scalar_op.vmult, b1, control)
    np.testing.assert_allclose(np.asarray(x[0]), np.asarray(x1), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(x[1]), 2 * np.asarray(x1), rtol=1e-8)


@pytest.mark.parametrize(
    "make,kind,kw",
    [
        (PoissonOperator, "stiffness", {}),
        (MassOperator, "mass", {}),
    ],
)
def test_compute_diagonal_matches_oracle(make, kind, kw):
    mesh = BrickMesh((2, 2, 3), upper=(1.0, 0.8, 1.5))
    p = 3
    space = FESpace.create(mesh, p, rule="gauss", dtype=jnp.float64)
    op = make(space, **kw)
    A = oracle.assemble_sparse(mesh, space.basis, kind)
    mask = mesh.boundary_dof_mask(p)
    want = oracle.constrained_matrix(A, mask).diagonal()
    got = np.asarray(op.compute_diagonal())
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_helmholtz_diagonal_matches_oracle():
    mesh = BrickMesh.hyper_cube().refine_global(1)
    p = 3
    space = FESpace.create(mesh, p, rule="gauss", dtype=jnp.float64)
    op = HelmholtzOperator(space)
    A = oracle.assemble_sparse(mesh, space.basis, "helmholtz", default_coefficient)
    mask = mesh.boundary_dof_mask(p)
    want = oracle.constrained_matrix(A, mask).diagonal()
    got = np.asarray(op.compute_diagonal())
    np.testing.assert_allclose(got, want, rtol=1e-11)


def test_jacobi_preconditioner_reduces_iterations():
    """True Jacobi must not be worse than identity on the Helmholtz system
    (where the varying coefficient makes the diagonal non-trivial)."""
    mesh = BrickMesh.hyper_cube().refine_global(1)
    space = FESpace.create(mesh, 3, rule="gauss", dtype=jnp.float64)
    op = HelmholtzOperator(space)
    b = assemble_rhs(space, 1.0)
    control = SolverControl(2000, 1e-10 * float(jnp.linalg.norm(b)))
    _, info_id = solve_cg(op.vmult, b, control)
    _, info_jac = solve_cg(op.vmult, b, control, diag=op.jacobi_preconditioner())
    assert int(info_jac["n_iterations"]) <= int(info_id["n_iterations"])
    # both converged to the same solution
