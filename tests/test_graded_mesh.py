"""Graded tensor-product meshes: the generality extension beyond uniform
bricks that keeps every fast path intact (Jacobians stay diagonal and
every geometric factor separates per axis)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deal_and_ceed_on_gpu_tpu import BrickMesh, FESpace, SolverControl, solve_cg_merged
from deal_and_ceed_on_gpu_tpu.models import (
    HelmholtzOperator,
    MassOperator,
    PoissonOperator,
    assemble_rhs,
)
from deal_and_ceed_on_gpu_tpu.models.helmholtz import default_coefficient
from deal_and_ceed_on_gpu_tpu.utils import oracle


def _graded_mesh():
    # boundary-layer-style grading in x, geometric in y, uniform z
    bx = np.array([0.0, 0.05, 0.15, 0.4, 1.0])
    by = np.array([0.0, 0.3, 0.75, 1.2])
    bz = np.linspace(0.0, 1.0, 4)
    return BrickMesh.graded(bx, by, bz)


def test_graded_mesh_basics():
    mesh = _graded_mesh()
    assert not mesh.is_uniform
    hx, hy, hz = mesh.h_axes()
    np.testing.assert_allclose(hx, [0.05, 0.1, 0.25, 0.6])
    with pytest.raises(ValueError):
        _ = mesh.h
    r = mesh.refine_global(1)
    np.testing.assert_allclose(r.h_axes()[0][:2], [0.025, 0.025])
    assert r.n_elements == (8, 6, 6)


@pytest.mark.parametrize("backend", ["structured", "gather", "separable"])
@pytest.mark.parametrize("p,rule,nq", [(2, "gauss_lobatto", None), (3, "gauss", None), (2, "gauss", 4)])
def test_graded_poisson_matches_oracle(backend, p, rule, nq):
    mesh = _graded_mesh()
    space = FESpace.create(mesh, p, n_q=nq, rule=rule, dtype=jnp.float64)
    op = PoissonOperator(space, backend=backend)
    A = oracle.assemble_sparse(mesh, space.basis, "stiffness")
    mask = mesh.boundary_dof_mask(p)
    u = jnp.asarray(np.random.default_rng(0).standard_normal(space.n_dofs))
    got = np.asarray(jax.jit(op.vmult)(u))
    want = oracle.apply_constrained(A, mask, np.asarray(u))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("backend", ["structured", "separable"])
def test_graded_mass_matches_oracle(backend):
    mesh = _graded_mesh()
    space = FESpace.create(mesh, 2, rule="gauss", n_q=4, dtype=jnp.float64)
    op = MassOperator(space, backend=backend)
    A = oracle.assemble_sparse(mesh, space.basis, "mass")
    mask = mesh.boundary_dof_mask(2)
    u = jnp.asarray(np.random.default_rng(1).standard_normal(space.n_dofs))
    got = np.asarray(op.vmult(u))
    want = oracle.apply_constrained(A, mask, np.asarray(u))
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)


def test_graded_helmholtz_matches_oracle():
    mesh = _graded_mesh()
    p = 3
    space = FESpace.create(mesh, p, rule="gauss", dtype=jnp.float64)
    op = HelmholtzOperator(space)
    A = oracle.assemble_sparse(mesh, space.basis, "helmholtz", default_coefficient)
    mask = mesh.boundary_dof_mask(p)
    u = jnp.asarray(np.random.default_rng(2).standard_normal(space.n_dofs))
    got = np.asarray(op.vmult(u))
    want = oracle.apply_constrained(A, mask, np.asarray(u))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_graded_solve_and_diagonal():
    mesh = _graded_mesh()
    space = FESpace.create(mesh, 2, rule="gauss_lobatto", dtype=jnp.float64)
    op = PoissonOperator(space, backend="separable")
    # diagonal matches oracle
    A = oracle.assemble_sparse(mesh, space.basis, "stiffness")
    mask = mesh.boundary_dof_mask(2)
    want_d = oracle.constrained_matrix(A, mask).diagonal()
    np.testing.assert_allclose(np.asarray(op.compute_diagonal()), want_d, rtol=1e-12)
    # Jacobi-preconditioned merged CG converges to the direct solution
    import scipy.sparse.linalg as spla

    b = assemble_rhs(space, 1.0)
    x_direct = spla.spsolve(oracle.constrained_matrix(A, mask).tocsc(), np.asarray(b))
    control = SolverControl(800, 1e-12 * float(jnp.linalg.norm(b)))
    x, info = solve_cg_merged(op.vmult, b, control, diag=op.jacobi_preconditioner())
    np.testing.assert_allclose(np.asarray(x), x_direct, rtol=1e-8, atol=1e-11)
