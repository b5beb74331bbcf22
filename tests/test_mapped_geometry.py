"""General (non-diagonal Jacobian) geometry: mapped/deformed meshes.

Exercises the full 6-plane merged-coefficient contraction
(``bp5/step-64.cu:164-188``) that diagonal-Jacobian bricks never reach:
isoparametric Jacobian tables vs analytic maps, operator-vs-oracle on
sheared and smoothly deformed meshes, diagonals, solves, and validation
norms. Oracle: ``assemble_sparse_general`` (dense basis tables x geometry
tables — independent of the sum-factorization / gather-scatter paths).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla

from deal_and_ceed_on_gpu_tpu import (
    Basis1D,
    BrickMesh,
    FESpace,
    SolverControl,
    shear_map,
    sine_map,
    solve_cg_merged,
)
from deal_and_ceed_on_gpu_tpu.geometry import Geometry
from deal_and_ceed_on_gpu_tpu.models import (
    HelmholtzOperator,
    MassOperator,
    PoissonOperator,
    assemble_rhs,
    l2_norm_function,
)
from deal_and_ceed_on_gpu_tpu.models.helmholtz import default_coefficient
from deal_and_ceed_on_gpu_tpu.utils import oracle


def _sheared(shape=(2, 2, 2), s=(0.3, 0.15, 0.2)):
    phi, jac = shear_map(*s)
    return BrickMesh(shape).deform(phi, jac)


def _sine(shape=(2, 2, 2), amplitude=0.04):
    phi, jac = sine_map(amplitude)
    return BrickMesh(shape).deform(phi, jac)


def test_jacobian_exact_for_affine_map():
    """The degree-p isoparametric interpolant reproduces an affine map
    exactly: J = M @ diag(h) at every qpoint."""
    mesh = _sheared((3, 2, 2))
    basis = Basis1D.make(3, rule="gauss")
    geo = Geometry.from_mesh(mesh, basis)
    J = geo.jacobian_full()  # [E, n_q, 3, 3]
    M = np.array([[1.0, 0.3, 0.15], [0.0, 1.0, 0.2], [0.0, 0.0, 1.0]])
    hx, hy, hz = (1.0 / 3.0, 1.0 / 2.0, 1.0 / 2.0)
    J_exact = M @ np.diag([hx, hy, hz])
    np.testing.assert_allclose(J, np.broadcast_to(J_exact, J.shape), atol=1e-13)
    # dets positive and constant
    np.testing.assert_allclose(geo.det_q_full(), hx * hy * hz, rtol=1e-12)


def test_jacobian_converges_to_analytic_smooth_map():
    """For a smooth non-affine map the interpolated Jacobian converges to
    the analytic one with the mapping degree."""
    phi, jac = sine_map(0.05)
    errs = []
    for p in (2, 4):
        mesh = BrickMesh((2, 2, 2)).deform(phi, jac)
        basis = Basis1D.make(p, rule="gauss")
        geo = Geometry.from_mesh(mesh, basis)
        J = geo.jacobian_full()
        xq = geo.q_points_phys()
        # analytic: d phi/dX at the brick preimage of the qpoints, times
        # the brick Jacobian diag(h). The interpolated xq differ from the
        # exact map points at the same order, so evaluate at exact points.
        Xq = Geometry.from_mesh(BrickMesh((2, 2, 2)), basis).q_points_phys()
        J_exact = jac(Xq) * 0.5  # right-multiply by diag(h) = 0.5 I
        errs.append(np.abs(J - J_exact).max())
    assert errs[1] < errs[0] * 0.05, errs  # high-order convergence


def test_sine_map_coefficient_planes_all_nonzero():
    """The deformed mesh must actually exercise the off-diagonal merged
    planes."""
    geo = Geometry.from_mesh(_sine(), Basis1D.make(3, rule="gauss"))
    C = geo.merged_coef_full()  # [E, n_q, 6]
    for plane in range(6):
        assert np.abs(C[:, :, plane]).max() > 1e-4, f"plane {plane} is zero"


def test_general_oracle_matches_tensor_oracle_on_uniform_mesh():
    """Cross-validation of the new general oracle against the Kronecker
    oracle on a plain brick."""
    mesh = BrickMesh((2, 2, 2))
    for kind in ("stiffness", "mass"):
        basis = Basis1D.make(2, rule="gauss")
        A1 = oracle.assemble_sparse(mesh, basis, kind)
        A2 = oracle.assemble_sparse_general(mesh, basis, kind)
        np.testing.assert_allclose(A1.toarray(), A2.toarray(), atol=1e-13)


@pytest.mark.parametrize("backend", ["structured", "gather"])
@pytest.mark.parametrize("mesh_fn", [_sheared, _sine])
def test_poisson_vmult_matches_oracle_on_mapped_mesh(backend, mesh_fn):
    """vmult == assembled general oracle at 1e-11 (f64) on deformed
    meshes — the round-2 'general geometry' acceptance test."""
    mesh = mesh_fn((3, 2, 2))
    space = FESpace.create(mesh, 3, rule="gauss", dtype=jnp.float64)
    op = PoissonOperator(space, backend=backend)
    A = oracle.assemble_sparse_general(mesh, space.basis, "stiffness")
    mask = mesh.boundary_dof_mask(space.degree)
    rng = np.random.default_rng(7)
    for _ in range(2):
        u = rng.standard_normal(space.n_dofs)
        ref = oracle.apply_constrained(A, mask, u)
        out = np.asarray(op.vmult(jnp.asarray(u)))
        np.testing.assert_allclose(out, ref, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("rule,n_q", [("gauss", None), ("gauss_lobatto", None), ("gauss", 5)])
def test_poisson_mapped_quadrature_variants(rule, n_q):
    """Mapped geometry under GL collocation and rectangular q=p+2 rules."""
    mesh = _sine((2, 2, 2))
    space = FESpace.create(mesh, 3, n_q=n_q, rule=rule, dtype=jnp.float64)
    op = PoissonOperator(space, backend="structured")
    A = oracle.assemble_sparse_general(mesh, space.basis, "stiffness")
    mask = mesh.boundary_dof_mask(space.degree)
    u = np.random.default_rng(3).standard_normal(space.n_dofs)
    ref = oracle.apply_constrained(A, mask, u)
    np.testing.assert_allclose(
        np.asarray(op.vmult(jnp.asarray(u))), ref, rtol=1e-11, atol=1e-11
    )


@pytest.mark.parametrize("backend", ["structured", "gather"])
def test_helmholtz_vmult_matches_oracle_on_mapped_mesh(backend):
    mesh = _sheared((2, 2, 2))
    space = FESpace.create(mesh, 3, rule="gauss", dtype=jnp.float64)
    op = HelmholtzOperator(space, backend=backend)
    A = oracle.assemble_sparse_general(
        mesh, space.basis, "helmholtz", coefficient_fn=default_coefficient
    )
    mask = mesh.boundary_dof_mask(space.degree)
    u = np.random.default_rng(1).standard_normal(space.n_dofs)
    ref = oracle.apply_constrained(A, mask, u)
    np.testing.assert_allclose(
        np.asarray(op.vmult(jnp.asarray(u))), ref, rtol=1e-11, atol=1e-11
    )


def test_mass_vmult_matches_oracle_on_mapped_mesh():
    mesh = _sine((2, 2, 2))
    space = FESpace.create(mesh, 2, n_q=4, rule="gauss", dtype=jnp.float64)
    op = MassOperator(space, backend="structured")
    A = oracle.assemble_sparse_general(mesh, space.basis, "mass")
    mask = mesh.boundary_dof_mask(space.degree)
    u = np.random.default_rng(2).standard_normal(space.n_dofs)
    ref = oracle.apply_constrained(A, mask, u)
    np.testing.assert_allclose(
        np.asarray(op.vmult(jnp.asarray(u))), ref, rtol=1e-11, atol=1e-11
    )


def test_compute_diagonal_on_mapped_mesh():
    mesh = _sine((2, 2, 2))
    space = FESpace.create(mesh, 3, rule="gauss", dtype=jnp.float64)
    op = PoissonOperator(space, backend="structured")
    A = oracle.assemble_sparse_general(mesh, space.basis, "stiffness")
    mask = mesh.boundary_dof_mask(space.degree)
    A_eff = oracle.constrained_matrix(A, mask)
    np.testing.assert_allclose(
        np.asarray(op.compute_diagonal()), A_eff.diagonal(), rtol=1e-11, atol=1e-12
    )


def test_solve_on_mapped_mesh_matches_direct():
    """End to end: assemble_rhs + merged CG on a sheared mesh == sparse
    direct solve of the constrained general-oracle system."""
    mesh = _sheared((2, 2, 2))
    space = FESpace.create(mesh, 3, rule="gauss", dtype=jnp.float64)
    op = PoissonOperator(space, backend="structured")
    b = assemble_rhs(space, 1.0)
    A = oracle.assemble_sparse_general(mesh, space.basis, "stiffness")
    mask = mesh.boundary_dof_mask(space.degree)
    A_eff = oracle.constrained_matrix(A, mask)
    x_direct = spla.spsolve(A_eff.tocsc(), np.asarray(b))
    control = SolverControl(500, 1e-12 * float(jnp.linalg.norm(b)))
    x, info = solve_cg_merged(op.vmult, b, control, diag=op.jacobi_preconditioner())
    np.testing.assert_allclose(np.asarray(x), x_direct, rtol=1e-9, atol=1e-11)


def test_l2_norm_on_mapped_mesh():
    """Interpolate f(x) = x0 (linear, exactly representable) on a sheared
    mesh; its L2 norm over the deformed domain has a closed form."""
    s = (0.3, 0.15, 0.2)
    mesh = _sheared((3, 3, 3), s)
    space = FESpace.create(mesh, 2, rule="gauss", dtype=jnp.float64)
    u = space.node_coords()[:, 0]  # f(x) = x component
    norm = float(l2_norm_function(space, jnp.asarray(u)))
    # int over brick of (X + a Y + b Z)^2 dX dY dZ (det = 1), closed form:
    # squares integrate to 1/3, every cross term to 1/4
    a, b = s[0], s[1]
    exact = np.sqrt((1 + a * a + b * b) / 3.0 + (a + b + a * b) / 2.0)
    np.testing.assert_allclose(norm, exact, rtol=1e-12)


def test_assemble_rhs_on_mapped_mesh_partition_of_unity():
    """sum_i b_i over ALL dofs (unconstrained) = integral of f over the
    deformed domain = volume * f for constant f (partition of unity)."""
    phi, jac = sine_map(0.03)
    mesh = BrickMesh((3, 3, 3)).deform(phi, jac)
    space = FESpace.create(mesh, 3, rule="gauss", dtype=jnp.float64)
    # bypass the Dirichlet zeroing: integrate via the oracle-independent path
    from deal_and_ceed_on_gpu_tpu.models.operator_base import MatrixFreeOperator
    from deal_and_ceed_on_gpu_tpu.ops import sum_factorization as sf

    op = MatrixFreeOperator(space, "structured")
    integrand = jnp.asarray(op.jxw_layout(), dtype=space.dtype)
    integrand = jnp.broadcast_to(integrand, (3, 4, 3, 4, 3, 4))
    vl = sf.integrate(integrand, None, space.S, space.D, op.axes, False)
    b = op.scatter(vl)
    volume = float(jnp.sum(b))
    # volume of the deformed domain via dense numerical quadrature of det J
    geo = space.geometry
    vol_exact = float(np.sum(geo.jxw_full()))
    np.testing.assert_allclose(volume, vol_exact, rtol=1e-12)
    # and the sine map is volume-preserving to high order at small amplitude
    np.testing.assert_allclose(vol_exact, 1.0, atol=5e-3)


def test_refine_global_preserves_mapping():
    mesh = _sheared((1, 1, 1)).refine_global(2)
    assert mesh.is_mapped and mesh.n_elements == (4, 4, 4)
    space = FESpace.create(mesh, 1, rule="gauss", dtype=jnp.float64)
    op = PoissonOperator(space, backend="structured")
    A = oracle.assemble_sparse_general(mesh, space.basis, "stiffness")
    mask = mesh.boundary_dof_mask(1)
    u = np.random.default_rng(5).standard_normal(space.n_dofs)
    np.testing.assert_allclose(
        np.asarray(op.vmult(jnp.asarray(u))),
        oracle.apply_constrained(A, mask, u),
        rtol=1e-11,
        atol=1e-11,
    )


def test_separable_backend_rejects_mapped_mesh():
    mesh = _sheared((2, 2, 2))
    space = FESpace.create(mesh, 2, dtype=jnp.float64)
    with pytest.raises(ValueError, match="tensor-product"):
        PoissonOperator(space, backend="separable")
