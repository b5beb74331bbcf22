"""The configurations the removed fused kernels served, on the XLA backends
that now serve them, each against the dense oracle: BP1-BP4 Gauss rules
through ``separable``, mapped and graded meshes through ``structured``,
adaptive meshes through ``xla``, distributed BP3 through ``DistOperator``
on the 8-device CPU mesh, BP6 as three components. Removed backend names
raise."""

import jax.numpy as jnp
import numpy as np
import pytest

from deal_and_ceed_on_gpu_tpu import BrickMesh, FESpace, shear_map, sine_map
from deal_and_ceed_on_gpu_tpu.adaptive import AdaptiveMesh, AdaptivePoissonOperator, AdaptiveSpace
from deal_and_ceed_on_gpu_tpu.models import (
    HelmholtzOperator,
    MassOperator,
    PoissonOperator,
    make_bp_operator,
)
from deal_and_ceed_on_gpu_tpu.utils import oracle


def _u(n, seed=0, shape=()):
    return np.random.default_rng(seed).standard_normal(shape + (n,))


@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("bp,kind", [("bp1", "mass"), ("bp3", "stiffness")])
def test_bp_gauss_rule_separable_matches_oracle(bp, kind, p):
    """CEED BP1/BP3 (Gauss, q = p+2) through the separable backend."""
    mesh = BrickMesh((2, 1, 1), upper=(1.0, 0.7, 1.2))
    space, op = make_bp_operator(bp, mesh, p, dtype=jnp.float64, backend="separable")
    assert space.basis.n_q == p + 2
    A = oracle.assemble_sparse(mesh, space.basis, kind)
    u = _u(space.n_dofs, p)
    want = oracle.apply_constrained(A, mesh.boundary_dof_mask(p), u)
    got = np.asarray(op.vmult(jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("bp,kind", [("bp2", "mass"), ("bp4", "stiffness"), ("bp6", "stiffness")])
def test_vector_bp_separable_matches_oracle(bp, kind, p):
    """BP2/BP4/BP6: three components sharing the scalar form."""
    mesh = BrickMesh((2, 2, 1))
    space, op = make_bp_operator(bp, mesh, p, dtype=jnp.float64, backend="separable")
    A = oracle.assemble_sparse(mesh, space.basis, kind)
    mask = mesh.boundary_dof_mask(p)
    u = _u(space.n_dofs, 3, (3,))
    got = np.asarray(op.vmult(jnp.asarray(u)))
    assert got.shape == (3, space.n_dofs)
    for c in range(3):
        want = oracle.apply_constrained(A, mask, u[c])
        np.testing.assert_allclose(got[c], want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("deform", ["shear", "sine", "graded"])
def test_bp3_structured_on_deformed_meshes_matches_oracle(deform, p):
    """BP3 (Gauss q = p+2) on mapped and graded meshes through the
    structured cell loop, against the geometry-table oracle."""
    if deform == "graded":
        mesh = BrickMesh((3, 2, 2), widths=((0.2, 0.5, 0.3), (0.6, 0.4), (0.5, 0.5)))
    else:
        phi, jac = shear_map(0.3, 0.15, 0.2) if deform == "shear" else sine_map(0.04)
        mesh = BrickMesh((2, 2, 2)).deform(phi, jac)
    space = FESpace.create(mesh, p, n_q=p + 2, rule="gauss", dtype=jnp.float64)
    op = PoissonOperator(space, backend="structured")
    A = oracle.assemble_sparse_general(mesh, space.basis, "stiffness")
    u = _u(space.n_dofs, 7)
    want = oracle.apply_constrained(A, mesh.boundary_dof_mask(p), u)
    np.testing.assert_allclose(
        np.asarray(op.vmult(jnp.asarray(u))), want, rtol=1e-10, atol=1e-10 * np.abs(want).max()
    )


@pytest.mark.parametrize("pz,py,backend", [(2, 2, "separable"), (4, 2, "separable"), (2, 2, "structured"), (2, 4, "structured")])
def test_dist_bp3_matches_oracle(pz, py, backend):
    """Distributed BP3 (Gauss q = p+2) through DistOperator on the
    8-device CPU mesh, against the dense oracle."""
    from deal_and_ceed_on_gpu_tpu.parallel import (
        BlockPartition,
        DistOperator,
        make_device_mesh,
        make_dist_vmult,
    )

    p = 2
    mesh = BrickMesh((3, 3, 5))  # uneven against every shard count
    space = FESpace.create(mesh, p, n_q=p + 2, rule="gauss", dtype=jnp.float64)
    part = BlockPartition(mesh, p, pz=pz, py=py)
    dist = DistOperator(
        part, PoissonOperator, dtype=jnp.float64, backend=backend, rule="gauss", n_q=p + 2
    )
    A = oracle.assemble_sparse(mesh, space.basis, "stiffness")
    u = _u(space.n_dofs, 8)
    want = oracle.apply_constrained(A, mesh.boundary_dof_mask(p), u)
    f = make_dist_vmult(dist, make_device_mesh(pz, py))
    got = part.from_blocks(np.asarray(f(jnp.asarray(part.to_blocks(u.reshape(space.grid_shape))))))
    np.testing.assert_allclose(got.reshape(-1), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def test_adaptive_xla_helmholtz_is_poisson_plus_value_term():
    """The adaptive Helmholtz apply on the xla backend is the Poisson
    apply plus the collocated a(x) JxW value term."""
    from deal_and_ceed_on_gpu_tpu.adaptive import AdaptiveHelmholtzOperator

    space = AdaptiveSpace(AdaptiveMesh.refine(BrickMesh((2, 2, 2)), (0, 3)), 2)
    u = jnp.asarray(_u(space.n_dofs, 9))
    ones = lambda x: np.ones(x.shape[:-1])  # noqa: E731
    zero = lambda x: np.zeros(x.shape[:-1])  # noqa: E731
    pois = np.asarray(AdaptivePoissonOperator(space, backend="xla").vmult(u))
    h0 = np.asarray(AdaptiveHelmholtzOperator(space, a=zero, backend="xla").vmult(u))
    np.testing.assert_allclose(h0, pois, rtol=1e-13, atol=1e-13)
    h1 = np.asarray(AdaptiveHelmholtzOperator(space, a=ones, backend="xla").vmult(u))
    assert np.abs(h1 - pois).max() > 1e-6


@pytest.mark.parametrize("name", ["pallas", "pallas_general", "pallas_qgrid"])
@pytest.mark.parametrize("op_cls", [PoissonOperator, MassOperator, HelmholtzOperator])
def test_removed_backend_names_raise(op_cls, name):
    space = FESpace.create(BrickMesh((2, 2, 2)), 2, rule="gauss", dtype=jnp.float64)
    with pytest.raises(ValueError, match="unknown backend"):
        op_cls(space, backend=name)


@pytest.mark.parametrize("name", ["pallas", "pallas_general", "stencil"])
def test_dist_operator_rejects_kernel_backends(name):
    from deal_and_ceed_on_gpu_tpu.parallel import BlockPartition, DistOperator

    part = BlockPartition(BrickMesh((2, 2, 2)), 2, pz=2, py=1)
    with pytest.raises(ValueError, match="unsupported"):
        DistOperator(part, PoissonOperator, dtype=jnp.float64, backend=name)


def test_adaptive_removed_kernel_backend_raises():
    space = AdaptiveSpace(AdaptiveMesh.refine(BrickMesh((2, 2, 2)), (0,)), 2)
    with pytest.raises(ValueError, match="unknown adaptive backend"):
        AdaptivePoissonOperator(space, backend="pallas")
