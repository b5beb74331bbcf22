"""The Triton stencil kernel (``ops/stencil.py``): through the Pallas
interpreter on the CPU against the XLA separable apply, the dense oracle and
the structured cell loop; the wrapper's tiles, masks and tables; the models
that use it. Tests marked ``gpu`` run the compiled kernel on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deal_and_ceed_on_gpu_tpu import BrickMesh, FESpace, IterationNumberControl, solve_cg_merged
from deal_and_ceed_on_gpu_tpu.mesh import MappedMesh, shear_map
from deal_and_ceed_on_gpu_tpu.models import (
    HelmholtzOperator,
    PoissonOperator,
    assemble_rhs,
    make_bp_operator,
)
from deal_and_ceed_on_gpu_tpu.models.helmholtz import default_coefficient
from deal_and_ceed_on_gpu_tpu.ops import stencil
from deal_and_ceed_on_gpu_tpu.ops.stencil import StencilOperator, default_block
from deal_and_ceed_on_gpu_tpu.utils import oracle

TOL = {jnp.float32: 1e-5, jnp.float64: 1e-13}
GRADED = ((0.2, 0.5, 0.3), (0.6, 0.4), (0.1, 0.3, 0.4, 0.2))


def _u(space, seed=0):
    u = np.random.default_rng(seed).standard_normal(space.n_dofs)
    return jnp.asarray(u, space.dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _space(shape, p, dtype=jnp.float64, **mesh_kw):
    mesh = BrickMesh(shape, **mesh_kw)
    return FESpace.create(mesh, p, rule="gauss_lobatto", dtype=dtype)


# grids of m*p+1 points per axis: never a multiple of the 64-wide x tile
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("p", range(1, 9))
def test_stencil_matches_separable(stencil_interpret, p, dtype):
    space = _space((3, 2, 2), p, dtype, upper=(1.0, 0.8, 1.3))
    ref = PoissonOperator(space, backend="separable")
    op = PoissonOperator(space, backend="stencil")
    u = _u(space)
    got = jax.jit(op.vmult)(u)
    assert got.dtype == dtype and got.shape == u.shape
    assert _rel(got, ref.vmult(u)) <= TOL[dtype]


@pytest.mark.parametrize(
    "shape,p,graded",
    [((2, 2, 2), 2, False), ((1, 2, 1), 5, False), ((3, 2, 4), 2, True), ((3, 2, 4), 3, True)],
)
def test_stencil_matches_oracle(stencil_interpret, shape, p, graded):
    kw = dict(widths=GRADED) if graded else dict(upper=(1.0, 0.8, 1.3))
    space = _space(shape, p, **kw)
    mesh = space.mesh
    A = oracle.assemble_sparse(mesh, space.basis, "stiffness")
    u = _u(space, 1)
    want = oracle.apply_constrained(A, mesh.boundary_dof_mask(p), np.asarray(u))
    got = np.asarray(PoissonOperator(space, backend="stencil").vmult(u))
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("block", [(1, 1, 8), (2, 4, 8), (4, 2, 16), (8, 8, 32)])
def test_stencil_tiles_and_masks(stencil_interpret, block):
    """Many tiles per axis, partial tiles at every far face: the masked
    loads at tile borders agree with the separable apply."""
    space = _space((3, 4, 5), 3)
    op = StencilOperator(space.mesh, space.basis, jnp.float64)
    u = _u(space, 2)
    ref = PoissonOperator(space, backend="separable").vmult(u)
    got = stencil.stencil_apply(u, op.tables, op.shape, op.p, block=block)
    assert _rel(got, ref) <= 1e-13


def test_stencil_boundary_rows_copy_source(stencil_interpret):
    """Dirichlet rows are identity and constrained inputs are ignored:
    ``vmult`` semantics without a separate masking pass."""
    space = _space((2, 3, 2), 4)
    op = PoissonOperator(space, backend="stencil")
    u = _u(space, 3)
    mask = np.asarray(space.dirichlet_mask)
    out = np.asarray(op.vmult(u))
    np.testing.assert_array_equal(out[mask], np.asarray(u)[mask])
    u2 = jnp.where(space.dirichlet_mask, 7.0, u)
    np.testing.assert_allclose(np.asarray(op.vmult(u2))[~mask], out[~mask], rtol=1e-14)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_default_block(dtype):
    (bz, by, bx), warps = default_block(dtype)
    for b in (bz, by, bx, warps):
        assert b > 0 and b & (b - 1) == 0  # powers of two (Triton blocks)
    assert bx == 64  # contiguous x rows
    assert bz * by * bx * jnp.dtype(dtype).itemsize <= 8192 * 4


def test_stencil_tables_match_separable_terms():
    """The kernel's bands and weights are the separable path's factors."""
    from deal_and_ceed_on_gpu_tpu.ops.separable import poisson_terms

    space = _space((2, 3, 4), 2, widths=((0.3, 0.7), (0.2, 0.5, 0.3), (0.1, 0.2, 0.3, 0.4)))
    t = stencil.stencil_tables(space.mesh, space.basis, jnp.float64)
    terms = poisson_terms(space.mesh, space.basis, jnp.float64)
    x_term = terms[0]  # ax=2 (x): band on x, diag dz (x) dy
    np.testing.assert_allclose(
        np.asarray(x_term["diag"]),
        np.asarray(t["dz"])[:, None, None] * np.asarray(t["dy"])[None, :, None],
    )
    A1x = np.asarray(x_term["band"][0][1])
    bx = np.asarray(t["bx"])
    n = A1x.shape[0]
    for k in range(-2, 3):
        # bands[p+k, i] = A[i, i+k] for the rows i where i+k is in range
        rows = np.arange(max(0, -k), min(n, n - k))
        np.testing.assert_allclose(bx[2 + k][rows], A1x[rows, rows + k])
    assert t["v"] is None


def test_stencil_rejects_gauss_rule_and_mapped_mesh():
    gauss = FESpace.create(BrickMesh((2, 2, 2)), 2, rule="gauss", dtype=jnp.float64)
    with pytest.raises(ValueError, match="GLL collocation"):
        PoissonOperator(gauss, backend="stencil")
    phi, jac = shear_map(0.1)
    mapped = MappedMesh((2, 2, 2), mapping=phi, mapping_jacobian=jac)
    mspace = FESpace.create(mapped, 2, rule="gauss_lobatto", dtype=jnp.float64)
    with pytest.raises(ValueError, match="mapped"):
        PoissonOperator(mspace, backend="stencil")


def test_stencil_rejects_int32_overflow():
    t = {k: None for k in ("bz", "by", "bx", "dz", "dy", "dx", "v")}
    with pytest.raises(ValueError, match="2\\^31"):
        stencil.stencil_apply(jnp.zeros(8), t, (2048, 1024, 1024), 2, interpret=True)


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_helmholtz_stencil_matches_separable(stencil_interpret, p):
    space = _space((2, 3, 2), p, upper=(1.0, 0.8, 1.3))
    u = _u(space, 4)
    ref = HelmholtzOperator(space, backend="separable").vmult(u)
    got = HelmholtzOperator(space, backend="stencil").vmult(u)
    assert _rel(got, ref) <= 1e-13


def test_helmholtz_stencil_matches_oracle(stencil_interpret):
    space = _space((2, 2, 3), 2)
    mesh = space.mesh
    A = oracle.assemble_sparse(mesh, space.basis, "helmholtz", default_coefficient)
    u = _u(space, 5)
    want = oracle.apply_constrained(A, mesh.boundary_dof_mask(2), np.asarray(u))
    got = np.asarray(HelmholtzOperator(space, backend="stencil").vmult(u))
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)


def test_helmholtz_stencil_rejects_gauss_rule():
    space = FESpace.create(BrickMesh((2, 2, 2)), 2, rule="gauss", dtype=jnp.float64)
    with pytest.raises(ValueError, match="GLL collocation"):
        HelmholtzOperator(space, backend="stencil")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_stencil_merged_cg_matches_separable(stencil_interpret, dtype):
    space = _space((2, 2, 3), 3, dtype)
    b = assemble_rhs(space, 1.0)
    control = IterationNumberControl(30, 0.0)
    x_ref, _ = solve_cg_merged(PoissonOperator(space, backend="separable").vmult, b, control)
    x, info = solve_cg_merged(PoissonOperator(space, backend="stencil").vmult, b, control)
    assert int(info["n_iterations"]) == 30
    assert _rel(x, x_ref) <= (1e-4 if dtype == jnp.float32 else 1e-11)


def test_bp6_stencil_three_components_match_oracle(stencil_interpret):
    mesh = BrickMesh((2, 2, 2), upper=(1.0, 1.2, 0.9))
    space, op = make_bp_operator("bp6", mesh, 2, dtype=jnp.float64, backend="stencil")
    A = oracle.assemble_sparse(mesh, space.basis, "stiffness")
    mask = mesh.boundary_dof_mask(2)
    u = np.random.default_rng(6).standard_normal((3, space.n_dofs))
    got = np.asarray(op.vmult(jnp.asarray(u)))
    for c in range(3):
        np.testing.assert_allclose(
            got[c], oracle.apply_constrained(A, mask, u[c]), rtol=1e-11, atol=1e-11
        )


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("p", range(1, 9))
def test_stencil_compiled_matches_separable(gpu, p, dtype):
    """The compiled Triton kernel on the card against XLA separable at
    ``Precision.HIGHEST``."""
    space = _space((5, 4, 3), p, dtype)
    u = _u(space)
    got = jax.jit(PoissonOperator(space, backend="stencil").vmult)(u)
    ref = jax.jit(PoissonOperator(space, backend="separable").vmult)(u)
    assert _rel(got, ref) <= TOL[dtype]


@pytest.mark.gpu
def test_helmholtz_stencil_compiled_matches_separable(gpu):
    space = _space((4, 4, 4), 3)
    u = _u(space)
    got = jax.jit(HelmholtzOperator(space, backend="stencil").vmult)(u)
    ref = jax.jit(HelmholtzOperator(space, backend="separable").vmult)(u)
    assert _rel(got, ref) <= 1e-13
