import jax.numpy as jnp
import numpy as np
import pytest

from deal_and_ceed_on_gpu_tpu.mesh import BrickMesh
from deal_and_ceed_on_gpu_tpu.ops import local_global as lg


@pytest.mark.parametrize("m,p", [(1, 1), (3, 2), (4, 5), (7, 3)])
def test_split_join_axis_roundtrip(m, p):
    n = m * p + 1
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((2, n, 3)))
    s = lg.split_axis(u, 1, m, p)
    assert s.shape == (2, m, p + 1, 3)
    # gathered values must equal u at e*p + i
    for e in range(m):
        np.testing.assert_array_equal(
            np.asarray(s[:, e]), np.asarray(u[:, e * p : e * p + p + 1])
        )
    # join of the gathered field must equal u weighted by multiplicity
    j = lg.join_axis(s, 1, p)
    mult = np.ones(n)
    mult[p:-1:p] = 2.0 if m > 1 else mult[p:-1:p]
    np.testing.assert_allclose(np.asarray(j), np.asarray(u) * mult[None, :, None], atol=1e-14)


@pytest.mark.parametrize("shape,p", [((2, 2, 2), 1), ((2, 3, 1), 3), ((2, 2, 2), 5)])
def test_structured_matches_indexed(shape, p):
    """The index-free structured gather/scatter must agree exactly with the
    explicit local_to_global table."""
    mesh = BrickMesh(shape)
    n = mesh.n_dofs(p)
    dm = jnp.asarray(mesh.element_dof_map(p))
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.standard_normal(n))

    g_idx = lg.gather_indexed(u, dm, p)  # [E, p1, p1, p1]
    g_str = lg.gather_structured(u.reshape(mesh.n_nodes(p)[::-1]), mesh.n_elements, p)
    # interleaved [mz,p1,my,p1,mx,p1] -> [E,p1(k),p1(j),p1(i)]
    mx, my, mz = mesh.n_elements
    g_str_b = jnp.moveaxis(
        g_str.reshape(mz, p + 1, my, p + 1, mx, p + 1), (1, 3, 5), (3, 4, 5)
    ).reshape(mesh.n_cells, p + 1, p + 1, p + 1)
    np.testing.assert_array_equal(np.asarray(g_idx), np.asarray(g_str_b))

    v = rng.standard_normal(g_idx.shape)
    s_idx = lg.scatter_indexed(jnp.asarray(v), dm, n)
    v_il = jnp.moveaxis(
        jnp.asarray(v).reshape(mz, my, mx, p + 1, p + 1, p + 1), (3, 4, 5), (1, 3, 5)
    )
    s_str = lg.scatter_structured(v_il, p).reshape(-1)
    np.testing.assert_allclose(np.asarray(s_idx), np.asarray(s_str), atol=1e-13)


def test_scatter_plan_matches_raw_scatter():
    """The presorted segment-sum scatter (the sorted alternative for
    duplicate-index scatter-add) is bit-compatible with scatter_indexed
    up to summation order (exact for these magnitudes)."""
    import numpy as np

    from deal_and_ceed_on_gpu_tpu.ops import local_global as lg

    rng = np.random.default_rng(8)
    n_dofs, E, p1 = 500, 64, 3
    emap = rng.integers(0, n_dofs, (E, p1**3)).astype(np.int32)
    v = rng.standard_normal((E, p1, p1, p1))
    want = np.asarray(lg.scatter_indexed(jnp.asarray(v), jnp.asarray(emap), n_dofs))
    plan = lg.make_scatter_plan(emap, n_dofs)
    got = np.asarray(lg.scatter_indexed_sorted(jnp.asarray(v), plan, n_dofs))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-14)
