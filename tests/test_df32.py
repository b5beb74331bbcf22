"""f32x2 extended-precision applies (ops/df32.py) vs the f64 oracle.

The bar: kernel-path vmult <= 1e-12 relative
error against the f64 operator — the reference's precision
(``bp5/step-64.cu:206``) without any f64 arithmetic in the apply.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deal_and_ceed_on_gpu_tpu import BrickMesh, FESpace
from deal_and_ceed_on_gpu_tpu.models import (
    HelmholtzOperator,
    MassOperator,
    PoissonOperator,
)
from deal_and_ceed_on_gpu_tpu.ops.df32 import (
    DF32SeparableOperator,
    df_add,
    df_mul,
    pack_df,
    two_prod,
    two_sum,
    unpack_df,
)


def test_primitives_error_free():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal(1000), jnp.float32)
    b = jnp.asarray(rng.standard_normal(1000) * 1e3, jnp.float32)
    s, e = jax.jit(two_sum)(a, b)
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64), exact
    )
    p, e = jax.jit(two_prod)(a, b)
    exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    np.testing.assert_array_equal(
        np.asarray(p, np.float64) + np.asarray(e, np.float64), exact
    )


def test_df_arithmetic_accuracy():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(4096)
    y = rng.standard_normal(4096) * 10.0
    xd, yd = pack_df(x), pack_df(y)
    np.testing.assert_allclose(unpack_df(xd), x, rtol=3e-15)
    prod = unpack_df(
        jnp.stack(jax.jit(lambda a, b: df_mul((a[0], a[1]), (b[0], b[1])))(xd, yd))
    )
    np.testing.assert_allclose(prod, x * y, rtol=1e-13, atol=1e-16)
    tot = unpack_df(
        jnp.stack(jax.jit(lambda a, b: df_add((a[0], a[1]), (b[0], b[1])))(xd, yd))
    )
    # absolute error stays at the ~2^-48*|operand| representation limit;
    # RELATIVE error is unbounded under cancellation (inherent to any
    # finite representation, f64 included at its own scale)
    np.testing.assert_allclose(tot, x + y, rtol=1e-12, atol=2e-13)


def _f64_oracle(space, kind, value_const=None):
    if kind == "stiffness":
        return PoissonOperator(space, backend="separable")
    if kind == "mass":
        return MassOperator(space, backend="separable")
    return HelmholtzOperator(
        space,
        backend="separable",
        coefficient_fn=lambda x: np.full(x.shape[:-1], value_const),
    )


@pytest.mark.parametrize(
    "shape,p,rule,n_q,kind,graded",
    [
        ((5, 4, 6), 3, "gauss_lobatto", 4, "stiffness", False),
        ((4, 3, 5), 5, "gauss_lobatto", 6, "stiffness", True),
        ((4, 5, 3), 3, "gauss", 5, "stiffness", False),
        ((3, 4, 5), 2, "gauss", 4, "mass", True),
        ((4, 4, 4), 4, "gauss", 6, "mass", False),
    ],
)
def test_df32_vmult_matches_f64_oracle(shape, p, rule, n_q, kind, graded):
    if graded:
        rng = np.random.default_rng(7)
        mesh = BrickMesh.graded(
            *[np.cumsum(np.concatenate([[0.0], 0.5 + rng.random(m)])) for m in shape]
        )
    else:
        mesh = BrickMesh(shape)
    space = FESpace.create(mesh, p, n_q=n_q, rule=rule, dtype=jnp.float64)
    oracle = _f64_oracle(space, kind)
    op = DF32SeparableOperator(space, kind=kind)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(space.n_dofs)
    y_ref = np.asarray(oracle.vmult(jnp.asarray(x)))
    y = op.vmult(x)
    err = np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)
    assert err <= 1e-12, err
    # and plain f32 would NOT meet the bar (sanity: the test is sharp)
    space32 = FESpace.create(mesh, p, n_q=n_q, rule=rule, dtype=jnp.float32)
    op32 = _f64_oracle(space32, kind)
    y32 = np.asarray(op32.vmult(jnp.asarray(x, jnp.float32)), np.float64)
    err32 = np.linalg.norm(y32 - y_ref) / np.linalg.norm(y_ref)
    assert err32 > 1e-8, err32


def test_df32_helmholtz_const_shift():
    mesh = BrickMesh((4, 5, 4))
    space = FESpace.create(mesh, 3, n_q=4, rule="gauss_lobatto", dtype=jnp.float64)
    c = 7.5
    oracle = _f64_oracle(space, "helmholtz", c)
    op = DF32SeparableOperator(space, kind="helmholtz", value_const=c)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(space.n_dofs)
    y_ref = np.asarray(oracle.vmult(jnp.asarray(x)))
    err = np.linalg.norm(op.vmult(x) - y_ref) / np.linalg.norm(y_ref)
    assert err <= 1e-12, err


def test_df32_chained_applies_stay_f64_grade():
    """10 chained applies (normalized each step) keep <= 1e-11 vs the
    identically-chained f64 oracle — accuracy does not decay multiplicatively."""
    mesh = BrickMesh((4, 4, 4))
    space = FESpace.create(mesh, 5, n_q=6, rule="gauss_lobatto", dtype=jnp.float64)
    oracle = _f64_oracle(space, "stiffness")
    op = DF32SeparableOperator(space)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(space.n_dofs)
    x /= np.linalg.norm(x)
    xr = jnp.asarray(x)
    xd = pack_df(x)
    # eager on CPU: XLA:CPU's LLVM pipeline miscompiles fused EFT chains
    # (see ops/df32.py); the jitted path is asserted on-chip by
    # scripts/bench_f32x2.py
    step = op.vmult_df
    for _ in range(10):
        xr = oracle.vmult(xr)
        xr = xr / jnp.linalg.norm(xr)
        xd = step(xd)
        v = unpack_df(xd)
        xd = pack_df(v / np.linalg.norm(v))
    err = np.linalg.norm(unpack_df(xd) - np.asarray(xr)) / np.linalg.norm(xr)
    assert err <= 1e-11, err


def test_df32_fold_scale_stays_f64_grade():
    """fold_scale rescales in f64 on the host tables and re-splits, so
    the scaled operator is still accurate to ~2^-48 (the benchmark
    chained-apply path)."""
    mesh = BrickMesh((4, 4, 4))
    space = FESpace.create(mesh, 3, n_q=4, rule="gauss_lobatto", dtype=jnp.float64)
    oracle = _f64_oracle(space, "stiffness")
    op = DF32SeparableOperator(space)
    s = 1.0 / 37.3
    op.fold_scale(s)
    oracle.fold_scale(s)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(space.n_dofs)
    y_ref = np.asarray(oracle.vmult(jnp.asarray(x)))
    err = np.linalg.norm(op.vmult(x) - y_ref) / np.linalg.norm(y_ref)
    assert err <= 1e-12, err


def test_df32_dirichlet_identity_rows():
    mesh = BrickMesh((3, 3, 3))
    space = FESpace.create(mesh, 3, n_q=4, rule="gauss_lobatto", dtype=jnp.float64)
    op = DF32SeparableOperator(space)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(space.n_dofs)
    y = op.vmult(x)
    m = np.asarray(space.dirichlet_mask)
    np.testing.assert_allclose(y[m], x[m], rtol=1e-13)
