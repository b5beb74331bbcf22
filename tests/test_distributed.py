"""Distributed (shard_map over 8 virtual CPU devices) vs single-device:
the reference's 'same binary at any rank count' property (SURVEY.md 4.3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deal_and_ceed_on_gpu_tpu import (
    BrickMesh,
    FESpace,
    IterationNumberControl,
    SolverControl,
    solve_cg_merged,
)
from deal_and_ceed_on_gpu_tpu.models import PoissonOperator, assemble_rhs
from deal_and_ceed_on_gpu_tpu.parallel import (
    DistPoissonOperator,
    SlabPartition,
    solve_cg_merged_dist,
)
from deal_and_ceed_on_gpu_tpu.parallel.dist_solve import make_device_mesh


def _setup(p=2, shape=(2, 2, 4), n_shards=2):
    mesh = BrickMesh(shape)
    space = FESpace.create(mesh, p, dtype=jnp.float64)
    part = SlabPartition(mesh, p, n_shards)
    return mesh, space, part


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_slab_roundtrip(n_shards):
    mesh, space, part = _setup(n_shards=n_shards, shape=(2, 2, 4))
    rng = np.random.default_rng(0)
    u = rng.standard_normal(space.grid_shape)
    slabs = part.to_slabs(u)
    # ghost plane of shard k == first plane of shard k+1
    for k in range(n_shards - 1):
        np.testing.assert_array_equal(slabs[k][-1], slabs[k + 1][0])
    np.testing.assert_array_equal(part.from_slabs(slabs), u)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_dist_vmult_matches_single(n_shards):
    p = 2
    mesh, space, part = _setup(p=p, shape=(2, 3, 8), n_shards=n_shards)
    op = PoissonOperator(space, backend="structured")
    dist_op = DistPoissonOperator(part, dtype=jnp.float64)

    rng = np.random.default_rng(1)
    u = rng.standard_normal(space.grid_shape)
    want = np.asarray(op.vmult(jnp.asarray(u.reshape(-1)))).reshape(space.grid_shape)

    devmesh = make_device_mesh(n_shards)
    nzl, ny, nx = part.local_grid_shape
    u_flat = jnp.asarray(part.to_slabs(u).reshape(n_shards * nzl, ny, nx))
    from jax.sharding import PartitionSpec as P

    f = jax.jit(
        jax.shard_map(
            dist_op.vmult_local,
            mesh=devmesh,
            in_specs=P("z", "y", None),
            out_specs=P("z", "y", None),
        )
    )
    got_slabs = np.asarray(f(u_flat)).reshape(n_shards, nzl, ny, nx)
    # duplicated planes must agree bitwise between neighbors
    for k in range(n_shards - 1):
        np.testing.assert_array_equal(got_slabs[k][-1], got_slabs[k + 1][0])
    got = part.from_slabs(got_slabs)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pz,py", [(2, 2), (4, 2), (2, 4), (1, 4)])
def test_dist_vmult_2d_blocks_matches_single(pz, py):
    """(z, y) block decomposition: two plane ppermutes, shared-edge sums
    across four diagonal neighbors."""
    from deal_and_ceed_on_gpu_tpu.parallel import (
        BlockPartition,
        DistOperator,
        make_device_mesh,
        make_dist_vmult,
    )

    p = 2
    mesh = BrickMesh((2, 4, 4))
    space = FESpace.create(mesh, p, dtype=jnp.float64)
    part = BlockPartition(mesh, p, pz=pz, py=py)
    op = PoissonOperator(space, backend="structured")
    dist_op = DistOperator(part, dtype=jnp.float64)

    rng = np.random.default_rng(2)
    u = rng.standard_normal(space.grid_shape)
    want = np.asarray(op.vmult(jnp.asarray(u.reshape(-1)))).reshape(space.grid_shape)

    f = make_dist_vmult(dist_op, make_device_mesh(pz, py))
    got = part.from_blocks(np.asarray(f(jnp.asarray(part.to_blocks(u)))))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pz,shape_z", [(2, 3), (4, 5), (8, 3), (3, 7)])
def test_dist_vmult_uneven_shards(pz, shape_z):
    """Any shard count divides any mesh: dead-element padding past the
    physical (Dirichlet) boundary is exact."""
    from deal_and_ceed_on_gpu_tpu.parallel import (
        BlockPartition,
        DistOperator,
        make_device_mesh,
        make_dist_vmult,
    )

    p = 2
    mesh = BrickMesh((2, 2, shape_z))
    space = FESpace.create(mesh, p, dtype=jnp.float64)
    part = BlockPartition(mesh, p, pz=pz)
    op = PoissonOperator(space, backend="structured")
    dist_op = DistOperator(part, dtype=jnp.float64)

    rng = np.random.default_rng(3)
    u = rng.standard_normal(space.grid_shape)
    want = np.asarray(op.vmult(jnp.asarray(u.reshape(-1)))).reshape(space.grid_shape)
    f = make_dist_vmult(dist_op, make_device_mesh(pz))
    got = part.from_blocks(np.asarray(f(jnp.asarray(part.to_blocks(u)))))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_dist_helmholtz_cg_matches_single():
    """Distributed operator breadth: the step-64 Helmholtz operator (whose
    a(x) coefficient table is position-dependent, fed per shard as a
    sharded operand) solves identically to the single-device path."""
    from deal_and_ceed_on_gpu_tpu import ReductionControl
    from deal_and_ceed_on_gpu_tpu.models import HelmholtzOperator
    from deal_and_ceed_on_gpu_tpu.parallel import (
        BlockPartition,
        DistOperator,
        make_device_mesh,
    )

    p = 3
    mesh = BrickMesh((2, 3, 3))
    space = FESpace.create(mesh, p, rule="gauss", dtype=jnp.float64)
    op = HelmholtzOperator(space, backend="structured")
    b = assemble_rhs(space, 1.0)
    control = ReductionControl(500, tolerance=0.0, reduction=1e-10)
    x_single, info_single = solve_cg_merged(op.vmult, b, control)

    part = BlockPartition(mesh, p, pz=2, py=2)
    dist_op = DistOperator(
        part, HelmholtzOperator, dtype=jnp.float64, backend="structured", rule="gauss"
    )
    b_blocks = jnp.asarray(part.to_blocks(np.asarray(b).reshape(space.grid_shape)))
    x_blocks, info = solve_cg_merged_dist(
        dist_op, b_blocks, control, mesh=make_device_mesh(2, 2)
    )
    assert int(info["n_iterations"]) == int(info_single["n_iterations"])
    x = part.from_blocks(np.asarray(x_blocks))
    np.testing.assert_allclose(
        x.reshape(-1), np.asarray(x_single), rtol=1e-10, atol=1e-12
    )


def test_dist_cg_2d_uneven_with_jacobi():
    """Full stack: 2D blocks + uneven extents + true-Jacobi diag operand."""
    from deal_and_ceed_on_gpu_tpu.parallel import (
        BlockPartition,
        DistOperator,
        make_device_mesh,
    )

    p = 2
    mesh = BrickMesh((2, 3, 5))
    space = FESpace.create(mesh, p, dtype=jnp.float64)
    op = PoissonOperator(space)
    b = assemble_rhs(space, 1.0)
    control = SolverControl(300, 1e-10)
    diag = op.jacobi_preconditioner()
    x_single, info_single = solve_cg_merged(op.vmult, b, control, diag=diag)

    part = BlockPartition(mesh, p, pz=4, py=2)
    dist_op = DistOperator(part, dtype=jnp.float64)
    b_blocks = jnp.asarray(part.to_blocks(np.asarray(b).reshape(space.grid_shape)))
    diag_blocks = dist_op.jacobi_blocks()
    x_blocks, info = solve_cg_merged_dist(
        dist_op,
        b_blocks,
        control,
        mesh=make_device_mesh(4, 2),
        diag_stacked=diag_blocks,
    )
    assert int(info["n_iterations"]) == int(info_single["n_iterations"])
    x = part.from_blocks(np.asarray(x_blocks))
    np.testing.assert_allclose(
        x.reshape(-1), np.asarray(x_single), rtol=1e-10, atol=1e-12
    )


def test_dist_vector_operator_matches_single():
    """Vector-valued (BP6-style, 3 components sharing metric terms)
    distributed solve == single-device VectorOperator solve."""
    from deal_and_ceed_on_gpu_tpu.models import VectorOperator
    from deal_and_ceed_on_gpu_tpu.parallel import (
        BlockPartition,
        DistOperator,
        make_device_mesh,
    )

    p = 2
    mesh = BrickMesh((2, 3, 5))
    space = FESpace.create(mesh, p, dtype=jnp.float64)
    scalar_op = PoissonOperator(space)
    vop = VectorOperator(scalar_op, 3)
    b1 = assemble_rhs(space, 1.0)
    rng = np.random.default_rng(4)
    scale = jnp.asarray(rng.uniform(0.5, 2.0, size=(3, 1)))
    b = scale * b1[None, :]  # distinct RHS per component
    control = SolverControl(300, 1e-10)
    x_single, info_single = solve_cg_merged(vop.vmult, b, control)

    part = BlockPartition(mesh, p, pz=2, py=2)
    dist_op = DistOperator(part, dtype=jnp.float64, n_components=3)
    b_blocks = jnp.asarray(part.to_blocks(np.asarray(b)))
    x_blocks, info = solve_cg_merged_dist(
        dist_op, b_blocks, control, mesh=make_device_mesh(2, 2)
    )
    assert int(info["n_iterations"]) == int(info_single["n_iterations"])
    x = part.from_blocks(np.asarray(x_blocks))
    np.testing.assert_allclose(
        x.reshape(3, -1), np.asarray(x_single), rtol=1e-10, atol=1e-12
    )


@pytest.mark.parametrize("mesh_kind", ["mapped", "graded"])
def test_dist_poisson_on_nonuniform_mesh(mesh_kind):
    """Distributed geometry breadth: mapped (full non-diagonal Jacobians)
    and graded meshes run via per-shard sliced global coefficient tables;
    solve matches single-device exactly."""
    from deal_and_ceed_on_gpu_tpu import sine_map
    from deal_and_ceed_on_gpu_tpu.parallel import (
        BlockPartition,
        DistOperator,
        make_device_mesh,
    )

    p = 2
    if mesh_kind == "mapped":
        phi, jac = sine_map(0.04)
        mesh = BrickMesh((2, 3, 5)).deform(phi, jac)
    else:
        mesh = BrickMesh.graded(
            np.linspace(0, 1, 3), [0.0, 0.2, 0.5, 1.0], np.linspace(0, 1, 6) ** 1.3
        )
    space = FESpace.create(mesh, p, rule="gauss", dtype=jnp.float64)
    op = PoissonOperator(space, backend="structured")
    b = assemble_rhs(space, 1.0)
    control = SolverControl(400, 1e-10)
    x_single, info_single = solve_cg_merged(op.vmult, b, control)

    part = BlockPartition(mesh, p, pz=2, py=2)
    dist_op = DistOperator(
        part, PoissonOperator, dtype=jnp.float64, backend="structured", rule="gauss"
    )
    b_blocks = jnp.asarray(part.to_blocks(np.asarray(b).reshape(space.grid_shape)))
    x_blocks, info = solve_cg_merged_dist(
        dist_op, b_blocks, control, mesh=make_device_mesh(2, 2)
    )
    assert int(info["n_iterations"]) == int(info_single["n_iterations"])
    x = part.from_blocks(np.asarray(x_blocks))
    # rtol 4e-9 not 1e-10: the single-device baseline runs under the
    # solver jit cache (solvers/_dispatch.py) while the distributed solve
    # traces through shard_map — different fusion orders legitimately
    # differ by a few ulps-of-the-solve around the 1e-10 residual target
    np.testing.assert_allclose(
        x.reshape(-1), np.asarray(x_single), rtol=4e-9, atol=1e-12
    )


def test_dist_helmholtz_on_mapped_mesh():
    from deal_and_ceed_on_gpu_tpu import shear_map
    from deal_and_ceed_on_gpu_tpu.models import HelmholtzOperator
    from deal_and_ceed_on_gpu_tpu.parallel import (
        BlockPartition,
        DistOperator,
        make_device_mesh,
    )

    p = 2
    phi, jac = shear_map(0.2, 0.1, 0.15)
    mesh = BrickMesh((2, 2, 5)).deform(phi, jac)
    space = FESpace.create(mesh, p, rule="gauss", dtype=jnp.float64)
    op = HelmholtzOperator(space, backend="structured")
    b = assemble_rhs(space, 1.0)
    control = SolverControl(400, 1e-10)
    x_single, info_single = solve_cg_merged(op.vmult, b, control)

    part = BlockPartition(mesh, p, pz=4)
    dist_op = DistOperator(
        part, HelmholtzOperator, dtype=jnp.float64, backend="structured", rule="gauss"
    )
    b_blocks = jnp.asarray(part.to_blocks(np.asarray(b).reshape(space.grid_shape)))
    x_blocks, info = solve_cg_merged_dist(
        dist_op, b_blocks, control, mesh=make_device_mesh(4)
    )
    assert int(info["n_iterations"]) == int(info_single["n_iterations"])
    x = part.from_blocks(np.asarray(x_blocks))
    np.testing.assert_allclose(
        x.reshape(-1), np.asarray(x_single), rtol=1e-10, atol=1e-12
    )


def test_dist_solver_is_cached():
    """The jitted SPMD solver is built once and reused (no per-call
    retracing in timed loops)."""
    from deal_and_ceed_on_gpu_tpu.parallel import make_dist_solver
    from deal_and_ceed_on_gpu_tpu.parallel.dist_solve import make_device_mesh

    mesh, space, part = _setup(n_shards=2, shape=(2, 2, 4))
    dist_op = DistPoissonOperator(part, dtype=jnp.float64)
    control = SolverControl(50, 1e-10)
    devmesh = make_device_mesh(2)
    r1 = make_dist_solver(solve_cg_merged, dist_op, control, devmesh)
    r2 = make_dist_solver(solve_cg_merged, dist_op, control, devmesh)
    assert r1 is r2


@pytest.mark.parametrize("n_shards", [2, 4])
def test_dist_merged_cg_matches_single(n_shards):
    p = 2
    mesh, space, part = _setup(p=p, shape=(2, 2, 4), n_shards=n_shards)
    op = PoissonOperator(space)
    b = assemble_rhs(space, 1.0)
    control = SolverControl(300, 1e-10)

    x_single, info_single = solve_cg_merged(op.vmult, b, control)

    dist_op = DistPoissonOperator(part, dtype=jnp.float64)
    b_stacked = jnp.asarray(part.to_slabs(np.asarray(b).reshape(space.grid_shape)))
    x_stacked, info = solve_cg_merged_dist(dist_op, b_stacked, control)

    assert int(info["n_iterations"]) == int(info_single["n_iterations"])
    x = part.from_slabs(np.asarray(x_stacked))
    np.testing.assert_allclose(
        x.reshape(-1), np.asarray(x_single), rtol=1e-10, atol=1e-12
    )


