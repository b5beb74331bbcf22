"""Distributed CG solves: the whole solver loop runs SPMD inside shard_map.

Composition of ``solvers.cg*`` with :class:`DistOperator`: each iteration
is (local fused update) -> (local cell loop + plane ppermutes) -> (7 local
dots + ONE stacked psum over both mesh axes). Scalar recurrences are
computed redundantly on every device — the equivalent of the
reference's "7-double allreduce then host scalar math"
(``bp5/solver.h:488-533``), with no host in the loop at all.

The jitted shard-mapped solver is built ONCE per (operator, control, mesh)
and cached on the operator, so repeated timed solves pay zero Python
retracing (matching the warm-up pattern of the single-chip driver paths).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..solvers.cg import solve_cg
from ..solvers.cg_merged import solve_cg_merged
from ..solvers.control import SolverControl
from .dist_operator import DistOperator

__all__ = [
    "solve_cg_merged_dist",
    "solve_cg_dist",
    "make_device_mesh",
    "make_dist_solver",
    "make_dist_vmult",
]


def make_device_mesh(
    pz: int,
    py: int = 1,
    axis_z: str = "z",
    axis_y: str = "y",
    px: int = 1,
    axis_x: str = "x",
) -> Mesh:
    """A ``pz x py`` 2D device mesh (1D z-slabs when ``py == 1``), or a
    full 3D ``pz x py x px`` mesh when ``px > 1``, over the first devices
    in ``jax.devices()`` order (on NVLink every card reaches every other
    at the same rate, so the mesh shape follows the decomposition
    alone)."""
    devs = np.asarray(jax.devices()[: pz * py * px])
    if px > 1:
        return Mesh(devs.reshape(pz, py, px), (axis_z, axis_y, axis_x))
    return Mesh(devs.reshape(pz, py), (axis_z, axis_y))


def _axes(part) -> tuple:
    """The partitioned device-mesh axis names (2D or 3D)."""
    if getattr(part, "px", 1) > 1:
        return (part.axis_z, part.axis_y, part.axis_x)
    return (part.axis_z, part.axis_y)


def _mesh_for(dist_op: DistOperator, mesh: Optional[Mesh]) -> Mesh:
    part = dist_op.part
    return mesh or make_device_mesh(
        part.pz, part.py, part.axis_z, part.axis_y, part.px, part.axis_x
    )


def _table_specs(dist_op: DistOperator):
    part = dist_op.part
    return tuple(
        P(_axes(part), *([None] * (t.ndim - 1)))
        for t in dist_op.shard_tables
    )


def _grid_spec(dist_op: DistOperator) -> P:
    """Operand spec: [nz, ny, nx] blocks, or [C, nz, ny, nx] for
    vector-valued operators (components replicated-free leading axis)."""
    part = dist_op.part
    ax = part.axis_x if getattr(part, "px", 1) > 1 else None
    if getattr(dist_op, "n_components", 1) > 1:
        return P(None, part.axis_z, part.axis_y, ax)
    return P(part.axis_z, part.axis_y, ax)


def make_dist_solver(
    solver_fn,
    dist_op: DistOperator,
    control: SolverControl,
    mesh: Optional[Mesh] = None,
    with_diag: bool = False,
    **kwargs,
):
    """Build the jitted SPMD solver ``run(b_flat[, diag_flat]) ->
    (x_flat, info)`` on ``flat_grid_shape`` operands; cached on the
    operator."""
    mesh = _mesh_for(dist_op, mesh)
    key = (solver_fn, control, mesh, with_diag, tuple(sorted(kwargs.items())))
    cached = dist_op._solver_cache.get(key)
    if cached is not None:
        return cached

    part = dist_op.part
    axes = _axes(part)
    grid_spec = _grid_spec(dist_op)

    def local_solve(b_loc, diag_loc, *tables):
        w = dist_op.dot_weight(b_loc.dtype)
        x, info = solver_fn(
            lambda u: dist_op.vmult_local(u, *tables),
            b_loc,
            control,
            diag=diag_loc,
            dot_weight=w,
            psum_axis=axes,
            **kwargs,
        )
        # scalars are already replicated (post-psum recurrences)
        return x, info["n_iterations"], info["res_norm"], info["res0"]

    if with_diag:
        jitted = jax.jit(
            jax.shard_map(
                local_solve,
                mesh=mesh,
                in_specs=(grid_spec, grid_spec) + _table_specs(dist_op),
                out_specs=(grid_spec, P(), P(), P()),
            )
        )

        def run(b_flat, diag_flat):
            x, it, res, res0 = jitted(b_flat, diag_flat, *dist_op.shard_tables)
            return x, {"n_iterations": it, "res_norm": res, "res0": res0}

    else:
        jitted = jax.jit(
            jax.shard_map(
                lambda b_loc, *tables: local_solve(b_loc, None, *tables),
                mesh=mesh,
                in_specs=(grid_spec,) + _table_specs(dist_op),
                out_specs=(grid_spec, P(), P(), P()),
            )
        )

        def run(b_flat):
            x, it, res, res0 = jitted(b_flat, *dist_op.shard_tables)
            return x, {"n_iterations": it, "res_norm": res, "res0": res0}

    dist_op._solver_cache[key] = run
    return run


def make_dist_vmult(dist_op: DistOperator, mesh: Optional[Mesh] = None):
    """Jitted SPMD operator apply on ``flat_grid_shape`` arrays (the
    distributed 'vmult' benchmark mode; cached)."""
    mesh = _mesh_for(dist_op, mesh)
    key = ("vmult", mesh)
    cached = dist_op._solver_cache.get(key)
    if cached is not None:
        return cached
    grid_spec = _grid_spec(dist_op)
    shmapped = jax.shard_map(
        dist_op.vmult_local,
        mesh=mesh,
        in_specs=(grid_spec,) + _table_specs(dist_op),
        out_specs=grid_spec,
    )
    fn = jax.jit(lambda u: shmapped(u, *dist_op.shard_tables))
    dist_op._solver_cache[key] = fn
    return fn


def _coerce_flat(dist_op: DistOperator, b_stacked: jnp.ndarray) -> jnp.ndarray:
    shape = dist_op.part.flat_grid_shape
    if getattr(dist_op, "n_components", 1) > 1:
        shape = (dist_op.n_components,) + shape
    return jnp.asarray(b_stacked).reshape(shape)


def solve_cg_merged_dist(
    dist_op: DistOperator,
    b_stacked: jnp.ndarray,
    control: SolverControl,
    mesh: Optional[Mesh] = None,
    diag_stacked: Optional[jnp.ndarray] = None,
    **kwargs,
):
    """b_stacked: ghosted blocks, any shape reshapeable to
    ``part.flat_grid_shape`` (see ``BlockPartition.to_blocks``/``to_slabs``).
    Returns ``(x_flat, info)``."""
    run = make_dist_solver(
        solve_cg_merged, dist_op, control, mesh, diag_stacked is not None, **kwargs
    )
    b = _coerce_flat(dist_op, b_stacked)
    if diag_stacked is not None:
        return run(b, _coerce_flat(dist_op, diag_stacked))
    return run(b)


def solve_cg_dist(
    dist_op: DistOperator,
    b_stacked: jnp.ndarray,
    control: SolverControl,
    mesh: Optional[Mesh] = None,
    diag_stacked: Optional[jnp.ndarray] = None,
    **kwargs,
):
    run = make_dist_solver(
        solve_cg, dist_op, control, mesh, diag_stacked is not None, **kwargs
    )
    b = _coerce_flat(dist_op, b_stacked)
    if diag_stacked is not None:
        return run(b, _coerce_flat(dist_op, diag_stacked))
    return run(b)
