"""Distributed fast-diagonalization (FDM) solver: shard transposes.

The single-device FDM (solvers/fdm.py) solves the separable BP5 system
exactly with six dense 1D eigenvector sweeps + one diagonal scale. Under
the (z, y) block decomposition the z/y sweeps are dense contractions
ACROSS shards — the answer is the classic distributed-spectral
transpose: ``all_to_all`` the x axis against the partitioned axis so each
shard holds FULL z (resp. y) for an x chunk, sweep locally, transpose
back. Eight ``all_to_all``s per apply (4 forward, 4 inverse), each moving
the field once between devices — the same data-movement shape as a distributed
3D FFT Poisson solver.

Implementation notes:
- Sweeps run on the full padded grid with *block-extended* eigenvector
  matrices (identity on boundary/dead rows, the interior eigenbasis in
  the middle), so every layout stays rectangular; boundary rows are
  restored from ``r`` at the end exactly like the single-device
  ``FDMSolver.apply``.
- Each shard transforms only its OWNED planes (the ghost-duplicated last
  plane per axis is dropped on entry and refilled from the owning
  neighbor with one plane ``ppermute`` per axis on exit — y first, then
  z carrying the corner, bit-identical to the owner's copy).
- x is padded to a multiple of lcm(pz, py) so both transposes chunk it
  evenly; padded lanes ride identity rows and are sliced off.

Uniform and graded tensor global meshes (same scope as FDMSolver).
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..fe_space import FESpace
from ..ops.separable import _axis_tables
from ..ops.sum_factorization import sweep
from ..solvers.cg import solve_cg
from ..solvers.control import SolverControl
from .dist_operator import DistOperator
from .dist_solve import make_device_mesh
from .partition import BlockPartition

__all__ = ["DistFDM", "solve_cg_fdm_dist"]


def _extended(V: np.ndarray, n_pad: int) -> np.ndarray:
    """[n_pad, n_pad] identity with the interior eigenbasis ``V``
    (``[n-2, n-2]``) in rows/cols ``1 : n-1``."""
    E = np.eye(n_pad)
    n_int = V.shape[0]
    E[1 : 1 + n_int, 1 : 1 + n_int] = V
    return E


class DistFDM:
    """SPMD exact FDM solve / preconditioner over a :class:`BlockPartition`.

    ``apply_local`` acts on a ghosted local block ``[nzl, nyl, nx]``
    inside ``shard_map`` (same contract as ``DistOperator.vmult_local``).
    """

    def __init__(self, part: BlockPartition, dtype=jnp.float64, rule="gauss_lobatto",
                 n_q: Optional[int] = None):
        if part.mesh.is_mapped:
            raise ValueError("FDM requires a tensor-product (separable) mesh")
        if part.px > 1:
            raise ValueError(
                "DistFDM transposes the x axis against the z/y shard axes "
                "(all_to_all spectral path) and requires the x axis "
                "UNPARTITIONED — use px=1 (same device count via pz*py)"
            )
        self.part = part
        p = part.degree
        space = FESpace.create(part.mesh, p, n_q=n_q, rule=rule, dtype=dtype)
        self.dtype = jnp.dtype(dtype)
        nz, ny, nx = part.global_grid_shape
        sz, sy = part.mz_local * p, part.my_local * p
        Nz, Ny = part.pz * sz, part.py * sy
        chunk = math.lcm(part.pz, part.py)
        nxp = -(-nx // chunk) * chunk
        self._sz, self._sy, self._nx, self._nxp = sz, sy, nx, nxp

        tabs = _axis_tables(part.mesh, space.basis)
        evecs, evals = [], []
        for ax in (0, 1, 2):
            A1 = tabs[ax]["A1"][1:-1, 1:-1]
            if space.basis.collocation:
                B = np.diag(tabs[ax]["d"][1:-1])
            else:
                B = tabs[ax]["B"][1:-1, 1:-1]
            lam, V = scipy.linalg.eigh(A1, B)
            evals.append(lam)
            evecs.append(V)
        lz, ly, lx = evals
        # extended (padded full-grid) eigen matrices; boundary/dead = identity
        self._Vz = jnp.asarray(_extended(evecs[0], Nz), self.dtype)
        self._Vy = jnp.asarray(_extended(evecs[1], Ny), self.dtype)
        self._Vx = jnp.asarray(_extended(evecs[2], nxp), self.dtype)
        # diagonal scale on the padded owned layout, sliced per shard:
        # 1 everywhere except the physical-interior box
        inv = np.ones((Nz, Ny, nxp))
        inv[1 : nz - 1, 1 : ny - 1, 1 : nx - 1] = 1.0 / (
            lz[:, None, None] + ly[None, :, None] + lx[None, None, :]
        )
        stacks = []
        for iz in range(part.pz):
            for iy in range(part.py):
                stacks.append(inv[iz * sz : (iz + 1) * sz, iy * sy : (iy + 1) * sy])
        self.inv_stack = jnp.asarray(np.stack(stacks), self.dtype)  # operand
        self._solver_cache = {}

    # ------------------------- transposed sweeps ------------------------ #
    def _axis_sweep(self, u, Vmat, mesh_axis, n_shards, transpose):
        """Sweep the partitioned leading axis 0 of ``u`` with the FULL
        ``Vmat`` via an all_to_all transpose against x chunks."""
        if n_shards == 1:
            return sweep(u, Vmat.T if transpose else Vmat, 0)
        s, ny_, nxp = u.shape
        # [s, ny, nshards, nxp/nshards] -> full axis [nshards*s, ny, nxp/n]
        t = u.reshape(s, ny_, n_shards, nxp // n_shards)
        t = lax.all_to_all(t, mesh_axis, split_axis=2, concat_axis=0, tiled=False)
        # all_to_all(tiled=False) stacks: [nshards, s, ny, nxp/n]
        t = t.reshape(n_shards * s, ny_, nxp // n_shards)
        t = sweep(t, Vmat.T if transpose else Vmat, 0)
        t = t.reshape(n_shards, s, ny_, nxp // n_shards)
        t = lax.all_to_all(t, mesh_axis, split_axis=0, concat_axis=3, tiled=True)
        return t.reshape(s, ny_, nxp)

    def _transform(self, u, transpose):
        """V^T (transpose=True) or V (False) along all three axes, on the
        owned padded layout [sz, sy, nxp]."""
        part = self.part
        uz = self._axis_sweep(u, self._Vz, part.axis_z, part.pz, transpose)
        uy = jnp.moveaxis(
            self._axis_sweep(
                jnp.moveaxis(uz, 1, 0), self._Vy, part.axis_y, part.py, transpose
            ),
            0,
            1,
        )
        return sweep(uy, self._Vx.T if transpose else self._Vx, 2)

    # ----------------------------- apply ------------------------------- #
    def apply_local(self, r: jnp.ndarray, inv_own: jnp.ndarray) -> jnp.ndarray:
        """Per-shard FDM apply on a ghosted block; ``inv_own`` is this
        shard's slice of :attr:`inv_stack` (leading length-1 axis from
        shard_map allowed)."""
        part = self.part
        sz, sy, nx, nxp = self._sz, self._sy, self._nx, self._nxp
        inv_own = inv_own.reshape(sz, sy, nxp)
        u = jnp.pad(r[:sz, :sy, :], ((0, 0), (0, 0), (0, nxp - nx)))
        t = self._transform(u, transpose=True)
        t = t * inv_own
        out_own = self._transform(t, transpose=False)[:, :, :nx]

        # refill ghost planes from their owners (y first; the subsequent z
        # permute carries the corner): bit-identical to the owner's copy
        nzl, nyl, _ = r.shape
        out = jnp.zeros_like(r).at[:sz, :sy, :].set(out_own)
        if part.py > 1:
            down_y = [(k + 1, k) for k in range(part.py - 1)]
            ghost_y = lax.ppermute(out[:sz, :1, :], part.axis_y, down_y)
            out = out.at[:sz, sy : sy + 1, :].set(ghost_y)
        if part.pz > 1:
            down_z = [(k + 1, k) for k in range(part.pz - 1)]
            ghost_z = lax.ppermute(out[:1, :, :], part.axis_z, down_z)
            out = out.at[sz : sz + 1, :, :].set(ghost_z)

        iz = lax.axis_index(part.axis_z)
        iy = lax.axis_index(part.axis_y)
        mask = part.local_dirichlet_mask(iz, iy)
        return jnp.where(mask, r, out)

    # --------------------------- entry points --------------------------- #
    def _spec(self):
        part = self.part
        return P(part.axis_z, part.axis_y, None)

    def solve_direct(self, b_stacked: jnp.ndarray, mesh: Optional[Mesh] = None):
        """Exact distributed direct solve (one SPMD FDM apply)."""
        part = self.part
        mesh = mesh or make_device_mesh(part.pz, part.py, part.axis_z, part.axis_y)
        key = ("direct", mesh)
        run = self._solver_cache.get(key)
        if run is None:
            jitted = jax.jit(
                jax.shard_map(
                    self.apply_local,
                    mesh=mesh,
                    in_specs=(self._spec(), P((part.axis_z, part.axis_y))),
                    out_specs=self._spec(),
                )
            )
            run = lambda b: jitted(b, self.inv_stack)
            self._solver_cache[key] = run
        return run(jnp.asarray(b_stacked).reshape(part.flat_grid_shape))


def solve_cg_fdm_dist(
    dist_fdm: DistFDM,
    dist_op: DistOperator,
    b_stacked: jnp.ndarray,
    control: SolverControl,
    mesh: Optional[Mesh] = None,
):
    """Distributed FDM-preconditioned CG (the step-64-style use on
    variable-coefficient operators). Returns ``(x_flat, info)``."""
    part = dist_fdm.part
    mesh = mesh or make_device_mesh(part.pz, part.py, part.axis_z, part.axis_y)
    az, ay = part.axis_z, part.axis_y
    key = ("pcg", control, mesh, id(dist_op))
    run = dist_fdm._solver_cache.get(key)
    if run is None:
        grid_spec = P(az, ay, None)
        tab_specs = tuple(
            P((az, ay), *([None] * (t.ndim - 1))) for t in dist_op.shard_tables
        )

        def local_solve(b_loc, inv_own, *tables):
            w = dist_op.dot_weight(b_loc.dtype)
            x, info = solve_cg(
                lambda u: dist_op.vmult_local(u, *tables),
                b_loc,
                control,
                diag=lambda r: dist_fdm.apply_local(r, inv_own),
                dot_weight=w,
                psum_axis=(az, ay),
            )
            return x, info["n_iterations"], info["res_norm"], info["res0"]

        jitted = jax.jit(
            jax.shard_map(
                local_solve,
                mesh=mesh,
                in_specs=(grid_spec, P((az, ay))) + tab_specs,
                out_specs=(grid_spec, P(), P(), P()),
            )
        )

        def run(b_flat):
            x, it, res, res0 = jitted(b_flat, dist_fdm.inv_stack, *dist_op.shard_tables)
            return x, {"n_iterations": it, "res_norm": res, "res0": res0}

        dist_fdm._solver_cache[key] = run
    return run(jnp.asarray(b_stacked).reshape(part.flat_grid_shape))
