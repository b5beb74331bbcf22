"""Domain decomposition over a device mesh.

Replacement of the reference's L0 distribution stack (p4est
partitioning + owned/ghost DoF index sets + CUDA-aware-MPI transport;
``bp5/step-64.cu:310,345-348``, ``tests/cuda_aware_mpi.cc``): the element
grid is block-partitioned along the z axis — and optionally the y axis —
over a 2D ``jax.sharding.Mesh``. There are no index sets and no transport
code: the ghost layer is the single shared nodal plane between neighboring
blocks per partitioned axis, exchanged with a ``ppermute`` inside
``shard_map``.

Representation ("ghosted block"): every device holds
``[nz_loc, ny_loc, nx]`` nodal planes; the *last* plane along each
partitioned axis duplicates the next block's first plane. Elementwise
vector updates keep duplicates consistent by construction, so only two
operations communicate:

- ``vmult``: partial sums on shared planes are combined with one
  bidirectional plane ``ppermute`` per partitioned axis (the
  ``update_ghost_values``/``compress(add)`` pair, reference L-2/L-9);
  shared *edges* between four diagonal neighbors resolve automatically by
  doing the z exchange first (its planes then carry z-pair sums into the
  y exchange);
- dot products: duplicated planes are weighted out, then one ``psum``
  over both mesh axes (the 7-scalar ``MPI_Allreduce``,
  ``bp5/solver.h:493-494``).

**Any shard count divides any mesh**: when ``m_d`` is not divisible by the
axis shard count, the element grid is padded with dead elements past the
physical z/y extent. All nodal planes at or beyond the physical boundary
plane are constrained (the physical boundary is Dirichlet anyway, so the
padding extends the identity block): padded DoFs carry exact zeros through
operator applies and CG updates, making the padded solve bit-identical to
the unpadded one on the physical DoFs — the answer to p4est's
arbitrary-rank-count partitioning (``bp5/step-64.cu:704-708``).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..mesh import BrickMesh

__all__ = ["BlockPartition", "SlabPartition"]


@dataclasses.dataclass(frozen=True)
class BlockPartition:
    """(z, y[, x]) block decomposition of a :class:`BrickMesh` over a
    ``pz x py`` — or, with ``px > 1``, a full 3D ``pz x py x px`` — device
    mesh (``py = px = 1`` gives classic z slabs). Every halo exchange is
    between neighbouring blocks along one mesh axis."""

    mesh: BrickMesh
    degree: int
    pz: int
    py: int = 1
    axis_z: str = "z"
    axis_y: str = "y"
    px: int = 1
    axis_x: str = "x"

    def __post_init__(self):
        if self.pz < 1 or self.py < 1 or self.px < 1:
            raise ValueError("shard counts must be >= 1")

    # ------------------------------ sizes ----------------------------- #
    @property
    def n_shards(self) -> int:
        return self.pz * self.py * self.px

    @property
    def mz_local(self) -> int:
        return -(-self.mesh.n_elements[2] // self.pz)  # ceil

    @property
    def my_local(self) -> int:
        return -(-self.mesh.n_elements[1] // self.py)

    @property
    def mx_local(self) -> int:
        return -(-self.mesh.n_elements[0] // self.px)

    @property
    def local_mesh(self) -> BrickMesh:
        """The per-shard element block. On a uniform global mesh the local
        geometry is identical on every shard, so one traced program serves
        all of them. On graded/mapped global meshes the local mesh only
        fixes the *structure* (shapes and which operator code paths run —
        full coefficient tables, symmetric contraction); its geometry
        values are placeholders, overridden per shard by sliced global
        tables (``DistOperator.shard_tables``)."""
        mx, my, mz = self.mesh.n_elements
        lo = self.mesh.lower
        if self.mesh.is_uniform:
            hx, hy, hz = self.mesh.h
            return BrickMesh(
                (self.mx_local, self.my_local, self.mz_local),
                lo,
                (
                    lo[0] + hx * self.mx_local,
                    lo[1] + hy * self.my_local,
                    lo[2] + hz * self.mz_local,
                ),
            )
        # structural placeholder: shard-0's block of the global mesh
        hx = np.asarray(self.mesh.h_axes()[0])[: self.mx_local]
        hy = np.asarray(self.mesh.h_axes()[1])[: self.my_local]
        hz = np.asarray(self.mesh.h_axes()[2])[: self.mz_local]
        # pad placeholder widths if shard 0 is smaller than the block
        hx = np.pad(hx, (0, self.mx_local - hx.size), constant_values=1.0)
        hy = np.pad(hy, (0, self.my_local - hy.size), constant_values=1.0)
        hz = np.pad(hz, (0, self.mz_local - hz.size), constant_values=1.0)
        local = BrickMesh(
            (self.mx_local, self.my_local, self.mz_local),
            lo,
            (
                lo[0] + float(hx.sum()),
                lo[1] + float(hy.sum()),
                lo[2] + float(hz.sum()),
            ),
            widths=(hx, hy, hz) if self.mesh.widths is not None else None,
        )
        if self.mesh.is_mapped:
            local = local.deform(self.mesh.mapping, self.mesh.mapping_jacobian)
        return local

    @property
    def local_grid_shape(self) -> tuple[int, int, int]:
        p = self.degree
        return (
            self.mz_local * p + 1,
            self.my_local * p + 1,
            self.mx_local * p + 1,
        )

    @property
    def global_grid_shape(self) -> tuple[int, int, int]:
        nx, ny, nz = self.mesh.n_nodes(self.degree)
        return (nz, ny, nx)

    @property
    def flat_grid_shape(self) -> tuple[int, int, int]:
        """Shape of the shard_map operand: blocks concatenated (with their
        ghost/padding planes) along every partitioned axis."""
        nzl, nyl, nxl = self.local_grid_shape
        return (self.pz * nzl, self.py * nyl, self.px * nxl)

    # ---------------------------------------------------------------- #
    # host-side conversions global grid <-> concatenated ghosted blocks
    # ---------------------------------------------------------------- #
    def to_blocks(self, u_global: np.ndarray) -> np.ndarray:
        """``[nz, ny, nx]`` global nodal grid -> ``flat_grid_shape`` array
        whose (iz, iy) block holds that shard's ghosted local grid
        (padding beyond the physical extent is zero). A leading component
        axis (vector-valued operators) passes through."""
        u_global = np.asarray(u_global)
        n_glob = int(np.prod(self.global_grid_shape))
        if u_global.ndim == 4 or (
            u_global.ndim == 2 and u_global.shape[1] == n_glob
        ):
            comps = u_global.reshape(u_global.shape[0], *self.global_grid_shape)
            return np.stack([self.to_blocks(c) for c in comps])
        nz, ny, nx = self.global_grid_shape
        nzl, nyl, nxl = self.local_grid_shape
        u = np.asarray(u_global).reshape(nz, ny, nx)
        p = self.degree
        sz, sy, sx = self.mz_local * p, self.my_local * p, self.mx_local * p
        out = np.zeros(self.flat_grid_shape, dtype=u.dtype)
        for iz in range(self.pz):
            lz = min(nzl, nz - iz * sz)
            for iy in range(self.py):
                ly = min(nyl, ny - iy * sy)
                for ix in range(self.px):
                    lx = min(nxl, nx - ix * sx)
                    out[
                        iz * nzl : iz * nzl + lz,
                        iy * nyl : iy * nyl + ly,
                        ix * nxl : ix * nxl + lx,
                    ] = u[
                        iz * sz : iz * sz + lz,
                        iy * sy : iy * sy + ly,
                        ix * sx : ix * sx + lx,
                    ]
        return out

    def from_blocks(self, blocks: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`to_blocks` (drops duplicated ghost planes and
        dead padding); a leading component axis passes through."""
        blocks = np.asarray(blocks)
        if blocks.ndim == 4 and blocks.shape[1:] == self.flat_grid_shape:
            return np.stack([self.from_blocks(c) for c in blocks])
        nz, ny, nx = self.global_grid_shape
        nzl, nyl, nxl = self.local_grid_shape
        b = np.asarray(blocks).reshape(self.flat_grid_shape)
        p = self.degree
        sz, sy, sx = self.mz_local * p, self.my_local * p, self.mx_local * p
        out = np.zeros((nz, ny, nx), dtype=b.dtype)
        # shard iz owns planes [iz*sz, (iz+1)*sz) clipped to [0, nz); the
        # axis-final shard additionally owns the final plane (if any physical
        # planes land past the last block start, they clip in too)
        for iz in range(self.pz):
            z0 = iz * sz
            hi = nz if iz == self.pz - 1 else min(z0 + sz, nz)
            lz = max(0, hi - z0)
            for iy in range(self.py):
                y0 = iy * sy
                hi_y = ny if iy == self.py - 1 else min(y0 + sy, ny)
                ly = max(0, hi_y - y0)
                for ix in range(self.px):
                    x0 = ix * sx
                    hi_x = nx if ix == self.px - 1 else min(x0 + sx, nx)
                    lx = max(0, hi_x - x0)
                    if lz > 0 and ly > 0 and lx > 0:
                        out[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx] = b[
                            iz * nzl : iz * nzl + lz,
                            iy * nyl : iy * nyl + ly,
                            ix * nxl : ix * nxl + lx,
                        ]
        return out

    def slice_table(self, table: np.ndarray) -> np.ndarray:
        """Slice a structured-layout table on the padded mesh
        (``[MZ_pad, q, MY_pad, q, MX_pad, q, ...]``, element-major) into
        the per-shard stack ``[n_shards, mz_loc, q, my_loc, q, mx_loc, q,
        ...]`` in device order (z-major, x fastest)."""
        mzl, myl, mxl = self.mz_local, self.my_local, self.mx_local
        parts = []
        for iz in range(self.pz):
            for iy in range(self.py):
                for ix in range(self.px):
                    parts.append(
                        table[
                            iz * mzl : (iz + 1) * mzl,
                            :,
                            iy * myl : (iy + 1) * myl,
                            :,
                            ix * mxl : (ix + 1) * mxl,
                        ]
                    )
        return np.stack(parts)

    # ---------------------------------------------------------------- #
    # per-shard masks/weights (built inside shard_map from axis indices)
    # ---------------------------------------------------------------- #
    def local_dirichlet_mask(self, iz, iy, ix=0) -> jnp.ndarray:
        """bool ``[nz_loc, ny_loc, nx_loc]``: planes at or beyond the
        physical boundary per axis (which subsumes the dead padding).
        ``iz``/``iy``/``ix`` may be traced (``lax.axis_index``)."""
        nzl, nyl, nxl = self.local_grid_shape
        nz, ny, nx = self.global_grid_shape
        p = self.degree
        gx = ix * (self.mx_local * p) + jnp.arange(nxl)
        bx = (gx == 0) | (gx >= nx - 1)
        gy = iy * (self.my_local * p) + jnp.arange(nyl)
        by = (gy == 0) | (gy >= ny - 1)
        gz = iz * (self.mz_local * p) + jnp.arange(nzl)
        bz = (gz == 0) | (gz >= nz - 1)
        return (
            bz[:, None, None] | by[None, :, None] | bx[None, None, :]
        )

    def local_dot_weight(self, iz, iy, dtype, ix=0) -> jnp.ndarray:
        """``[nz_loc, ny_loc, nx_loc or 1]`` weights: 0 on ghost-duplicated
        planes (each shard's last plane per partitioned axis except on the
        axis-final shard). Padding DoFs are exactly zero, so they need no
        weighting."""
        nzl, nyl, nxl = self.local_grid_shape
        wz = jnp.ones((nzl,), dtype=dtype)
        wz = wz.at[-1].set(jnp.where(iz == self.pz - 1, 1.0, 0.0).astype(dtype))
        wy = jnp.ones((nyl,), dtype=dtype)
        wy = wy.at[-1].set(jnp.where(iy == self.py - 1, 1.0, 0.0).astype(dtype))
        w = wz[:, None, None] * wy[None, :, None]
        if self.px > 1:
            wx = jnp.ones((nxl,), dtype=dtype)
            wx = wx.at[-1].set(
                jnp.where(ix == self.px - 1, 1.0, 0.0).astype(dtype)
            )
            w = w * wx[None, None, :]
        return w

    # ----------------------- slab-compat aliases ---------------------- #
    def to_slabs(self, u_global: np.ndarray) -> np.ndarray:
        """z-slab view ``[n_shards, nz_loc, ny_loc, nx]`` (py == 1)."""
        nzl, nyl, nx = self.local_grid_shape
        return self.to_blocks(u_global).reshape(self.pz, nzl, nyl, nx)

    def from_slabs(self, slabs: np.ndarray) -> np.ndarray:
        return self.from_blocks(np.asarray(slabs).reshape(self.flat_grid_shape))


def SlabPartition(mesh: BrickMesh, degree: int, n_shards: int, axis_name: str = "z"):
    """Classic z-slab decomposition: ``BlockPartition`` with ``py = 1``."""
    return BlockPartition(mesh, degree, pz=n_shards, py=1, axis_z=axis_name)
