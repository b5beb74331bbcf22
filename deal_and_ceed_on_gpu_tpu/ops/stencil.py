"""One-pass stencil apply of the GLL brick operator: a Pallas kernel
through Triton.

On a uniform or graded brick with GLL collocation the separable form
(``ops/separable.py``) of the BP5 stiffness operator is

    out[z,y,x] = dz[z] dy[y] sum_k bx[p+k,x] u[z,y,x+k]
               + dz[z] dx[x] sum_k by[p+k,y] u[z,y+k,x]
               + dy[y] dx[x] sum_k bz[p+k,z] u[z+k,y,x]      (|k| <= p)
               (+ v[z,y,x] u[z,y,x]   optional pointwise value term)

with ``b*`` the bands of the assembled 1D stiffness factors and ``d*`` the
assembled 1D quadrature weights. The XLA separable path makes a full-grid
pass per axis term plus the combine; this kernel reads ``u`` once from
device memory and writes ``out`` once, serving the 2p-wide halo of each
tile from L1/L2. It is the matrix-free counterpart of the reference's
``apply_kernel_shmem`` cell kernel for the uniform-brick benchmark.

Layout: the natural ``[nz, ny, nx]`` grid, flattened (no padding), so
CG vectors need no repacking. Each program owns one ``(BZ, BY, BX)`` tile
(powers of two; tiles at the far faces are masked). Every neighbour load
is a masked load at a flat offset from the tile's base offsets; the mask
also zeroes the Dirichlet (boundary) entries of the input, and boundary
rows of the output copy the source (``vmult`` semantics: identity rows on
the constrained set, ``bp5/step-64.cu:263-276``).

The arithmetic is 3(2p+1) fused multiply-adds per point in the vector
dtype (f32 or f64); there is no matrix product, so no TF32 rounding can
enter.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .separable import _axis_tables, _bands_from_dense

__all__ = ["StencilOperator", "stencil_tables", "stencil_apply", "default_block"]


def default_block(dtype) -> tuple[tuple[int, int, int], int]:
    """``((BZ, BY, BX), num_warps)``, chosen from the six tiles that
    ``scripts/sweep_stencil_tiles.py`` times on an H100 at BP5 cycle 33
    (f32) and cycle 40 (f64); the sweeps and their spread are in
    ``PERF.md``."""
    if jnp.dtype(dtype).itemsize <= 4:
        return (4, 8, 64), 8
    return (2, 8, 64), 4


def stencil_tables(mesh, basis, dtype, value_diag=None) -> dict:
    """Host-built device tables of the operator: ``bz/by/bx`` bands
    ``[2p+1, n_axis]`` and ``dz/dy/dx`` weights ``[n_axis]`` from the same
    assembled 1D factors as :func:`..ops.separable.poisson_terms`, plus
    the optional pointwise value field ``v`` ``[nz*ny*nx]``."""
    if not basis.collocation:
        raise ValueError(
            "stencil backend: GLL collocation only (Gauss rules have "
            "banded value factors; use the separable backend)"
        )
    p = basis.degree
    tabs = _axis_tables(mesh, basis)  # raises on mapped meshes
    t = {}
    for ax, name in ((0, "z"), (1, "y"), (2, "x")):
        t["b" + name] = jnp.asarray(_bands_from_dense(tabs[ax]["A1"], p), dtype)
        t["d" + name] = jnp.asarray(tabs[ax]["d"], dtype)
    t["v"] = None if value_diag is None else jnp.asarray(
        np.asarray(value_diag).reshape(-1), dtype
    )
    return t


def _kernel(*refs, p, shape, block, has_value):
    if has_value:
        u_ref, bz_ref, by_ref, bx_ref, dz_ref, dy_ref, dx_ref, v_ref, o_ref = refs
    else:
        u_ref, bz_ref, by_ref, bx_ref, dz_ref, dy_ref, dx_ref, o_ref = refs
    nz, ny, nx = shape
    BZ, BY, BX = block
    i32 = jnp.int32
    z = pl.program_id(0) * BZ + jax.lax.broadcasted_iota(i32, (BZ, 1, 1), 0)
    y = pl.program_id(1) * BY + jax.lax.broadcasted_iota(i32, (1, BY, 1), 1)
    x = pl.program_id(2) * BX + jax.lax.broadcasted_iota(i32, (1, 1, BX), 2)
    sy, sz = nx, nx * ny  # flat strides
    base = z * sz + y * sy + x

    def inner(c, n):
        return (c >= 1) & (c <= n - 2)

    inb_z, inb_y, inb_x = z < nz, y < ny, x < nx
    in_z, in_y, in_x = inner(z, nz), inner(y, ny), inner(x, nx)
    # interior of the other two axes, per axis term (the shifted axis is
    # masked per shift below)
    m_x = in_z & in_y
    m_y = in_z & in_x
    m_z = in_y & in_x

    def load(off, mask):
        return plt.load(u_ref.at[base + off], mask=mask, other=0)

    def vec(ref, k, c, n):
        # band row k at this tile's coordinates, zero past the grid end
        return plt.load(ref.at[k, jnp.minimum(c, n - 1)], mask=c < n, other=0)

    u_raw = load(0, inb_z & inb_y & inb_x)
    u_c = jnp.where(m_x & in_x, u_raw, 0)
    tx = vec(bx_ref, p, x, nx) * u_c
    ty = vec(by_ref, p, y, ny) * u_c
    tz = vec(bz_ref, p, z, nz) * u_c
    for k in range(-p, p + 1):
        if k == 0:
            continue
        tx = tx + vec(bx_ref, p + k, x, nx) * load(k, m_x & inner(x + k, nx))
        ty = ty + vec(by_ref, p + k, y, ny) * load(k * sy, m_y & inner(y + k, ny))
        tz = tz + vec(bz_ref, p + k, z, nz) * load(k * sz, m_z & inner(z + k, nz))
    dz = plt.load(dz_ref.at[jnp.minimum(z, nz - 1)])
    dy = plt.load(dy_ref.at[jnp.minimum(y, ny - 1)])
    dx = plt.load(dx_ref.at[jnp.minimum(x, nx - 1)])
    acc = dz * (dy * tx + dx * ty) + (dy * dx) * tz
    inb = inb_z & inb_y & inb_x
    if has_value:
        acc = acc + plt.load(v_ref.at[base], mask=inb, other=0) * u_c
    out = jnp.where(m_x & in_x, acc, u_raw)
    plt.store(o_ref.at[base], out.astype(o_ref.dtype), mask=inb)


def stencil_apply(
    u_flat: jnp.ndarray,
    tables: dict,
    shape: tuple[int, int, int],
    p: int,
    *,
    block: tuple[int, int, int] | None = None,
    num_warps: int | None = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Constrained apply ``dst = A src`` on a flat natural-grid vector
    (Dirichlet rows identity). ``block`` and ``num_warps`` override the
    default tile (``scripts/sweep_stencil_tiles.py`` times the choices);
    ``interpret=True`` runs the kernel through the Pallas interpreter
    (CPU tests)."""
    nz, ny, nx = shape
    if nz * ny * nx >= 2**31:
        raise ValueError("stencil backend: flat int32 offsets need < 2^31 points")
    default, default_warps = default_block(u_flat.dtype)
    BZ, BY, BX = block or default
    num_warps = num_warps or default_warps
    has_value = tables.get("v") is not None
    args = [u_flat] + [tables[k] for k in ("bz", "by", "bx", "dz", "dy", "dx")]
    if has_value:
        args.append(tables["v"])
    kernel = functools.partial(
        _kernel, p=p, shape=shape, block=(BZ, BY, BX), has_value=has_value
    )
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(u_flat.shape, u_flat.dtype),
        grid=(pl.cdiv(nz, BZ), pl.cdiv(ny, BY), pl.cdiv(nx, BX)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="gll_stencil_apply",
    )(*args)


class StencilOperator:
    """The kernel with its tables bound: ``op(u_flat)`` is the constrained
    apply. :meth:`fold_scale` rescales the bands and the value field, so
    a chained-vmult benchmark pays no extra elementwise pass."""

    def __init__(self, mesh, basis, dtype, value_diag=None):
        self.tables = stencil_tables(mesh, basis, dtype, value_diag)
        nx, ny, nz = mesh.n_nodes(basis.degree)
        self.shape = (nz, ny, nx)
        self.p = basis.degree

    def __call__(self, u_flat: jnp.ndarray) -> jnp.ndarray:
        return stencil_apply(u_flat, self.tables, self.shape, self.p)

    def fold_scale(self, s: float) -> None:
        t = self.tables
        for k in ("bz", "by", "bx"):
            t[k] = t[k] * s
        if t["v"] is not None:
            t["v"] = t["v"] * s
