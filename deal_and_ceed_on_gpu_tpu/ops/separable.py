"""Separable (Kronecker) global operator apply — the uniform-mesh fast path.

Global reformulation of the cell loop: on a uniform brick mesh with a
constant (per-element) coefficient, gather -> sum-factorize -> scatter
collapses *globally*. For each tensor direction, "scatter o (1D element
matrix) o gather" along the same axis is a global banded 1D operator with
period-p coefficients, and "scatter o diag(w) o gather" is a global diagonal.
Hence (3D Poisson, reference BP5 configuration):

    A  =  cx * Dz (x) Dy (x) A1x  +  cy * Dz (x) A1y (x) Dx
                                  +  cz * A1z (x) Dy (x) Dx

with A1 = Z^T (D^T diag(w) D) Z banded (half-bandwidth p) and D diagonal.
The apply is three 1D-operator sweeps plus one fused elementwise combine:
**no gather, no scatter, no local-tensor inflation** — memory traffic drops
to a few reads/writes of the nodal grid, and the sweeps run either as
dense 1D matrix contractions or as 2p+1 shifted fused multiply-adds.
(``ops/stencil.py`` fuses the whole GLL apply into one Triton kernel.)
This replaces the reference's ``apply_kernel_shmem`` hot
kernel (``README.md:72``) for its entire benchmark suite, exactly
reproducing the discrete operator (same quadrature) up to fp reordering.

Also covers: BP1 mass (B (x) B (x) B), BP3 (Gauss quadrature: diagonal
factors become banded B = Z^T S^T diag(w) S Z), and the value term of a
GLL-collocated Helmholtz (a global diagonal).
"""

from __future__ import annotations

from typing import Literal, Sequence

import jax.numpy as jnp
import numpy as np

from ..basis import Basis1D
from .sum_factorization import sweep

__all__ = [
    "band_matrix_1d",
    "diag_vector_1d",
    "apply_separable",
    "apply_separable_plane",
    "band_apply",
    "poisson_terms",
    "mass_terms",
]


def band_matrix_1d(m: int, p: int, elem_mat: np.ndarray, scale=None) -> np.ndarray:
    """Assemble the global 1D operator ``Z^T diag(scale) E Z`` for ``m``
    elements of degree p from the (p+1)x(p+1) element matrix E: dense
    ``[n1, n1]`` with n1 = m*p+1 (banded, half-bandwidth p). ``scale``:
    optional per-element factor (graded tensor meshes)."""
    n1 = m * p + 1
    A = np.zeros((n1, n1))
    for e in range(m):
        s = e * p
        c = 1.0 if scale is None else float(scale[e])
        A[s : s + p + 1, s : s + p + 1] += c * elem_mat
    return A


def diag_vector_1d(m: int, p: int, w: np.ndarray, scale=None) -> np.ndarray:
    """Assemble the global diagonal ``Z^T diag(scale_e * w) Z``: shared
    nodes sum the weights of both adjacent elements."""
    n1 = m * p + 1
    d = np.zeros(n1)
    for e in range(m):
        c = 1.0 if scale is None else float(scale[e])
        d[e * p : e * p + p + 1] += c * w
    return d


def band_apply(
    u: jnp.ndarray,
    mat: jnp.ndarray,
    bands: jnp.ndarray,
    axis: int,
    mode: Literal["matmul", "stencil"],
    p: int,
):
    """Apply a banded global 1D operator along ``axis``.

    mode="matmul": one dense contraction (wasteful in FLOPs for large n1;
        the matmul runs at the sweep precision, HIGHEST by default).
    mode="stencil": 2p+1 shifted multiply-adds using the band
        representation ``bands[2p+1, n1]`` (bands[p+k][i] = A[i, i+k]) —
        minimal FLOPs, traffic-bound.
    """
    if mode == "matmul":
        return sweep(u, mat, axis)
    n1 = u.shape[axis]
    pad = [(0, 0)] * u.ndim
    pad[axis] = (p, p)
    up = jnp.pad(u, pad)
    out = None
    for k in range(-p, p + 1):
        sl = [slice(None)] * u.ndim
        sl[axis] = slice(p + k, p + k + n1)
        b = bands[p + k]
        shape = [1] * u.ndim
        shape[axis] = n1
        contrib = up[tuple(sl)] * b.reshape(shape)
        out = contrib if out is None else out + contrib
    return out


def apply_separable(
    u: jnp.ndarray,
    terms: Sequence[dict],
    mode: Literal["matmul", "stencil"] = "matmul",
):
    """u: ``[nz, ny, nx]`` nodal grid. ``terms``: list of dicts with keys
    ``coef`` (scalar), ``band`` (list of (axis, mat, bands, p)) and ``diag``
    (broadcastable diagonal array for the remaining axes, may be None).
    Returns sum of all terms."""
    out = None
    for t in terms:
        v = u
        for axis, mat, bands, p in t["band"]:
            v = band_apply(v, mat, bands, axis, mode, p)
        if t["diag"] is not None:
            v = v * t["diag"]
        v = t["coef"] * v
        out = v if out is None else out + v
    return out


def apply_separable_plane(
    u: jnp.ndarray,
    terms: Sequence[dict],
    axis: int,
    side: int,
    mode: Literal["matmul", "stencil"] = "matmul",
):
    """The first (``side == 0``) or last (``side == -1``) output plane of
    :func:`apply_separable` along ``axis``, computed from only the p+1
    nearest input planes — one plane's worth of work instead of a full
    apply. This is the distributed boundary-partial fast path: the shared
    plane a shard must send depends only on this restricted computation,
    so the halo ``ppermute`` can be issued *before* (and overlap with) the
    full local apply (the reference's
    ``overlap_communication_computation``, ``bp5/step-64.cu:241``).
    Returns a plane with ``keepdims`` (size 1 along ``axis``)."""
    n = u.shape[axis]
    out = None
    for t in terms:
        on_axis = [b for b in t["band"] if b[0] == axis]
        others = [b for b in t["band"] if b[0] != axis]
        if on_axis:
            _, mat, _, p = on_axis[0]
            sl = [slice(None)] * u.ndim
            if side == 0:
                sl[axis] = slice(0, p + 1)
                row = mat[0, 0 : p + 1]
            else:
                sl[axis] = slice(n - p - 1, n)
                row = mat[n - 1, n - p - 1 : n]
            shape = [1] * u.ndim
            shape[axis] = p + 1
            v = jnp.sum(u[tuple(sl)] * row.reshape(shape), axis=axis, keepdims=True)
        else:
            sl = [slice(None)] * u.ndim
            sl[axis] = slice(0, 1) if side == 0 else slice(n - 1, n)
            v = u[tuple(sl)]
        for ax2, mat2, bands2, p2 in others:
            v = band_apply(v, mat2, bands2, ax2, mode, p2)
        if t["diag"] is not None:
            d = t["diag"]
            if d.ndim == u.ndim and d.shape[axis] == n:
                dsl = [slice(None)] * u.ndim
                dsl[axis] = slice(0, 1) if side == 0 else slice(n - 1, n)
                d = d[tuple(dsl)]
            v = v * d
        v = t["coef"] * v
        out = v if out is None else out + v
    return out


# --------------------------------------------------------------------- #
# term builders for the concrete operators
# --------------------------------------------------------------------- #
def _bands_from_dense(A: np.ndarray, p: int) -> np.ndarray:
    """bands[p+k, i] = A[i, i+k] for k in [-p, p] (zero outside)."""
    n1 = A.shape[0]
    bands = np.zeros((2 * p + 1, n1))
    for k in range(-p, p + 1):
        lo, hi = max(0, -k), min(n1, n1 - k)
        idx = np.arange(lo, hi)
        bands[p + k, idx] = A[idx, idx + k]
    return bands


def _axis_tables(mesh, basis):
    """Per grid axis (0=z, 1=y, 2=x): the assembled global 1D tables with
    ALL geometric scaling absorbed per axis (so the Kronecker terms carry
    coefficient 1.0; this is what keeps graded tensor meshes on the fast
    path):

      A1 = Z^T diag(1/h_e) K Z   (stiffness factor: d/dx on the unit cell
                                  scaled by the per-element inverse width)
      B  = Z^T diag(h_e)  M  Z   (value factor, Gauss rules)
      d  = Z^T diag(h_e * w) Z   (pointwise weights, GLL collocation)
    """
    if mesh.is_mapped:
        raise ValueError(
            "separable backend: tensor-product (uniform/graded brick) "
            "meshes only — mapped meshes have non-separable metric terms; "
            "use the structured or gather backend"
        )
    p = basis.degree
    S, D, w = basis.S, basis.D, basis.q_weights
    K_e = np.einsum("q,qa,qb->ab", w, D, D)
    B_e = np.einsum("q,qa,qb->ab", w, S, S)
    hx, hy, hz = mesh.h_axes()
    mx, my, mz = mesh.n_elements
    axis_data = {0: (mz, hz), 1: (my, hy), 2: (mx, hx)}
    out = {}
    for ax, (m, h) in axis_data.items():
        out[ax] = {
            "A1": band_matrix_1d(m, p, K_e, scale=1.0 / h),
            "B": band_matrix_1d(m, p, B_e, scale=h),
            # pointwise weights only exist at collocation (q == p+1, GLL)
            "d": diag_vector_1d(m, p, w, scale=h) if basis.collocation else None,
        }
    return out


def _bshape(vec: np.ndarray, axis: int) -> np.ndarray:
    shape = [1, 1, 1]
    shape[axis] = vec.shape[0]
    return vec.reshape(shape)


def poisson_terms(mesh, basis: Basis1D, dtype) -> list[dict]:
    """BP5/BP3 stiffness on a (uniform or graded) tensor brick: 3
    Kronecker terms, geometry absorbed into the per-axis tables."""
    p = basis.degree
    tabs = _axis_tables(mesh, basis)
    terms = []
    for ax in (2, 1, 0):
        others = [a for a in (0, 1, 2) if a != ax]
        A1 = tabs[ax]["A1"]
        band = [(ax, jnp.asarray(A1, dtype), jnp.asarray(_bands_from_dense(A1, p), dtype), p)]
        if basis.collocation:
            diag = _bshape(tabs[others[0]]["d"], others[0]) * _bshape(
                tabs[others[1]]["d"], others[1]
            )
            diag = jnp.asarray(diag, dtype)
        else:
            for a in others:
                B = tabs[a]["B"]
                band.append(
                    (a, jnp.asarray(B, dtype), jnp.asarray(_bands_from_dense(B, p), dtype), p)
                )
            diag = None
        terms.append({"coef": 1.0, "band": band, "diag": diag})
    return terms


def mass_terms(mesh, basis: Basis1D, dtype) -> list[dict]:
    """BP1 mass on a (uniform or graded) tensor brick: one Kronecker term
    (fully diagonal at GLL collocation -- the classic lumped
    spectral-element mass)."""
    p = basis.degree
    tabs = _axis_tables(mesh, basis)
    if basis.collocation:
        diag = (
            _bshape(tabs[0]["d"], 0)
            * _bshape(tabs[1]["d"], 1)
            * _bshape(tabs[2]["d"], 2)
        )
        return [{"coef": 1.0, "band": [], "diag": jnp.asarray(diag, dtype)}]
    band = []
    for a in (0, 1, 2):
        B = tabs[a]["B"]
        band.append(
            (a, jnp.asarray(B, dtype), jnp.asarray(_bands_from_dense(B, p), dtype), p)
        )
    return [{"coef": 1.0, "band": band, "diag": None}]
