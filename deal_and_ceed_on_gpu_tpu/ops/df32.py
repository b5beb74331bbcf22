"""Double-float (f32x2) extended-precision separable operator apply.

The reference runs double precision end-to-end (``bp5/step-64.cu:206``).
This module was built for a device without fast f64, where the f64-grade
*solve* path is mixed-precision iterative refinement (``solvers/ir.py``);
whether it earns its place next to native f64 on the GPU is not measured
yet. This module
supplies the stronger guarantee for users who demand f64-grade individual
**operator applies** (<= 1e-12 relative error), not just f64-grade solves:
every value is carried as an unevaluated pair of f32s ``x = hi + lo``
(|lo| <= ulp(hi)/2, ~2^-48 combined precision) and the banded-stencil
formulation of the separable operator (``ops/separable.py``) is evaluated
with error-free transformations:

- products use Dekker's TwoProd with Veltkamp splitting (no FMA needed —
  XLA exposes none — and exact in round-to-nearest f32),
- sums use Knuth's TwoSum with running compensation.

Everything is plain elementwise f32, so the device-memory
traffic is exactly 2x the f32 path (two planes per vector) while the
arithmetic stays native-f32 speed-of-light — no f64 emulation anywhere.
Per-DoF work is the stencil path's 3*(2p+1) taps, each costing ~35 f32
flops instead of 2; the path is compute-heavier (its GPU rate is not
measured).

Covers the separable forms: BP5/BP3 stiffness, BP1 mass, and the
constant-coefficient Helmholtz (stiffness + c * mass) on uniform and
graded bricks — the configurations the reference's f64 drivers run
(``bp5/step-64.cu:725``). Mapped geometry / varying a(x) stay on the IR
solve path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..basis import Basis1D
from ..fe_space import FESpace
from .separable import _axis_tables, _bands_from_dense

__all__ = [
    "two_sum",
    "two_prod",
    "df_add",
    "df_mul",
    "pack_df",
    "unpack_df",
    "DF32SeparableOperator",
]

# Veltkamp splitting constant for f32 (24-bit mantissa -> 12+12 halves):
# 2^12 + 1. Products of the halves are then exact in f32.
_SPLIT = np.float32(4097.0)

# Error-free transformations are only correct if the compiler performs
# the EXACT sequence of rounded operations written here. The HLO this
# module emits is the exact sequence (optimization_barrier on every EFT
# result pins it against HLO-level rewrites). Backend codegen need not
# preserve it: on the GPU, LLVM may contract a multiply and an add of an
# EFT into one FMA, which silently breaks it (not verified either way).
# XLA:CPU's default LLVM
# pipeline, however, miscompiles large fused EFT chains (bit-verified
# repro: a jnp.where feeding df_mul inside one kLoop fusion yields a hi
# limb 2 ulps off while eager per-op dispatch of the same graph is
# exact; --xla_backend_optimization_level=0 restores correctness, so it
# is an LLVM-side value-changing optimization, not the HLO). CPU
# consumers (and the test suite) therefore run this path EAGERLY —
# per-op dispatch is IEEE-exact everywhere.
def _pin(*xs):
    return jax.lax.optimization_barrier(xs)


def two_sum(a, b):
    """Knuth's error-free sum: s + e == a + b exactly (6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return _pin(s, e)


def _quick_two_sum(a, b):
    """Dekker's fast sum; requires |a| >= |b| (used only to renormalize
    a (hi, err) pair, where the invariant holds)."""
    s = a + b
    e = b - (s - a)
    return _pin(s, e)


def two_prod(a, b):
    """Dekker's error-free product via Veltkamp splitting: p + e == a*b
    exactly in round-to-nearest f32 (17 flops, no FMA)."""
    p = a * b
    ta = _SPLIT * a
    ah = ta - (ta - a)
    al = a - ah
    tb = _SPLIT * b
    bh = tb - (tb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return _pin(p, e)


def df_add(a, b):
    """(hi, lo) + (hi, lo) -> normalized (hi, lo)."""
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return _quick_two_sum(s, e)


def df_mul(a, b):
    """(hi, lo) * (hi, lo) -> normalized (hi, lo); drops only the
    O(2^-48) lo*lo term."""
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return _quick_two_sum(p, e)


def pack_df(x) -> jnp.ndarray:
    """f64 array -> stacked ``[2, ...]`` f32 (hi, lo) with
    hi + lo == x to ~2^-48 relative."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(np.stack([hi, lo]))


def unpack_df(xdf) -> np.ndarray:
    """Stacked (hi, lo) -> f64 numpy."""
    x = np.asarray(xdf, np.float32)
    return x[0].astype(np.float64) + x[1].astype(np.float64)


def _band_apply_df(u, bands, axis, p):
    """df32 banded 1D sweep along ``axis``: the stencil-mode
    ``band_apply`` (ops/separable.py) with every multiply an exact
    TwoProd and every accumulate a compensated TwoSum."""
    uh, ul = u
    n1 = uh.shape[axis]
    pad = [(0, 0)] * uh.ndim
    pad[axis] = (p, p)
    uph = jnp.pad(uh, pad)
    upl = jnp.pad(ul, pad)
    bh, bl = bands
    acc = None
    for k in range(-p, p + 1):
        sl = [slice(None)] * uh.ndim
        sl[axis] = slice(p + k, p + k + n1)
        shape = [1] * uh.ndim
        shape[axis] = n1
        b = (bh[p + k].reshape(shape), bl[p + k].reshape(shape))
        t = df_mul(b, (uph[tuple(sl)], upl[tuple(sl)]))
        acc = t if acc is None else df_add(acc, t)
    return acc


def _apply_terms_df(u, terms):
    """df32 mirror of ``apply_separable`` (stencil mode)."""
    out = None
    for t in terms:
        v = u
        for axis, bands, p in t["band"]:
            v = _band_apply_df(v, bands, axis, p)
        if t["diag"] is not None:
            v = df_mul(v, t["diag"])
        out = v if out is None else df_add(out, v)
    return out


def _df_pair(x: np.ndarray):
    """f64 table -> (hi, lo) jnp pair (device constants)."""
    hi = np.asarray(x, np.float32)
    lo = (np.asarray(x, np.float64) - hi.astype(np.float64)).astype(
        np.float32
    )
    return jnp.asarray(hi), jnp.asarray(lo)


def _bshape(vec: np.ndarray, axis: int) -> np.ndarray:
    shape = [1, 1, 1]
    shape[axis] = vec.shape[0]
    return vec.reshape(shape)


def _terms_np(mesh, basis: Basis1D, kind: str, value_const):
    """Build the separable Kronecker terms (``poisson_terms`` /
    ``mass_terms`` structure, ops/separable.py:234-279) as f64 numpy
    band/diag tables."""
    p = basis.degree
    tabs = _axis_tables(mesh, basis)

    def band_entry(ax, A):
        return (ax, _bands_from_dense(A, p), p)

    terms = []
    if kind in ("stiffness", "helmholtz"):
        for ax in (2, 1, 0):
            others = [a for a in (0, 1, 2) if a != ax]
            band = [band_entry(ax, tabs[ax]["A1"])]
            diag = None
            if basis.collocation:
                diag = _bshape(tabs[others[0]]["d"], others[0]) * _bshape(
                    tabs[others[1]]["d"], others[1]
                )
            else:
                for a in others:
                    band.append(band_entry(a, tabs[a]["B"]))
            terms.append({"band": band, "diag": diag})
    if kind == "mass" or (kind == "helmholtz" and value_const):
        c = 1.0 if kind == "mass" else float(value_const)
        if basis.collocation:
            d = c * (
                _bshape(tabs[0]["d"], 0)
                * _bshape(tabs[1]["d"], 1)
                * _bshape(tabs[2]["d"], 2)
            )
            terms.append({"band": [], "diag": d})
        else:
            # fold the constant into the z factor
            band = [band_entry(0, c * tabs[0]["B"])]
            band += [band_entry(a, tabs[a]["B"]) for a in (1, 2)]
            terms.append({"band": band, "diag": None})
    return terms


def _terms_to_device(terms_np, scale: float):
    """f64 terms -> (hi, lo)-split device terms, with the fold factor
    applied in f64 to ONE factor per term before splitting."""
    out = []
    for t in terms_np:
        band = []
        for i, (ax, bands, p) in enumerate(t["band"]):
            b = bands * scale if (i == 0 and t["diag"] is None) else bands
            band.append((ax, _df_pair(b), p))
        diag = None if t["diag"] is None else _df_pair(t["diag"] * scale)
        out.append({"band": band, "diag": diag})
    return out


class DF32SeparableOperator:
    """f64-grade ``vmult`` from pure-f32 arithmetic (see module
    docstring). Vectors are stacked ``[2, n]`` (hi, lo) f32 arrays;
    :func:`pack_df` / :func:`unpack_df` convert at the boundary. The
    operator is identity on Dirichlet rows, matching
    ``MatrixFreeOperator.vmult`` (``bp5/step-64.cu:263-276``).

    kind: "stiffness" (BP5/BP3), "mass" (BP1), or "helmholtz"
    (stiffness + value_const * mass).
    """

    def __init__(
        self,
        space: FESpace,
        kind: str = "stiffness",
        value_const: Optional[float] = None,
    ):
        if kind not in ("stiffness", "mass", "helmholtz"):
            raise ValueError(f"unknown kind {kind!r}")
        self.space = space
        self.kind = kind
        self._terms_np = _terms_np(space.mesh, space.basis, kind, value_const)
        self._fold = 1.0
        self._terms = _terms_to_device(self._terms_np, 1.0)
        mask = np.asarray(space.dirichlet_mask)
        self._mask = jnp.asarray(mask.reshape(space.grid_shape))

    def fold_scale(self, s: float) -> None:
        """A <- s * A on unconstrained rows (benchmark normalization,
        same contract as ``MatrixFreeOperator.fold_scale``): applied in
        f64 to the host tables, then re-split — the df tables stay
        accurate to 2^-48 of the SCALED operator."""
        self._fold *= float(s)
        self._terms = _terms_to_device(self._terms_np, self._fold)

    # ------------------------------------------------------------- #
    def vmult_df(self, src: jnp.ndarray) -> jnp.ndarray:
        """dst = A src on stacked ``[2, n]`` (hi, lo) vectors, Dirichlet
        rows as identity."""
        s = self.space
        g = s.grid_shape
        zero = jnp.zeros((), jnp.float32)
        uh = src[0].reshape(g)
        ul = src[1].reshape(g)
        m = self._mask
        vh, vl = _apply_terms_df(
            (jnp.where(m, zero, uh), jnp.where(m, zero, ul)), self._terms
        )
        return jnp.stack(
            [
                jnp.where(m, uh, vh).reshape(-1),
                jnp.where(m, ul, vl).reshape(-1),
            ]
        )

    def __call__(self, src: jnp.ndarray) -> jnp.ndarray:
        return self.vmult_df(src)

    def vmult(self, src) -> np.ndarray:
        """Convenience f64 -> f64 apply (pack, df-apply, unpack),
        dispatched eagerly on every backend (see the EFT codegen note
        above: inside large fusions the backend's LLVM pipeline can break
        compensated arithmetic)."""
        return unpack_df(self.vmult_df(pack_df(src)))
