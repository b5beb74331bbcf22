"""Local <-> global DoF transfer: gather (``read_dof_values``) and
scatter-add (``distribute_local_to_global``).

The reference resolves write conflicts in its scatter with CUDA
``atomicAdd`` or graph coloring (``bp5/fe_evaluation_gl.h:162-181``). This
module avoids the conflict altogether where the mesh allows it (SURVEY.md
section 7 "hard parts"):

**Structured backend (index-free).** On a lexicographic brick grid the
local<->global map is axis-separable. Along one axis with ``m`` elements of
degree ``p`` (``n = m*p + 1`` global nodes), element ``e`` touches nodes
``[e*p, e*p + p]`` — consecutive elements overlap in exactly one node. So:

- gather  = a reshape of the first ``m*p`` entries plus one strided slice,
- scatter = the reverse overlap-add: shift the last-node column by one
  element and add it onto the first-node column.

Both are dense slices/concats — no gather indices, no scatter, no atomics,
deterministic, and XLA-fusible. The 3D version applies this per axis,
yielding the interleaved local layout ``[mz, p+1, my, p+1, mx, p+1]``.

**Gather backend (general).** Explicit int32 ``local_to_global`` tables with
``jnp.take`` and ``.at[].add`` scatter (atomics on the GPU) — the path that also
serves unstructured/adaptive meshes later (constraint masks slot in here).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "split_axis",
    "join_axis",
    "gather_structured",
    "scatter_structured",
    "gather_indexed",
    "scatter_indexed",
]


# --------------------------------------------------------------------- #
# structured (index-free) backend
# --------------------------------------------------------------------- #
def split_axis(u: jnp.ndarray, axis: int, m: int, p: int) -> jnp.ndarray:
    """Gather along one axis: size ``m*p+1`` -> two axes ``(m, p+1)`` of
    per-element local nodes (shared nodes duplicated). The new pair replaces
    ``axis`` in place."""
    axis = axis % u.ndim
    u = jnp.moveaxis(u, axis, -1)
    main = u[..., : m * p].reshape(u.shape[:-1] + (m, p))
    last = u[..., p :: p][..., None]  # nodes p, 2p, ..., m*p
    out = jnp.concatenate([main, last], axis=-1)  # [..., m, p+1]
    return jnp.moveaxis(out, (-2, -1), (axis, axis + 1))


def join_axis(v: jnp.ndarray, axis: int, p: int) -> jnp.ndarray:
    """Scatter-add along one axis: two axes ``(m, p+1)`` at ``(axis, axis+1)``
    -> one global axis ``m*p+1`` with overlap-added shared nodes. Exact
    reverse of :func:`split_axis`; replaces atomics/coloring with a dense
    shifted add."""
    axis = axis % v.ndim
    v = jnp.moveaxis(v, (axis, axis + 1), (-2, -1))
    m = v.shape[-2]
    a = v[..., :p]  # [..., m, p]
    b = v[..., p]  # [..., m] last local node of each element
    # node e*p (e >= 1) receives a[e, 0] + b[e-1]; node 0 receives a[0, 0]
    shifted = jnp.concatenate([jnp.zeros_like(b[..., :1]), b[..., :-1]], axis=-1)
    first = a[..., 0] + shifted
    body = jnp.concatenate([first[..., None], a[..., 1:]], axis=-1)
    out = jnp.concatenate(
        [body.reshape(body.shape[:-2] + (m * p,)), b[..., -1:]], axis=-1
    )  # [..., m*p+1]
    return jnp.moveaxis(out, -1, axis)


def gather_structured(u: jnp.ndarray, n_elements, p: int) -> jnp.ndarray:
    """``[nz, ny, nx]`` global nodal grid -> interleaved element-local tensor
    ``[mz, p+1, my, p+1, mx, p+1]``."""
    mx, my, mz = n_elements
    u = split_axis(u, 0, mz, p)  # [mz, p1, ny, nx]
    u = split_axis(u, 2, my, p)  # [mz, p1, my, p1, nx]
    u = split_axis(u, 4, mx, p)  # [mz, p1, my, p1, mx, p1]
    return u


def scatter_structured(v: jnp.ndarray, p: int) -> jnp.ndarray:
    """Inverse overlap-add of :func:`gather_structured`:
    ``[mz, p+1, my, p+1, mx, p+1]`` -> ``[nz, ny, nx]``."""
    v = join_axis(v, 4, p)  # [mz, p1, my, p1, nx]
    v = join_axis(v, 2, p)  # [mz, p1, ny, nx]
    v = join_axis(v, 0, p)  # [nz, ny, nx]
    return v


# --------------------------------------------------------------------- #
# indexed (general) backend
# --------------------------------------------------------------------- #
def gather_indexed(u: jnp.ndarray, elem_dof_map: jnp.ndarray, p: int) -> jnp.ndarray:
    """``read_dof_values`` via explicit map: ``[n_dofs]`` -> ``[E, p+1, p+1,
    p+1]`` (local order z, y, x with x fastest, matching
    ``mesh.element_dof_map``)."""
    e = elem_dof_map.shape[0]
    return jnp.take(u, elem_dof_map, axis=0).reshape(e, p + 1, p + 1, p + 1)


def scatter_indexed(
    v: jnp.ndarray, elem_dof_map: jnp.ndarray, n_dofs: int
) -> jnp.ndarray:
    """``distribute_local_to_global``: scatter-add of duplicate indices
    (atomics on the GPU: summation order may vary between runs)."""
    flat_idx = elem_dof_map.reshape(-1)
    flat_val = v.reshape(-1)
    return jnp.zeros((n_dofs,), dtype=v.dtype).at[flat_idx].add(flat_val)


def make_scatter_plan(elem_dof_map, n_dofs: int):
    """Host-side sort plan for the duplicate-index scatter-add: gathering
    by a precomputed permutation (unique indices) and summing SORTED
    segments is the alternative to a raw ``.at[idx].add`` with millions of
    duplicate indices. Returns ``(order, sorted_ids, flat_idx)`` int32
    device arrays for :func:`scatter_indexed_sorted`.

    Which variant is faster on the GPU is not measured; the raw
    ``.at[].add`` is the default and ``DLCG_SCATTER_MODE=sorted`` forces
    the plan path. On the GPU the raw scatter-add uses atomics, so its
    summation order (and the last bits of its result) can change from
    run to run; the sorted plan sums in a fixed order."""
    import numpy as np

    flat = np.asarray(elem_dof_map).reshape(-1).astype(np.int32)
    order = np.argsort(flat, kind="stable")
    return (
        jnp.asarray(order.astype(np.int32)),
        jnp.asarray(flat[order]),
        jnp.asarray(flat),
    )


def scatter_mode() -> str:
    """``raw`` (duplicate-index ``.at[].add``, the default) or ``sorted``
    (permutation + sorted segment-sum) — see :func:`make_scatter_plan`."""
    import os

    return os.environ.get("DLCG_SCATTER_MODE", "raw")


def scatter_indexed_sorted(v: jnp.ndarray, plan, n_dofs: int) -> jnp.ndarray:
    """:func:`scatter_indexed` through a :func:`make_scatter_plan` — same
    result up to summation order (only the sorted segment-sum fixes that
    order on the GPU)."""
    import jax

    if len(plan) == 3 and scatter_mode() == "raw":
        return jnp.zeros((n_dofs,), dtype=v.dtype).at[plan[2]].add(
            v.reshape(-1)
        )
    order, ids = plan[0], plan[1]
    return jax.ops.segment_sum(
        v.reshape(-1)[order], ids, n_dofs, indices_are_sorted=True
    )
