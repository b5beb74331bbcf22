"""Auto-jit dispatch for the solver entry points.

``solve_cg`` / ``solve_cg_merged`` build their ``lax.while_loop`` from
FRESH closures on every call, so calling them eagerly re-traces and
re-compiles the entire solve each time. The reference never hits this
because its solver is a C++ object compiled once (``bp5/solver.h:15``).

This layer restores compile-once semantics without changing the solver
API: when an entry point is called OUTSIDE a trace, the whole solve is
routed through a ``jax.jit`` wrapper cached on the static call structure

    (solver fn, A, control, callable-preconditioner, extra flags)

Bound methods (``op.vmult``, ``mg.vcycle``) hash by (function, instance),
so repeated calls with the same operator/preconditioner objects hit the
same executable; array arguments (b, diag vector, x0, dot_weight) stay
traced. Inside an existing trace (user ``jit``, ``shard_map`` — where
``b`` is a Tracer) or with unhashable keys, the call runs inline exactly
as before, preserving the distributed ``psum`` paths.

The cache holds strong references to the keyed operator objects (and
their device tables); it is bounded (LRU, 32 entries) so long-lived
processes sweeping many meshes recycle slots.
"""

from __future__ import annotations

import functools

import jax
from jax.extend.core import ClosedJaxpr, jaxpr_as_fun

__all__ = ["dispatch", "invalidate_cache"]


def invalidate_cache() -> None:
    """Drop every cached solver executable. Called by in-place operator
    mutation (``fold_scale``) — the cache keys on operator identity, so a
    mutated operator would otherwise keep hitting executables built from
    its OLD tables and return silently stale solves."""
    _compiled.cache_clear()


def _hashable(x) -> bool:
    try:
        hash(x)
    except TypeError:
        return False
    return True


class _HoistedJit:
    """jit wrapper that hoists every closure constant (operator tables,
    preconditioner hierarchies, dense coarse inverses, ...) into runtime
    arguments. Without this, jit embeds the captured arrays as HLO
    literals: the program to compile grows with the mesh (a 4913-DoF f64
    dense coarse inverse alone is 193 MB). Hoisted, the tables are device
    buffers passed by reference and the program is just the program."""

    def __init__(self, fun):
        self._fun = fun
        self._by_avals = {}

    @staticmethod
    def _key(args):
        return tuple(
            (
                jax.tree_util.tree_structure(a),
                tuple(
                    (x.shape, str(x.dtype))
                    for x in jax.tree_util.tree_leaves(a)
                ),
            )
            for a in args
        )

    def __call__(self, *args):
        key = self._key(args)
        ent = self._by_avals.get(key)
        if ent is None:
            from jax import tree_util

            flat_args, in_tree = tree_util.tree_flatten(args)

            def flat_fun(*flat):
                return self._fun(*tree_util.tree_unflatten(in_tree, flat))

            closed_jaxpr, out_shape = jax.make_jaxpr(
                flat_fun, return_shape=True
            )(*flat_args)
            out_tree = tree_util.tree_structure(out_shape)
            jaxpr = closed_jaxpr.jaxpr
            consts = closed_jaxpr.consts

            def run_hoisted(consts, *flat):
                out_flat = jaxpr_as_fun(ClosedJaxpr(jaxpr, consts))(*flat)
                return tree_util.tree_unflatten(out_tree, out_flat)

            ent = (jax.jit(run_hoisted), consts, in_tree)
            self._by_avals[key] = ent
        jitted, consts, in_tree = ent
        from jax import tree_util

        flat_args, _ = tree_util.tree_flatten(args)
        return jitted(consts, *flat_args)


@functools.lru_cache(maxsize=32)
def _compiled(fn, A, control, diag_c, extra):
    def run(b, diag_v, x0, dot_weight):
        return fn(
            A,
            b,
            control,
            diag=diag_c if diag_c is not None else diag_v,
            x0=x0,
            dot_weight=dot_weight,
            **dict(extra),
        )

    return _HoistedJit(run)


def dispatch(
    fn,
    A,
    b,
    control,
    diag,
    x0,
    dot_weight,
    psum_axis,
    **extra,
):
    """Route a solver call through the jit cache when it is safe to do so;
    otherwise run ``fn`` inline (identical semantics)."""
    inline = (
        isinstance(b, jax.core.Tracer)
        or psum_axis is not None
        or not all(_hashable(k) for k in (A, control, diag if callable(diag) else None))
    )
    if inline:
        return fn(
            A,
            b,
            control,
            diag=diag,
            x0=x0,
            dot_weight=dot_weight,
            psum_axis=psum_axis,
            **extra,
        )
    diag_c = diag if callable(diag) else None
    diag_v = None if callable(diag) else diag
    solver = _compiled(fn, A, control, diag_c, tuple(sorted(extra.items())))
    return solver(b, diag_v, x0, dot_weight)
