"""jit with ALL captured constants hoisted to arguments.

A ``jax.jit`` that closes over concrete arrays embeds them as inline
constants of the serialized program. For operators whose closures hold
large tables — the adaptive multigrid hierarchy (per-level index maps,
coefficient tables, the dense coarse inverse: ~300 MB at the 853k-DoF
ball-refined mesh) — that is pure waste: the program to compile grows
with the mesh. ``jax.closure_convert`` only hoists INEXACT-dtype constants
(its purpose is AD), so int32 index tables stay embedded; this utility
hoists every jaxpr constant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.extend.core import ClosedJaxpr, jaxpr_as_fun

__all__ = ["jit_hoisted"]


def jit_hoisted(f, *example_args):
    """Return ``g`` with ``g(*args) == f(*args)`` where the jitted
    program takes every array ``f`` closes over as an ARGUMENT instead
    of an inline constant. Traced once with ``example_args`` (same
    shapes/dtypes required at call time, like any jit specialization).
    """
    closed = jax.make_jaxpr(f)(*example_args)
    out_shape = jax.eval_shape(f, *example_args)
    out_tree = jax.tree_util.tree_structure(out_shape)
    consts = [jnp.asarray(c) for c in closed.consts]

    @jax.jit
    def run(consts, args):
        flat = jax.tree_util.tree_leaves(args)
        out_flat = jaxpr_as_fun(ClosedJaxpr(closed.jaxpr, consts))(*flat)
        return jax.tree_util.tree_unflatten(out_tree, out_flat)

    def g(*args):
        return run(consts, args)

    return g
