"""Vector-valued operators: BP2/BP4/BP6 (3 components per node).

CEED's vector bake-off problems apply the same scalar bilinear form to
``dim`` independent solution components that *share all metric terms*
(BASELINE.json configs). Here unknowns are ``[3, n_dofs]``
arrays and the scalar cell loop is ``vmap``-ed over the leading component
axis — the shared coefficient tables are closure constants, so XLA reads
them once per apply; component batching further widens every contraction.

The CG solvers operate on arbitrary-shaped pytrees-of-one-array, so a
``[3, n]`` vector solves exactly like a flat one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .operator_base import MatrixFreeOperator

__all__ = ["VectorOperator"]


class VectorOperator:
    """Wrap a scalar MatrixFreeOperator into a 3-component operator on
    ``[n_components, n]`` arrays."""

    def __init__(self, scalar_op: MatrixFreeOperator, n_components: int = 3):
        self.scalar_op = scalar_op
        self.n_components = n_components
        self.space = scalar_op.space

    def vmult(self, src: jnp.ndarray) -> jnp.ndarray:
        assert src.shape[0] == self.n_components
        if getattr(self.scalar_op, "backend", None) == "stencil":
            # the kernel does not batch under vmap; three calls cost the
            # same traffic and reuse the same tables
            return jnp.stack(
                [self.scalar_op.vmult(src[c]) for c in range(self.n_components)]
            )
        return jax.vmap(self.scalar_op.vmult)(src)

    def __call__(self, src):
        return self.vmult(src)

    def fold_scale(self, s: float) -> None:
        self.scalar_op.fold_scale(s)

    def diagonal(self) -> jnp.ndarray:
        d = self.scalar_op.diagonal()
        return jnp.broadcast_to(d, (self.n_components,) + d.shape)

    def jacobi_preconditioner(self) -> jnp.ndarray:
        d = self.scalar_op.jacobi_preconditioner()
        return jnp.broadcast_to(d, (self.n_components,) + d.shape)

    def initialize_dof_vector(self) -> jnp.ndarray:
        return jnp.zeros(
            (self.n_components, self.space.n_dofs), dtype=self.space.dtype
        )
