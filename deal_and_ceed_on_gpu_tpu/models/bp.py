"""CEED bake-off problem registry: BP1..BP6.

The CEED BPs (Fischer et al., "Scalability of high-performance PDE solvers",
IJHPCA 2020) as configured in BASELINE.json:

| BP  | form      | components | quadrature            |
|-----|-----------|------------|-----------------------|
| BP1 | mass      | 1          | Gauss, q = p+2        |
| BP2 | mass      | 3          | Gauss, q = p+2        |
| BP3 | stiffness | 1          | Gauss, q = p+2        |
| BP4 | stiffness | 3          | Gauss, q = p+2        |
| BP5 | stiffness | 1          | GLL (colloc.), q = p+1|
| BP6 | stiffness | 3          | GLL (colloc.), q = p+1|

The reference implements BP5 (``bp5/step-64.cu``) and carries the
collocation evaluator for it (``bp5/fe_evaluation_gl.h``); the others are
the stated follow-on targets. Here every BP is one registry entry away.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp

from ..fe_space import FESpace
from ..mesh import BrickMesh
from .mass import MassOperator
from .poisson import PoissonOperator
from .vector import VectorOperator

__all__ = ["BP_SPECS", "make_bp_operator", "BPSpec"]


@dataclasses.dataclass(frozen=True)
class BPSpec:
    kind: str  # "mass" | "stiffness"
    n_components: int
    rule: str  # "gauss" | "gauss_lobatto"
    n_q_offset: int  # n_q = p + 1 + offset


BP_SPECS = {
    "bp1": BPSpec("mass", 1, "gauss", 1),
    "bp2": BPSpec("mass", 3, "gauss", 1),
    "bp3": BPSpec("stiffness", 1, "gauss", 1),
    "bp4": BPSpec("stiffness", 3, "gauss", 1),
    "bp5": BPSpec("stiffness", 1, "gauss_lobatto", 0),
    "bp6": BPSpec("stiffness", 3, "gauss_lobatto", 0),
}


def make_bp_operator(
    bp: str,
    mesh: BrickMesh,
    degree: int,
    dtype=jnp.float32,
    backend: Optional[str] = None,
):
    """Build (space, operator) for a named bake-off problem.

    backend=None picks the fast path: separable for uniform-mesh scalar
    forms, wrapped per component for the vector BPs.
    """
    spec = BP_SPECS[bp.lower()]
    space = FESpace.create(
        mesh, degree, n_q=degree + 1 + spec.n_q_offset, rule=spec.rule, dtype=dtype
    )
    backend = backend or "separable"
    if spec.kind == "mass":
        op = MassOperator(space, backend=backend)
    else:
        op = PoissonOperator(space, backend=backend)
    if spec.n_components > 1:
        return space, VectorOperator(op, spec.n_components)
    return space, op
