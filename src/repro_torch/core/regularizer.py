"""Regularizers: the smoothness term of the level objective.

``none`` keeps the legacy ``bending_weight * bending_energy`` proxy, the
default of the JAX package.  The analytic B-spline bending energy
(``bending``) is not in the package yet (ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import ffd
from repro_torch.core.registry import Registry

__all__ = ["REGULARIZERS", "NoRegularizer", "regularizer_term", "resolve_regularizer"]


@dataclasses.dataclass(frozen=True)
class NoRegularizer:
    """No analytic regularizer (the legacy ``bending_weight`` proxy stays)."""

    name = "none"


REGULARIZERS = Registry("regularizer")
REGULARIZERS.register("none", NoRegularizer())


def resolve_regularizer(regularizer):
    """Resolve a name-or-spec to its frozen spec instance."""
    _, spec = REGULARIZERS.resolve(regularizer)
    return spec


def regularizer_term(regularizer, *, grid_shape, tile, bending_weight):
    """The ``phi -> scalar`` regularisation term for one pyramid level."""
    resolve_regularizer(regularizer)
    del grid_shape, tile  # the analytic energy will need them
    bw = float(bending_weight)

    def legacy(p):
        return bw * ffd.bending_energy(p)

    return legacy
