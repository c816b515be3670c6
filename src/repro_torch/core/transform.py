"""Transforms: how the control grid becomes a displacement field.

``displacement`` is classic FFD, the BSI expansion itself.  The stationary
velocity field (``velocity``) is not in the package yet (ROADMAP.md queue 1
item 11).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import ffd
from repro_torch.core.registry import Registry

__all__ = ["TRANSFORMS", "DisplacementTransform", "dense_displacement",
           "resolve_transform"]


@dataclasses.dataclass(frozen=True)
class DisplacementTransform:
    """Classic FFD: the BSI expansion is the displacement."""

    name = "displacement"


TRANSFORMS = Registry("transform")
TRANSFORMS.register("displacement", DisplacementTransform())


def resolve_transform(transform):
    """Resolve a name-or-spec to its frozen spec instance."""
    _, spec = TRANSFORMS.resolve(transform)
    return spec


def dense_displacement(transform, phi, tile, vol_shape, *, mode="separable",
                       impl="torch", grad_impl="autograd"):
    """Control grid -> dense displacement field under ``transform``."""
    resolve_transform(transform)
    return ffd.dense_field(phi, tile, vol_shape, mode=mode, impl=impl,
                           grad_impl=grad_impl)
