"""Transforms: how the control grid becomes a displacement field.

Two models, as in the JAX package:

``displacement``
    Classic FFD: the BSI expansion is the displacement (the default).

``velocity``
    A stationary velocity field: the expansion is a velocity ``v`` and the
    displacement is the time-1 flow ``exp(v) - id``, by scaling and
    squaring (``u_0 = v / 2^K``, then ``K`` self-compositions
    ``u <- u o (id + u) + u``).  The flow is invertible (integrate ``-v``)
    and fold-free.  Each composition samples the three channels of ``u`` at
    one set of coordinates with one set of corner indices
    (``ffd.trilinear_sample``), and under autograd it is recomputed in the
    backward (``torch.utils.checkpoint``), so a squaring keeps only its
    input, one ``(X, Y, Z, 3)`` field.

Specs are frozen dataclasses; ``velocity(squarings=4)`` builds variants.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import ffd
from repro_torch.core.registry import Registry

__all__ = ["TRANSFORMS", "DisplacementTransform", "VelocityTransform",
           "available_transforms", "compose_displacement", "dense_displacement",
           "displacement", "jacobian_determinant", "resolve_transform",
           "scaling_and_squaring", "transform_token", "velocity"]


@dataclasses.dataclass(frozen=True)
class DisplacementTransform:
    """Classic FFD: the BSI expansion is the displacement."""

    name = "displacement"


@dataclasses.dataclass(frozen=True)
class VelocityTransform:
    """A stationary velocity field integrated by ``squarings`` doublings."""

    name = "velocity"
    squarings: int = 6

    def __post_init__(self):
        k = int(self.squarings)
        if not 1 <= k <= 12:
            raise ValueError(
                f"velocity squarings must be in [1, 12], got {self.squarings!r}")
        object.__setattr__(self, "squarings", k)


TRANSFORMS = Registry(
    "transform",
    passthrough=lambda o: isinstance(o, (DisplacementTransform, VelocityTransform)))


def displacement() -> DisplacementTransform:
    """The classic-FFD transform spec (the default)."""
    return DisplacementTransform()


def velocity(squarings=6) -> VelocityTransform:
    """A stationary-velocity-field transform spec."""
    return VelocityTransform(squarings=squarings)


TRANSFORMS.register("displacement", DisplacementTransform())
TRANSFORMS.register("velocity", VelocityTransform())


def available_transforms():
    """Sorted names of the registered transforms."""
    return TRANSFORMS.names()


def resolve_transform(transform):
    """Resolve a name-or-spec to its frozen spec instance."""
    _, spec = TRANSFORMS.resolve(transform)
    return spec


def transform_token(transform) -> str:
    """A short string naming the transform for cache keys and logs."""
    spec = resolve_transform(transform)
    if isinstance(spec, VelocityTransform):
        return f"velocity(squarings={spec.squarings})"
    return "displacement"


def _compose(u, v, ident):
    return v + ffd.trilinear_sample(u, ident + v)


def compose_displacement(u, v):
    """The displacement of ``(id + u) o (id + v)``: ``v(x) + u(x + v(x))``,
    ``u`` sampled by the clamped trilinear evaluation of ``ffd.warp_volume``.
    Fields are ``(X, Y, Z, 3)`` in voxel units."""
    dtype = torch.promote_types(v.dtype, torch.float32)
    u, v = u.to(dtype), v.to(dtype)
    return _compose(u, v, ffd.identity_grid(v.shape[:3], dtype, v.device))


def scaling_and_squaring(vel, squarings):
    """The time-1 displacement of the stationary velocity ``vel``:
    ``vel / 2^K`` composed with itself ``K`` times.  Under autograd each
    composition is recomputed in the backward instead of saved."""
    k = int(squarings)
    u = vel.to(torch.promote_types(vel.dtype, torch.float32)) / (2.0 ** k)
    ident = ffd.identity_grid(u.shape[:3], u.dtype, u.device)
    for _ in range(k):
        if torch.is_grad_enabled() and u.requires_grad:
            u = checkpoint(_compose, u, u, ident, use_reentrant=False)
        else:
            u = _compose(u, u, ident)
    return u


def dense_displacement(transform, phi, tile, vol_shape, *, mode="separable",
                       impl="torch", grad_impl="autograd", compute_dtype=None,
                       inverse=False):
    """Control grid -> dense displacement field under ``transform``.

    ``displacement`` returns the BSI expansion; ``velocity`` integrates it
    by scaling and squaring.  ``mode``, ``impl``, ``grad_impl`` and
    ``compute_dtype`` configure the expansion as in ``ffd.dense_field``; the
    compositions run in float32 coordinates, like the warp.
    ``inverse=True`` returns the inverse map's displacement: for
    ``velocity`` the flow of ``-v``; ``displacement`` has none and raises.
    """
    spec = resolve_transform(transform)
    if isinstance(spec, DisplacementTransform) and inverse:
        raise ValueError(
            "the displacement (classic FFD) transform has no analytic inverse; "
            "use transform='velocity' for invertible fields")
    field = ffd.dense_field(phi, tile, vol_shape, mode=mode, impl=impl,
                            grad_impl=grad_impl, compute_dtype=compute_dtype)
    if isinstance(spec, DisplacementTransform):
        return field
    return scaling_and_squaring(-field if inverse else field, spec.squarings)


def jacobian_determinant(disp):
    """Per-voxel Jacobian determinant of ``id + disp``: central differences
    inside, one-sided at the borders (``torch.gradient``, the stencil of
    ``jnp.gradient``).  ``min > 0`` means the map folds nowhere."""
    disp = disp.to(torch.float32)
    # j[c][a] = d(x + u)_c / d x_a
    j = [[g + (1.0 if a == c else 0.0)
          for a, g in enumerate(torch.gradient(disp[..., c], dim=(0, 1, 2)))]
         for c in range(3)]
    return (j[0][0] * (j[1][1] * j[2][2] - j[1][2] * j[2][1])
            - j[0][1] * (j[1][0] * j[2][2] - j[1][2] * j[2][0])
            + j[0][2] * (j[1][0] * j[2][1] - j[1][1] * j[2][0]))
