"""Regularizers: the smoothness term of the level objective.

``none`` keeps the legacy ``bending_weight * ffd.bending_energy`` proxy, the
default of the JAX package.  ``bending`` is the exact bending energy of the
cubic B-spline field (Shah et al.), a separable quadratic form on the
control points,

    E = sum over six terms of  phi^T (Gx^dx (x) Gy^dy (x) Gz^dz) phi,

each ``G^d`` the 1-D Gram matrix of d-th basis derivatives (exact 4-point
Gauss-Legendre quadrature).  It *replaces* the proxy at its own weight
(``bending(weight=1e-3)``), and its gradient is the closed form ``2 Q phi``,
a ``torch.autograd.Function`` whose backward is one more separable
application.  The products are three small einsums a term on the control
grid, as the JAX package computes them outside any kernel.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import ffd
from repro_torch.core.registry import Registry

__all__ = ["REGULARIZERS", "BendingRegularizer", "NoRegularizer",
           "available_regularizers", "bending", "bending_energy_fn",
           "bending_gram_matrices", "none", "regularizer_term", "regularizer_token",
           "resolve_regularizer"]


@dataclasses.dataclass(frozen=True)
class NoRegularizer:
    """No analytic regularizer (the legacy ``bending_weight`` proxy stays)."""

    name = "none"


@dataclasses.dataclass(frozen=True)
class BendingRegularizer:
    """The analytic cubic-B-spline bending energy at ``weight``."""

    name = "bending"
    weight: float = 1e-3

    def __post_init__(self):
        w = float(self.weight)
        if not w >= 0:
            raise ValueError(f"bending weight must be >= 0, got {self.weight!r}")
        object.__setattr__(self, "weight", w)


REGULARIZERS = Registry(
    "regularizer",
    passthrough=lambda o: isinstance(o, (NoRegularizer, BendingRegularizer)))


def none() -> NoRegularizer:
    """The no-analytic-regularizer spec (the default)."""
    return NoRegularizer()


def bending(weight=1e-3) -> BendingRegularizer:
    """An analytic-bending-energy spec at ``weight``."""
    return BendingRegularizer(weight=weight)


REGULARIZERS.register("none", NoRegularizer())
REGULARIZERS.register("bending", BendingRegularizer())


def available_regularizers():
    """Sorted names of the registered regularizers."""
    return REGULARIZERS.names()


def resolve_regularizer(regularizer):
    """Resolve a name-or-spec to its frozen spec instance."""
    _, spec = REGULARIZERS.resolve(regularizer)
    return spec


def regularizer_token(regularizer) -> str:
    """A short string naming the regularizer for cache keys and logs."""
    spec = resolve_regularizer(regularizer)
    if isinstance(spec, BendingRegularizer):
        return f"bending(weight={spec.weight:g})"
    return "none"


# Basis convention (as core.interpolate): at tile coordinate s,
# u(s) = sum_i phi_i beta(s - i + 1), beta the cardinal cubic B-spline on
# (-2, 2); a grid of n points spans T = n - 3 tiles, s in [0, T].


def _beta(x, d):
    """The cardinal cubic B-spline's ``d``-th derivative, vectorised numpy."""
    a = np.abs(x)
    s = np.sign(x)
    inner, outer = a <= 1.0, (a > 1.0) & (a < 2.0)
    out = np.zeros_like(x)
    if d == 0:
        out[inner] = 2.0 / 3.0 - a[inner] ** 2 + a[inner] ** 3 / 2.0
        out[outer] = (2.0 - a[outer]) ** 3 / 6.0
    elif d == 1:
        out[inner] = s[inner] * (-2.0 * a[inner] + 1.5 * a[inner] ** 2)
        out[outer] = s[outer] * (-0.5 * (2.0 - a[outer]) ** 2)
    elif d == 2:
        out[inner] = -2.0 + 3.0 * a[inner]
        out[outer] = 2.0 - a[outer]
    else:
        raise ValueError(f"cubic B-spline derivative order {d} not needed")
    return out


@functools.lru_cache(maxsize=None)
def bending_gram_matrices(n):
    """The 1-D Gram matrices ``(G0, G1, G2)`` of an ``n``-point axis.

    ``G^d[i, j]`` integrates ``beta^(d)(s-i+1) beta^(d)(s-j+1)`` over the
    ``n - 3`` tiles: exactly, as the integrand is piecewise polynomial of
    degree <= 6 and each knot interval takes 4-point Gauss-Legendre.
    7-banded and symmetric; float32 numpy arrays.
    """
    n = int(n)
    tiles = n - 3
    if tiles < 1:
        raise ValueError(f"grid axis of {n} points spans no tiles")
    pts, wts = np.polynomial.legendre.leggauss(4)
    t = (pts + 1.0) / 2.0
    w = wts / 2.0
    grams = [np.zeros((n, n)) for _ in range(3)]
    # on [c, c+1] only basis functions c..c+3 are non-zero: N_{c+l}(c+t) = beta(t+1-l)
    vals = [np.stack([_beta(t + 1.0 - l, d) for l in range(4)]) for d in range(3)]
    for c in range(tiles):
        for d in range(3):
            grams[d][c:c + 4, c:c + 4] += np.einsum("iq,jq,q->ij", vals[d], vals[d], w)
    return tuple(g.astype(np.float32) for g in grams)


def _apply_separable(phi, gx, gy, gz):
    """``(Gx (x) Gy (x) Gz) phi`` on a ``(nx, ny, nz, C)`` control grid."""
    out = torch.einsum("ia,abcd->ibcd", gx, phi)
    out = torch.einsum("jb,ibcd->ijcd", gy, out)
    return torch.einsum("kc,ijcd->ijkd", gz, out)


# The six second-derivative terms: (x order, y order, z order, multiplicity).
_BENDING_TERMS = ((2, 0, 0, 1.0), (0, 2, 0, 1.0), (0, 0, 2, 1.0),
                  (1, 1, 0, 2.0), (1, 0, 1, 2.0), (0, 1, 1, 2.0))


class _Energy(torch.autograd.Function):
    """``phi^T Q phi`` with the closed-form backward ``2 Q phi``."""

    @staticmethod
    def forward(p, apply_q):
        qp = apply_q(p)
        return torch.sum(p * qp), qp

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(output[1])

    @staticmethod
    def backward(ctx, g, _):
        (qp,) = ctx.saved_tensors
        return g * 2.0 * qp, None


@functools.lru_cache(maxsize=None)
def bending_energy_fn(grid_shape, tile):
    """``phi -> mean bending-energy density`` for one grid geometry.

    The exact integral over the spline domain, divided by its volume in
    voxels (so weights compare across pyramid levels), with the gradient
    ``2 Q phi`` in closed form.  ``energy.reference`` is the same sum with
    autograd through the products, for tests.
    """
    grid_shape = tuple(int(g) for g in grid_shape)
    tile = tuple(int(t) for t in tile)
    grams = [bending_gram_matrices(n) for n in grid_shape]
    domain = float(np.prod([(n - 3) * h for n, h in zip(grid_shape, tile)]))
    # each axis contributes h^(1 - 2d) (s = x / h); over the domain volume
    scales = [m * float(np.prod([h ** (1 - 2 * d) for h, d in zip(tile, (d1, d2, d3))]))
              / domain for d1, d2, d3, m in _BENDING_TERMS]
    on_device = {}

    def apply_q(p):
        """``Q phi``, the symmetric operator of the quadratic form."""
        key = (p.device, p.dtype)
        if key not in on_device:
            on_device[key] = [[torch.from_numpy(g).to(p.device, p.dtype) for g in axis]
                              for axis in grams]
        gx, gy, gz = on_device[key]
        out = torch.zeros_like(p)
        for (d1, d2, d3, _), s in zip(_BENDING_TERMS, scales):
            out = out + s * _apply_separable(p, gx[d1], gy[d2], gz[d3])
        return out

    def reference(p):
        p = p.to(torch.float32)
        return torch.sum(p * apply_q(p))

    def energy(p):
        return _Energy.apply(p.to(torch.float32), apply_q)[0]

    energy.reference = reference
    energy.apply_q = apply_q
    return energy


def regularizer_term(regularizer, *, grid_shape, tile, bending_weight):
    """The ``phi -> scalar`` regularisation term for one pyramid level.

    ``none``: ``bending_weight * ffd.bending_energy`` (the legacy proxy);
    ``bending``: the analytic energy at the spec's weight, in place of the
    proxy (``bending_weight`` is ignored: the two would regularise the same
    thing twice).
    """
    spec = resolve_regularizer(regularizer)
    if isinstance(spec, BendingRegularizer):
        energy = bending_energy_fn(tuple(grid_shape), tuple(tile))
        weight = spec.weight

        def term(p):
            return weight * energy(p)

        return term

    bw = float(bending_weight)

    def legacy(p):
        return bw * ffd.bending_energy(p)

    return legacy
