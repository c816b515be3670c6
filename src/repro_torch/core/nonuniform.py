"""Non-uniform control grids: real-valued spacing per axis (the paper's §8
future work).

The aligned implementations need integer tile sizes, so every per-axis
weight is a LUT entry.  Here the spacing is any real number per axis and
the weights are computed on the fly per voxel (``bspline_basis``).  Spacing
is per axis, so the weights still factorise into three ``(len, 4)``
matrices:

    out[x, y, z] = sum_{l,m,n} Wx[x,l] * Wy[y,m] * Wz[z,n]
                               * phi[ix[x]+l, iy[y]+m, iz[z]+n]

Each axis's base indices and weights are computed once (``O(len * 4)``);
the gather is per voxel.  Plain tensor code on the device of ``phi``, with
the JAX package's term order (``l``, ``m``, ``n`` loops, clamped gathers);
the JAX package has no kernel here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.bspline import bspline_basis

__all__ = ["axis_weights", "bsi_nonuniform", "grid_points_for_spacing"]


def grid_points_for_spacing(vol_shape, spacing) -> tuple:
    """Stored control points per axis for real-valued ``spacing`` (the
    quotient rounded up in float32, as the JAX package computes it)."""
    return tuple(math.ceil(np.float32(s / d)) + 3 for s, d in zip(vol_shape, spacing))


def axis_weights(length, delta, dtype=torch.float32, device=None):
    """Per-axis base indices and weights for spacing ``delta``.

    Returns ``(idx (length,), W (length, 4))``: ``idx`` the stored base
    control point (+1 offset convention), ``W`` the four basis values at
    each coordinate.
    """
    x = (torch.arange(length, dtype=torch.float32, device=device)
         / torch.tensor(float(delta), dtype=torch.float32, device=device))
    base = torch.floor(x)
    return base.to(torch.int64), bspline_basis(x - base, dtype)


def bsi_nonuniform(phi, spacing, vol_shape):
    """Dense field from a control grid at real-valued spacing.

    ``phi`` is the ``(nx, ny, nz, C)`` stored grid (+1 offset convention),
    ``spacing`` three floats (voxels per control interval), ``vol_shape``
    the output volume's shape.  Returns ``vol_shape + (C,)``;
    differentiable in ``phi``.
    """
    X, Y, Z = (int(s) for s in vol_shape)
    ix, wx = axis_weights(X, spacing[0], phi.dtype, phi.device)
    iy, wy = axis_weights(Y, spacing[1], phi.dtype, phi.device)
    iz, wz = axis_weights(Z, spacing[2], phi.dtype, phi.device)
    nx, ny, nz = phi.shape[:3]
    out = torch.zeros((X, Y, Z, phi.shape[-1]), dtype=phi.dtype, device=phi.device)
    # 64 gathers, as the aligned gather form, with per-voxel bases
    for l in range(4):
        gx = torch.clamp(ix + l, 0, nx - 1)
        for m in range(4):
            gy = torch.clamp(iy + m, 0, ny - 1)
            for n in range(4):
                gz = torch.clamp(iz + n, 0, nz - 1)
                g = phi[gx[:, None, None], gy[None, :, None], gz[None, None, :]]
                w = (wx[:, l][:, None, None] * wy[:, m][None, :, None]
                     * wz[:, n][None, None, :])
                out = out + g * w[..., None]
    return out
