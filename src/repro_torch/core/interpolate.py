"""B-spline interpolation: the plain tensor forms, the adjoint and ``interpolate``.

Forms (each computes the same linear function of the control grid)
------------------------------------------------------------------
``gather``     thread-per-voxel analog: every voxel gathers its 64 control
               points and weight-sums them (the oracle).
``ttli``       thread-per-tile + the lerp regrouping of paper §3.3: three
               lerps collapse the four neighbours of each axis, x then y then
               z, 63 lerps per voxel.
``separable``  three per-axis contractions against the ``(d, 4)`` LUTs.

``tt`` and ``matmul`` are not in the package yet (ROADMAP.md queue 1
item 2).

Gradient path
-------------
``interpolate(..., grad_impl=)`` picks how the expansion differentiates:

``autograd``  plain autodiff of the chosen plain forward (``impl="torch"``).
``torch``     a ``torch.autograd.Function`` whose backward is the plain
              separable adjoint (:func:`bsi_adjoint_separable`).
``cuda``      the same Function with the adjoint kernel
              (``repro_torch.kernels.ops.bsi_adjoint``).

BSI is linear, so the Function saves no tensors: the backward needs only the
cotangent, accumulates in fp32 and casts back to the primal dtype.
"""

from __future__ import annotations

import torch

from repro_torch.core.bspline import lerp_luts, weight_lut

__all__ = [
    "bsi_gather",
    "bsi_ttli",
    "bsi_separable",
    "bsi_adjoint_separable",
    "bsi_adjoint",
    "interpolate",
    "crop_interpolate",
    "MODES",
    "MODE_NAMES",
    "IMPLS",
    "GRAD_IMPLS",
]


def _dims(phi, tile):
    dx, dy, dz = (int(t) for t in tile)
    tx, ty, tz = (int(n) - 3 for n in phi.shape[:3])
    if min(tx, ty, tz) < 1:
        raise ValueError(f"control grid {tuple(phi.shape)} too small for any tile")
    return (dx, dy, dz), (tx, ty, tz), phi.shape[3]


def bsi_gather(phi, tile):
    """Thread-per-voxel analog: per-voxel 64-point gather + weighted sum."""
    (dx, dy, dz), (tx, ty, tz), c = _dims(phi, tile)
    dev, dt = phi.device, phi.dtype
    wx, wy, wz = (weight_lut(d, dt, dev) for d in (dx, dy, dz))
    x = torch.arange(tx * dx, device=dev)
    y = torch.arange(ty * dy, device=dev)
    z = torch.arange(tz * dz, device=dev)
    bx, ax = x // dx, x % dx
    by, ay = y // dy, y % dy
    bz, az = z // dz, z % dz

    out = torch.zeros((tx * dx, ty * dy, tz * dz, c), dtype=dt, device=dev)
    for l in range(4):
        for m in range(4):
            for n in range(4):
                g = phi[
                    (bx + l)[:, None, None],
                    (by + m)[None, :, None],
                    (bz + n)[None, None, :],
                ]
                w = (
                    wx[ax, l][:, None, None]
                    * wy[ay, m][None, :, None]
                    * wz[az, n][None, None, :]
                )
                out = out + g * w[..., None]
    return out


def _lerp(a, b, t):
    return a + t * (b - a)


def bsi_ttli(phi, tile):
    """TT + lerp reformulation (paper §3.3, App. B): 63 lerps per voxel.

    Axis-staged pairwise lerps: three lerps collapse the four x-neighbours,
    then y, then z, in the order of the TTLI kernel.
    """
    (dx, dy, dz), (tx, ty, tz), c = _dims(phi, tile)
    dev, dt = phi.device, phi.dtype
    t0x, t1x, sx = lerp_luts(dx, dt, dev)
    t0y, t1y, sy = lerp_luts(dy, dt, dev)
    t0z, t1z, sz = lerp_luts(dz, dt, dev)

    # x stage: (tx+3, Y, Z, C) -> (tx, dx, Y, Z, C)
    f = [phi[l : l + tx] for l in range(4)]
    r = lambda t: t[None, :, None, None, None]
    h01 = _lerp(f[0][:, None], f[1][:, None], r(t0x))
    h23 = _lerp(f[2][:, None], f[3][:, None], r(t1x))
    hx = _lerp(h01, h23, r(sx)).reshape(tx * dx, ty + 3, tz + 3, c)

    # y stage: (X, ty+3, Z, C) -> (X, ty, dy, Z, C)
    f = [hx[:, m : m + ty] for m in range(4)]
    r = lambda t: t[None, None, :, None, None]
    h01 = _lerp(f[0][:, :, None], f[1][:, :, None], r(t0y))
    h23 = _lerp(f[2][:, :, None], f[3][:, :, None], r(t1y))
    hy = _lerp(h01, h23, r(sy)).reshape(tx * dx, ty * dy, tz + 3, c)

    # z stage
    f = [hy[:, :, n : n + tz] for n in range(4)]
    r = lambda t: t[None, None, None, :, None]
    h01 = _lerp(f[0][:, :, :, None], f[1][:, :, :, None], r(t0z))
    h23 = _lerp(f[2][:, :, :, None], f[3][:, :, :, None], r(t1z))
    return _lerp(h01, h23, r(sz)).reshape(tx * dx, ty * dy, tz * dz, c)


def bsi_separable(phi, tile):
    """Three per-axis tensor contractions against the ``(d, 4)`` LUTs."""
    (dx, dy, dz), (tx, ty, tz), c = _dims(phi, tile)
    dev, dt = phi.device, phi.dtype
    wx, wy, wz = (weight_lut(d, dt, dev) for d in (dx, dy, dz))

    px = torch.stack([phi[l : l + tx] for l in range(4)])  # (4, tx, Y, Z, C)
    hx = torch.einsum("al,ltyzc->tayzc", wx, px).reshape(tx * dx, ty + 3, tz + 3, c)
    py = torch.stack([hx[:, m : m + ty] for m in range(4)])  # (4, X, ty, Z, C)
    hy = torch.einsum("bm,mxtzc->xtbzc", wy, py).reshape(tx * dx, ty * dy, tz + 3, c)
    pz = torch.stack([hy[:, :, n : n + tz] for n in range(4)])  # (4, X, Y, tz, C)
    hz = torch.einsum("cn,nxytk->xytck", wz, pz)
    return hz.reshape(tx * dx, ty * dy, tz * dz, c)


MODES = {
    "gather": bsi_gather,
    "ttli": bsi_ttli,
    "separable": bsi_separable,
}
MODE_NAMES = tuple(sorted(MODES))

# Forward implementations: the plain tensor forms, or the hand-written
# kernel (``ttli`` only in this package so far).
IMPLS = ("torch", "cuda")

# "autograd" is plain autodiff of the forward; the others are the analytic
# adjoint as a plain tensor form ("torch") or as the kernel ("cuda").
GRAD_IMPLS = ("autograd", "torch", "cuda")


def _pad_axis(x, axis, before, after):
    pad = [0, 0] * x.dim()
    k = x.dim() - 1 - axis  # F.pad lists the last dimension first
    pad[2 * k], pad[2 * k + 1] = before, after
    return torch.nn.functional.pad(x, pad)


def bsi_adjoint_separable(g, tile):
    """Transpose of Eq. (1): dense-field cotangent -> control-grid cotangent.

    The separable contraction run in reverse, z then y then x: each sweep
    contracts the in-tile voxel axis against the ``(d, 4)`` LUT and
    overlap-adds the four shifted bands, so every control point's gradient is
    a weighted reduction over its own ``(4*d)^3`` support window.

    Args:
      g: ``(Tx*dx, Ty*dy, Tz*dz, C)`` cotangent of the dense field.
      tile: ``(dx, dy, dz)``.

    Returns:
      ``(Tx+3, Ty+3, Tz+3, C)`` control-grid cotangent, accumulated in float32
      (or the cotangent's wider dtype).
    """
    dtype = torch.promote_types(g.dtype, torch.float32)
    dx, dy, dz = (int(t) for t in tile)
    X, Y, Z, c = g.shape
    if X % dx or Y % dy or Z % dz:
        raise ValueError(f"cotangent shape {tuple(g.shape)} not a multiple of {tile}")
    tx, ty, tz = X // dx, Y // dy, Z // dz
    g = g.to(dtype)
    dev = g.device
    wx, wy, wz = (weight_lut(d, dtype, dev) for d in (dx, dy, dz))

    # z sweep: band n of tile t lands at control index t + n
    cz = torch.einsum("an,xytac->nxytc", wz, g.reshape(X, Y, tz, dz, c))
    hz = sum(_pad_axis(cz[n], 2, n, 3 - n) for n in range(4))
    cy = torch.einsum("am,xtazc->mxtzc", wy, hz.reshape(X, ty, dy, tz + 3, c))
    hy = sum(_pad_axis(cy[m], 1, m, 3 - m) for m in range(4))
    cx = torch.einsum("al,tayzc->ltyzc", wx, hy.reshape(tx, dx, ty + 3, tz + 3, c))
    return sum(_pad_axis(cx[l], 0, l, 3 - l) for l in range(4))


def bsi_adjoint(g, tile, grid_shape, *, impl="torch"):
    """The analytic adjoint of a cropped expansion, as ``impl`` computes it.

    ``g`` is the cotangent of the field cropped to the volume (any extent up
    to ``(grid_shape - 3) * tile``); the result is the ``grid_shape + (C,)``
    float32 cotangent of the control grid.  ``impl="torch"`` zero-pads ``g``
    to whole tiles and runs :func:`bsi_adjoint_separable`; ``impl="cuda"``
    runs the adjoint kernel, which masks the voxels outside the volume.
    """
    if impl == "cuda":
        from repro_torch.kernels import ops  # kernels import this module

        return ops.bsi_adjoint(g, tile, grid_shape)
    if impl != "torch":
        raise ValueError(f"unknown adjoint impl {impl!r}")
    full = [(int(n) - 3) * int(d) for n, d in zip(grid_shape, tile)]
    for axis, (n, s) in enumerate(zip(full, g.shape[:3])):
        if s != n:
            g = _pad_axis(g, axis, 0, n - s)
    return bsi_adjoint_separable(g, tile)


def _forward(phi, tile, vol_shape, mode, impl):
    if impl == "cuda":
        if mode != "ttli":
            raise NotImplementedError(
                f"no CUDA kernel for mode {mode!r} yet (ROADMAP.md queue 2); "
                "impl='cuda' runs mode='ttli'"
            )
        from repro_torch.kernels import ops  # kernels import this module

        return ops.bsi_ttli(phi, tile, vol_shape)
    if impl != "torch":
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    X, Y, Z = vol_shape
    return MODES[mode](phi, tile)[:X, :Y, :Z]


class _AnalyticBsi(torch.autograd.Function):
    """BSI with the analytic adjoint as its backward; saves no tensors."""

    @staticmethod
    def forward(ctx, phi, tile, vol_shape, mode, impl, grad_impl):
        ctx.conf = (tile, tuple(phi.shape[:3]), grad_impl, phi.dtype)
        return _forward(phi, tile, vol_shape, mode, impl)

    @staticmethod
    def backward(ctx, g):
        tile, grid_shape, grad_impl, dtype = ctx.conf
        dphi = bsi_adjoint(g.contiguous(), tile, grid_shape, impl=grad_impl)
        return dphi.to(dtype), None, None, None, None, None


def crop_interpolate(phi, tile, vol_shape, *, mode="separable", impl="torch",
                     grad_impl="autograd"):
    """:func:`interpolate` cropped to ``vol_shape`` voxels.

    With the kernels the crop costs nothing: the TTLI kernel writes only the
    voxels inside the volume and the adjoint kernel reads only those.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODE_NAMES}")
    if grad_impl not in GRAD_IMPLS:
        raise ValueError(f"unknown grad_impl {grad_impl!r}; choose from {GRAD_IMPLS}")
    tile = tuple(int(t) for t in tile)
    vol_shape = tuple(int(s) for s in vol_shape)
    if grad_impl == "autograd":
        if impl != "torch":
            raise ValueError(
                "grad_impl='autograd' differentiates the plain forward; the "
                f"{impl!r} forward has no autograd graph, use grad_impl='cuda' "
                "or 'torch'"
            )
        return _forward(phi, tile, vol_shape, mode, impl)
    return _AnalyticBsi.apply(phi, tile, vol_shape, mode, impl, grad_impl)


def interpolate(phi, tile, *, mode="separable", impl="torch", dtype=None,
                grad_impl="autograd"):
    """Interpolate a control grid to a dense field.

    Args:
      phi: ``(Tx+3, Ty+3, Tz+3, C)`` control grid (aligned, +1 offset).
      tile: ``(dx, dy, dz)`` control-point spacing in voxels.
      mode: one of ``MODE_NAMES``.
      impl: ``torch`` (the plain forms) or ``cuda`` (the TTLI kernel; its
        plain version on a CPU tensor).
      dtype: compute dtype; only float32 (or None) in this package so far.
      grad_impl: ``autograd``, ``torch`` or ``cuda`` (module docstring).

    Returns:
      ``(Tx*dx, Ty*dy, Tz*dz, C)`` dense field.
    """
    if dtype is not None and dtype != torch.float32:
        raise NotImplementedError(
            "reduced-precision BSI is not in the package yet (ROADMAP.md "
            "queue 1 item 18)"
        )
    (dx, dy, dz), (tx, ty, tz), _ = _dims(phi, tile)
    return crop_interpolate(phi, tile, (tx * dx, ty * dy, tz * dz), mode=mode,
                            impl=impl, grad_impl=grad_impl)
