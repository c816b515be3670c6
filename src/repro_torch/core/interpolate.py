"""B-spline interpolation: the plain tensor forms, the adjoint and ``interpolate``.

Forms (each computes the same linear function of the control grid)
------------------------------------------------------------------
``gather``     thread-per-voxel analog: every voxel gathers its 64 control
               points and weight-sums them (the oracle).
``tt``         thread-per-tile: 64 weighted sums of tile-shared control
               point slices, the weights as float32 products of the LUTs.
``ttli``       thread-per-tile + the lerp regrouping of paper §3.3: three
               lerps collapse the four neighbours of each axis, x then y then
               z, 63 lerps per voxel.
``separable``  three per-axis contractions against the ``(d, 4)`` LUTs.
``matmul``     the matrix form (Wu & Zou): one ``(d^3, 64) @ (64, C)``
               product per tile against the Kronecker basis.

Gradient path
-------------
``interpolate(..., grad_impl=)`` picks how the expansion differentiates:

``autograd``  plain autodiff of the chosen plain forward (``impl="torch"``).
``torch``     a ``torch.autograd.Function`` whose backward is the plain
              separable adjoint (:func:`bsi_adjoint_separable`).
``cuda``      the same Function with the adjoint kernel
              (``repro_torch.kernels.ops.bsi_adjoint``).
``matmul``    the same Function with the transposed-matmul adjoint kernel
              (``repro_torch.kernels.ops.bsi_adjoint_matmul``; its plain
              version, :func:`bsi_adjoint_matmul`, on a CPU tensor).

BSI is linear, so the Function saves no tensors: the backward needs only the
cotangent, accumulates in fp32 and casts back to the primal dtype; its
forward-mode derivative is the forward, kernel or plain, on the tangent.

Compute dtype
-------------
Every form takes ``dtype`` (None: ``phi``'s), the JAX package's mixed
precision.  Under ``bfloat16`` or ``float16`` (the reduced dtypes) the
contract, kernels and plain forms alike, is: ``phi`` rounded to the dtype
and the LUTs rounded to it as the JAX package rounds them
(``core.bspline``), float32 arithmetic throughout, each value rounded once
to the dtype at its store, to nearest even (fp16 keeps its subnormals); the
field has the dtype.  The analytic adjoints read a reduced cotangent as
float32 (exactly: ``"cuda"`` and ``"matmul"`` in their bf16 and fp16
kernels, ``"torch"`` in the plain adjoint's promotion) and return ``phi``'s
dtype, so float32 parameters get float32 gradients.  The cotangent is the
one the caller's casts hand back, rounded to the dtype as the JAX package
rounds it, neither widened earlier nor scaled nor flushed: at paper scale
most of an fp16 one lies below fp16's smallest subnormal, 5.96e-8, and is 0,
as in the JAX package.  fp16's largest value is 65504; a grid in voxels
and intensities in [0, 1] lie far inside it, and nothing is clamped.  An
explicit ``grad_impl="autograd"`` differentiates the float32-arithmetic
plain form through its casts (the JAX package's ``"xla"`` differentiates its
reduced arithmetic instead, and accumulates in the reduced dtype).
"""

from __future__ import annotations

import torch

from repro_torch.core.bspline import basis_matrix, lerp_luts, weight_lut

__all__ = [
    "bsi_gather",
    "bsi_tt",
    "bsi_ttli",
    "bsi_separable",
    "bsi_matmul",
    "bsi_adjoint_separable",
    "bsi_adjoint_matmul",
    "bsi_adjoint",
    "interpolate",
    "crop_interpolate",
    "as_compute_dtype",
    "compute_dtype_name",
    "COMPUTE_DTYPES",
    "MODES",
    "MODE_NAMES",
    "IMPLS",
    "KERNEL_MODES",
    "GRAD_IMPLS",
]


# compute dtypes of the forward, the JAX package's
COMPUTE_DTYPES = ("float32", "bfloat16", "float16")


def compute_dtype_name(dtype):
    """A compute dtype (None, a torch dtype or its name) as its canonical
    name, or None; anything outside :data:`COMPUTE_DTYPES` raises
    ``ValueError``."""
    if dtype is None:
        return None
    name = str(dtype).removeprefix("torch.")
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES} or None, "
                         f"got {dtype!r}")
    return name


def as_compute_dtype(dtype):
    """A compute dtype as a torch dtype, or None (:func:`compute_dtype_name`)."""
    name = compute_dtype_name(dtype)
    return None if name is None else getattr(torch, name)


def _operands(phi, dtype):
    """``(phi, st, dt)``: ``phi`` rounded to the compute dtype ``st`` (None:
    its own), the field's, and widened to the arithmetic dtype ``dt``,
    float32 or wider."""
    st = phi.dtype if dtype is None else dtype
    dt = torch.promote_types(st, torch.float32)
    return phi.to(st).to(dt), st, dt


def _dims(phi, tile):
    dx, dy, dz = (int(t) for t in tile)
    tx, ty, tz = (int(n) - 3 for n in phi.shape[:3])
    if min(tx, ty, tz) < 1:
        raise ValueError(f"control grid {tuple(phi.shape)} too small for any tile")
    return (dx, dy, dz), (tx, ty, tz), phi.shape[3]


def bsi_gather(phi, tile, dtype=None):
    """Thread-per-voxel analog: per-voxel 64-point gather + weighted sum."""
    phi, st, dt = _operands(phi, dtype)
    (dx, dy, dz), (tx, ty, tz), c = _dims(phi, tile)
    dev = phi.device
    wx, wy, wz = (weight_lut(d, st, dev).to(dt) for d in (dx, dy, dz))
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
    return out.to(st)


def bsi_tt(phi, tile, dtype=None):
    """Thread-per-tile form: tile-shared control-point slices, 64 weighted sums."""
    phi, st, dt = _operands(phi, dtype)
    (dx, dy, dz), (tx, ty, tz), c = _dims(phi, tile)
    dev = phi.device
    wx, wy, wz = (weight_lut(d, st, dev).to(dt) for d in (dx, dy, dz))

    out = torch.zeros((tx, dx, ty, dy, tz, dz, c), dtype=dt, device=dev)
    for l in range(4):
        for m in range(4):
            for n in range(4):
                sl = phi[l : l + tx, m : m + ty, n : n + tz]  # shared by the tile
                w = (wx[:, l][:, None, None] * wy[:, m][None, :, None]
                     * wz[:, n][None, None, :]).reshape(1, dx, 1, dy, 1, dz, 1)
                out = out + sl[:, None, :, None, :, None, :] * w
    return out.reshape(tx * dx, ty * dy, tz * dz, c).to(st)


def _lerp(a, b, t):
    return a + t * (b - a)


def bsi_ttli(phi, tile, dtype=None):
    """TT + lerp reformulation (paper §3.3, App. B): 63 lerps per voxel.

    Axis-staged pairwise lerps: three lerps collapse the four x-neighbours,
    then y, then z, in the order of the TTLI kernel.
    """
    phi, st, dt = _operands(phi, dtype)
    (dx, dy, dz), (tx, ty, tz), c = _dims(phi, tile)
    dev = phi.device
    t0x, t1x, sx = (t.to(dt) for t in lerp_luts(dx, st, dev))
    t0y, t1y, sy = (t.to(dt) for t in lerp_luts(dy, st, dev))
    t0z, t1z, sz = (t.to(dt) for t in lerp_luts(dz, st, dev))

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
    return _lerp(h01, h23, r(sz)).reshape(tx * dx, ty * dy, tz * dz, c).to(st)


def bsi_separable(phi, tile, dtype=None):
    """Three per-axis tensor contractions against the ``(d, 4)`` LUTs."""
    phi, st, dt = _operands(phi, dtype)
    (dx, dy, dz), (tx, ty, tz), c = _dims(phi, tile)
    dev = phi.device
    wx, wy, wz = (weight_lut(d, st, dev).to(dt) for d in (dx, dy, dz))

    px = torch.stack([phi[l : l + tx] for l in range(4)])  # (4, tx, Y, Z, C)
    hx = torch.einsum("al,ltyzc->tayzc", wx, px).reshape(tx * dx, ty + 3, tz + 3, c)
    py = torch.stack([hx[:, m : m + ty] for m in range(4)])  # (4, X, ty, Z, C)
    hy = torch.einsum("bm,mxtzc->xtbzc", wy, py).reshape(tx * dx, ty * dy, tz + 3, c)
    pz = torch.stack([hy[:, :, n : n + tz] for n in range(4)])  # (4, X, Y, tz, C)
    hz = torch.einsum("cn,nxytk->xytck", wz, pz)
    return hz.reshape(tx * dx, ty * dy, tz * dz, c).to(st)


def bsi_matmul(phi, tile, dtype=None):
    """Matrix form (Wu & Zou): one ``(d^3, 64) @ (64, C)`` product per tile.

    The 64 shifted views of the control grid are the per-tile column matrix;
    the Kronecker basis (:func:`~repro_torch.core.bspline.basis_matrix`)
    contracts them in one product.
    """
    phi, st, dt = _operands(phi, dtype)
    (dx, dy, dz), (tx, ty, tz), c = _dims(phi, tile)
    b = basis_matrix((dx, dy, dz), st, phi.device).to(dt)  # (d^3, 64)
    win = torch.stack([
        phi[l : l + tx, m : m + ty, n : n + tz]
        for l in range(4) for m in range(4) for n in range(4)
    ], dim=3)  # (tx, ty, tz, 64, C)
    h = torch.einsum("vk,xyzkc->vxyzc", b, win).reshape(dx, dy, dz, tx, ty, tz, c)
    return h.permute(3, 0, 4, 1, 5, 2, 6).reshape(tx * dx, ty * dy, tz * dz, c).to(st)


MODES = {
    "gather": bsi_gather,
    "tt": bsi_tt,
    "ttli": bsi_ttli,
    "separable": bsi_separable,
    "matmul": bsi_matmul,
}
MODE_NAMES = tuple(sorted(MODES))

# Forward implementations: the plain tensor forms, or the hand-written
# kernel of the mode.
IMPLS = ("torch", "cuda")
# Modes with a forward kernel (the JAX package's ``PALLAS_MODES``; ``gather``
# is the oracle the kernels beat).
KERNEL_MODES = ("tt", "ttli", "separable", "matmul")

# "autograd" is plain autodiff of the forward; the others are the analytic
# adjoint as a plain tensor form ("torch"), as the separable kernel ("cuda")
# or as the transposed-matmul kernel ("matmul").
GRAD_IMPLS = ("autograd", "torch", "cuda", "matmul")


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


def bsi_adjoint_matmul(g, tile):
    """Transposed matrix form of :func:`bsi_matmul`; contract as
    :func:`bsi_adjoint_separable`.

    ``c4[t, k] = sum_v B[v, k] * g[t, v]``, one ``(64, d^3) @ (d^3, T*C)``
    product, then the 64-band overlap-add that lands tile ``t``'s band
    ``(l, m, n)`` on control point ``t + (l, m, n)``.
    """
    dtype = torch.promote_types(g.dtype, torch.float32)
    dx, dy, dz = (int(t) for t in tile)
    X, Y, Z, c = g.shape
    if X % dx or Y % dy or Z % dz:
        raise ValueError(f"cotangent shape {tuple(g.shape)} not a multiple of {tile}")
    tx, ty, tz = X // dx, Y // dy, Z // dz
    b = basis_matrix((dx, dy, dz), dtype, g.device)  # (d^3, 64)
    u = g.to(dtype).reshape(tx, dx, ty, dy, tz, dz, c).permute(0, 2, 4, 1, 3, 5, 6)
    u = u.reshape(tx, ty, tz, dx * dy * dz, c)
    c4 = torch.einsum("vk,xyzvc->kxyzc", b, u).reshape(4, 4, 4, tx, ty, tz, c)
    out = torch.zeros((tx + 3, ty + 3, tz + 3, c), dtype=dtype, device=g.device)
    for l in range(4):
        for m in range(4):
            for n in range(4):
                out[l : l + tx, m : m + ty, n : n + tz] += c4[l, m, n]
    return out


def _pad_to_tiles(g, tile, grid_shape):
    full = [(int(n) - 3) * int(d) for n, d in zip(grid_shape, tile)]
    for axis, (n, s) in enumerate(zip(full, g.shape[:3])):
        if s != n:
            g = _pad_axis(g, axis, 0, n - s)
    return g


def bsi_adjoint(g, tile, grid_shape, *, impl="torch"):
    """The analytic adjoint of a cropped expansion, as ``impl`` computes it.

    ``g`` is the cotangent of the field cropped to the volume (any extent up
    to ``(grid_shape - 3) * tile``); the result is the ``grid_shape + (C,)``
    float32 cotangent of the control grid.  ``impl="torch"`` zero-pads ``g``
    to whole tiles and runs :func:`bsi_adjoint_separable`; ``impl="cuda"``
    and ``impl="matmul"`` run the separable and the transposed-matmul
    adjoint kernels, which mask the voxels outside the volume.
    """
    if impl in ("cuda", "matmul"):
        from repro_torch.kernels import ops  # kernels import this module

        fn = ops.bsi_adjoint if impl == "cuda" else ops.bsi_adjoint_matmul
        return fn(g, tile, grid_shape)
    if impl != "torch":
        raise ValueError(f"unknown adjoint impl {impl!r}")
    return bsi_adjoint_separable(_pad_to_tiles(g, tile, grid_shape), tile)


def _forward(phi, tile, vol_shape, mode, impl, dtype):
    if impl == "cuda":
        if mode not in KERNEL_MODES:
            raise ValueError(
                f"mode {mode!r} has no kernel; impl='cuda' runs modes {KERNEL_MODES}")
        from repro_torch.kernels import ops  # kernels import this module

        # the kernel of phi's dtype: the grid is rounded to the compute dtype
        # first, as the JAX package's kernels receive it
        phi = phi if dtype is None else phi.to(dtype)
        return ops.FORWARD_KERNELS[mode](phi, tile, vol_shape)
    if impl != "torch":
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    X, Y, Z = vol_shape
    return MODES[mode](phi, tile, dtype)[:X, :Y, :Z]


class _AnalyticBsi(torch.autograd.Function):
    """BSI with the analytic adjoint as its backward; saves no tensors.

    BSI is linear in the grid, so its forward-mode derivative (``jvp``, for
    ``torch.func.jvp`` and dual tensors) is the same Function, kernel or
    plain, applied to the tangent.  It goes through ``apply`` again:
    ``torch.func`` hands the rule a wrapped tangent with no storage of its
    own, which only a Function call unwraps for the kernel.
    """

    @staticmethod
    def forward(phi, tile, vol_shape, mode, impl, grad_impl, dtype):
        return _forward(phi, tile, vol_shape, mode, impl, dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        phi, tile, vol_shape, mode, impl, grad_impl, dtype = inputs
        ctx.conf = (tile, tuple(phi.shape[:3]), grad_impl, phi.dtype)
        ctx.fwd = (tile, vol_shape, mode, impl, grad_impl, dtype)

    @staticmethod
    def backward(ctx, g):
        tile, grid_shape, grad_impl, dtype = ctx.conf
        # the adjoints read a reduced cotangent themselves (the kernels widen
        # each value as they load it, the plain forms promote), as the JAX
        # package's Pallas adjoints do
        g = g.contiguous()
        dphi = bsi_adjoint(g, tile, grid_shape, impl=grad_impl)
        return dphi.to(dtype), None, None, None, None, None, None

    @staticmethod
    def jvp(ctx, phi_t, *_):
        return _AnalyticBsi.apply(phi_t.contiguous(), *ctx.fwd)


def crop_interpolate(phi, tile, vol_shape, *, mode="separable", impl="torch",
                     grad_impl="autograd", dtype=None):
    """:func:`interpolate` cropped to ``vol_shape`` voxels.

    With the kernels the crop costs nothing: the forward kernels write only
    the voxels inside the volume and the adjoint kernels read only those.
    """
    dtype = as_compute_dtype(dtype)
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
                f"{impl!r} forward has no autograd graph, use grad_impl='cuda', "
                "'matmul' or 'torch'"
            )
        return _forward(phi, tile, vol_shape, mode, impl, dtype)
    return _AnalyticBsi.apply(phi, tile, vol_shape, mode, impl, grad_impl, dtype)


def interpolate(phi, tile, *, mode="separable", impl="torch", dtype=None,
                grad_impl="autograd"):
    """Interpolate a control grid to a dense field.

    Args:
      phi: ``(Tx+3, Ty+3, Tz+3, C)`` control grid (aligned, +1 offset).
      tile: ``(dx, dy, dz)`` control-point spacing in voxels.
      mode: one of ``MODE_NAMES``.
      impl: ``torch`` (the plain forms) or ``cuda`` (the mode's kernel, for
        every mode but ``gather``; its plain version on a CPU tensor).
      dtype: compute dtype (None: ``phi``'s; ``"bfloat16"``, ``"float16"``
        or ``"float32"``, module docstring); the field takes it, gradients
        stay in ``phi``'s.
      grad_impl: ``autograd``, ``torch``, ``cuda`` or ``matmul`` (module
        docstring).

    Returns:
      ``(Tx*dx, Ty*dy, Tz*dz, C)`` dense field.
    """
    (dx, dy, dz), (tx, ty, tz), _ = _dims(phi, tile)
    return crop_interpolate(phi, tile, (tx * dx, ty * dy, tz * dz), mode=mode,
                            impl=impl, grad_impl=grad_impl, dtype=dtype)
