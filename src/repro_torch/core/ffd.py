"""Free-Form Deformation: control grid -> dense displacement field -> warp.

The FFD transform (Rueckert et al. 1999, as used by NiftyReg and the paper)
moves a coarse uniform grid of 3-vector control points; BSI expands it to a
dense per-voxel displacement, and the moving volume is resampled trilinearly
at the displaced coordinates.  Volumes are ``(X, Y, Z)`` and fields
``(X, Y, Z, 3)``, channels last, as in the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch.core.interpolate import as_compute_dtype, crop_interpolate

__all__ = [
    "grid_shape_for_volume",
    "dense_field",
    "identity_grid",
    "sample_with_gradient",
    "fused_warp_loss",
    "trilinear_sample",
    "warp_volume",
    "bending_energy",
    "downsample2",
    "upsample_grid",
]


def grid_shape_for_volume(vol_shape, tile) -> tuple:
    """Stored control-grid dims covering ``vol_shape`` at spacing ``tile``."""
    return tuple(-(-int(s) // int(d)) + 3 for s, d in zip(vol_shape, tile))


def downsample2(vol):
    """2x average-pool downsampling (pyramid level)."""
    X, Y, Z = (s - s % 2 for s in vol.shape)
    v = vol[:X, :Y, :Z].reshape(X // 2, 2, Y // 2, 2, Z // 2, 2)
    return v.mean(dim=(1, 3, 5))


def _linspace(start, stop, num, device):
    """``jnp.linspace(start, stop, num)`` in float32: ``start + i * step`` with
    the end point set exactly, as the JAX package builds its coordinates."""
    if num == 1:
        return torch.full((1,), float(start), dtype=torch.float32, device=device)
    step = torch.tensor((stop - start) / (num - 1), dtype=torch.float32)
    i = torch.arange(num, dtype=torch.float32)
    out = torch.tensor(start, dtype=torch.float32) + i * step
    out[-1] = stop
    return out.to(device)


def upsample_grid(phi, new_shape):
    """Upsample a control grid to a finer level's grid shape (trilinear).

    Displacements double at twice the resolution.
    """
    old = phi.shape[:3]
    axes = [_linspace(0.0, o - 1.0, n, phi.device) for o, n in zip(old, new_shape)]
    coords = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    return trilinear_sample(phi, coords) * 2.0


def dense_field(phi, tile, vol_shape, *, mode="separable", impl="torch",
                grad_impl="autograd", compute_dtype=None):
    """Expand a control grid to a dense displacement field cropped to the volume.

    ``impl`` and ``grad_impl`` are as in ``repro_torch.core.interpolate``;
    with ``impl="cuda"`` the crop is fused into the kernel.
    ``compute_dtype`` (``"bfloat16"`` or ``"float16"``) runs the expansion
    in reduced precision, the field in that dtype, while the analytic adjoints
    accumulate in float32 and the gradient takes ``phi``'s dtype.
    """
    return crop_interpolate(phi, tile, vol_shape, mode=mode, impl=impl,
                            grad_impl=grad_impl, dtype=compute_dtype)


class _FusedLoss(torch.autograd.Function):
    """Fused forward, recompute-based backward (``ffd.py:118-150`` of the JAX
    package): the gradient is that of the unfused composition."""

    @staticmethod
    def forward(ctx, phi, moving, fixed, tile, spec, mode, impl, grad_impl, cd):
        from repro_torch.kernels import ops  # kernels import core modules

        ctx.save_for_backward(phi, moving, fixed)
        ctx.conf = (tile, spec, mode, impl, grad_impl, cd)
        disp_form = "matmul" if mode == "matmul" else "lerp"
        if cd is not None:  # the JAX package's casts (its kernels/ops.py:337-339)
            phi, moving, fixed = phi.to(cd), moving.to(cd), fixed.to(torch.float32)
        return ops.fused_similarity_loss(phi, moving, fixed, tile, sim_spec=spec,
                                         disp_form=disp_form)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.similarity import _loss_from_spec

        phi, moving, fixed = ctx.saved_tensors
        tile, spec, mode, impl, grad_impl, cd = ctx.conf
        with torch.enable_grad():
            p = phi.detach().requires_grad_(True)
            disp = dense_field(p, tile, moving.shape, mode=mode, impl=impl,
                               grad_impl=grad_impl, compute_dtype=cd)
            warped = warp_volume(moving, disp, compute_dtype=cd)
            loss = _loss_from_spec(spec)(warped.to(torch.float32),
                                         fixed.to(torch.float32))
            (dphi,) = torch.autograd.grad(loss, p, g)
        return dphi, None, None, None, None, None, None, None, None


def fused_warp_loss(phi, moving, fixed, tile, *, similarity="ssd", mode="separable",
                    impl="torch", grad_impl="autograd", compute_dtype=None):
    """``similarity(warp(moving, bsi(phi)), fixed)`` without a dense field.

    The forward is the fused kernels (``kernels.ops.fused_similarity_loss``;
    their plain versions on the CPU), which evaluate the displacement in the
    matrix form for ``mode="matmul"`` and in the TTLI lerp form for every
    other mode (the JAX package's separable form there: the same function).
    The backward recomputes ``dense_field -> warp_volume -> similarity``
    with ``mode`` / ``impl`` / ``grad_impl`` and returns its gradient, so the
    gradient is the unfused path's.  ``ssd``, ``ncc``, ``lncc`` and ``nmi``
    have fused kernels.  ``compute_dtype`` casts ``phi`` and ``moving`` as
    the unfused pair of knobs does (``fixed`` and the sums stay float32):
    under ``"bfloat16"`` (``"float16"``) the card runs the fused kernels'
    bf16 (fp16) kernels in the form of ``mode``, and the backward's
    recomputed reduced field hands the adjoint of ``grad_impl`` a cotangent
    of its dtype.
    """
    from repro_torch.core.similarity import fused_spec

    spec = fused_spec(similarity)
    if spec is None:
        raise ValueError(
            f"similarity {similarity!r} has no fused kernel; run it unfused "
            "(fused='off')"
        )
    tile = tuple(int(t) for t in tile)
    return _FusedLoss.apply(phi, moving.detach(), fixed.detach(), tile, tuple(spec),
                            mode, impl, grad_impl, as_compute_dtype(compute_dtype))


def identity_grid(shape, dtype=torch.float32, device=None):
    """The voxel coordinates of an ``(X, Y, Z)`` volume, ``(X, Y, Z, 3)``."""
    axes = [torch.arange(s, dtype=dtype, device=device) for s in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def trilinear_sample(vol, coords):
    """Sample ``vol`` (X, Y, Z, *C) at continuous voxel coords ``(..., 3)``.

    Border policy: clamp.  The clamp is ``minimum(maximum(c, 0), n - 1)``, whose
    gradient at a bound is 0.5 as ``jnp.clip``'s is (``torch.clamp`` gives 1):
    at ``phi = 0`` every border voxel sits exactly on a bound.  A corner
    gathers every channel at once, so a field's channels share the corner
    indices (and, under autograd, their saved copies).  Only the coordinates
    carry a gradient when ``vol`` does not require one, so the backward then
    has no scatter into the volume.
    """
    chans = vol.dim() - 3
    # bounds built on the device: a host-to-device copy would synchronise
    hi = torch.stack([coords.new_full((), s - 1.0) for s in vol.shape[:3]])
    c = torch.minimum(torch.maximum(coords, coords.new_zeros(())), hi)
    f = torch.floor(c)
    t = c - f
    i0 = f.long()
    i1 = torch.minimum(i0 + 1, hi.long())

    x0, y0, z0 = i0.unbind(-1)
    x1, y1, z1 = i1.unbind(-1)
    tx, ty, tz = (a.reshape(a.shape + (1,) * chans) for a in t.unbind(-1))
    c00 = vol[x0, y0, z0] * (1 - tx) + vol[x1, y0, z0] * tx
    c01 = vol[x0, y0, z1] * (1 - tx) + vol[x1, y0, z1] * tx
    c10 = vol[x0, y1, z0] * (1 - tx) + vol[x1, y1, z0] * tx
    c11 = vol[x0, y1, z1] * (1 - tx) + vol[x1, y1, z1] * tx
    c0 = c00 * (1 - ty) + c10 * ty
    c1 = c01 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def sample_with_gradient(vol, coords):
    """``trilinear_sample(vol, coords)`` of a volume and its derivative in the
    coordinates, ``(..., 3)``.  A sample depends on its own coordinates
    alone, so one backward with a unit cotangent gives every sample's
    gradient, the clamp's 0.5 at a bound included."""
    with torch.enable_grad():
        c = coords.detach().requires_grad_(True)
        values = trilinear_sample(vol.detach(), c)
        (grad,) = torch.autograd.grad(values, c, torch.ones_like(values))
    return values.detach(), grad


def warp_volume(moving, disp, compute_dtype=None):
    """Resample ``moving`` at identity + displacement (both in voxel units).

    Sampling coordinates are float32 (or the displacement's wider dtype):
    bf16 holds no integer above 256 exactly (fp16 none above 2048), so a
    reduced identity grid would shift the samples of a larger volume by
    whole voxels.  ``compute_dtype`` (``"bfloat16"``, ``"float16"``) casts
    the sampled intensities; the
    interpolation weights stay float32, so the warp comes back float32, as
    in the JAX package.
    """
    coord_dtype = torch.promote_types(disp.dtype, torch.float32)
    cd = as_compute_dtype(compute_dtype)
    if cd is not None:
        moving = moving.to(cd)
    disp = disp.to(coord_dtype)
    ident = identity_grid(moving.shape, coord_dtype, disp.device)
    return trilinear_sample(moving, ident + disp)


def bending_energy(phi):
    """Thin-plate bending energy proxy: second differences on the lattice."""
    e = 0.0
    for ax in range(3):
        d2 = torch.diff(phi, n=2, dim=ax)
        e = e + torch.mean(d2**2)
    for a in range(3):
        for b in range(a + 1, 3):
            d = torch.diff(torch.diff(phi, dim=a), dim=b)
            e = e + 2.0 * torch.mean(d**2)
    return e
