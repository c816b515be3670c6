"""Fused level step with SSD: the CUDA kernel's launch and its plain version.

The kernel (``csrc/bsi_fused.cu``) replaces the JAX package's Pallas kernel
``repro/kernels/bsi_fused.py:bsi_fused_pallas`` with ``sim=("ssd",)``: per
block of tiles it evaluates the displacement in the TTLI lerp form, samples
the moving volume trilinearly at identity + displacement (fp32 coordinates,
clamped to the volume) and sums ``(w - f)^2`` over the voxels of the volume.
Each block writes a partial sum; a second launch sums them in a fixed order.
No dense field and no warped volume reach device memory.

:func:`plain` computes the same function in tensor ops, without autograd:
the lerp-form displacement, the clamped 8-tap sample and the sum.
``kernels.ops.fused_ssd_loss`` picks between the two by the tensor's device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bsi_ttli
from repro_torch.kernels.build import load_library

__all__ = ["launch", "plain", "num_partials"]


def num_partials(vol_shape, tile, blocks) -> int:
    """Thread blocks of the fused launch: one per block of tiles in the volume."""
    n = 1
    for s, d, b in zip(vol_shape, tile, blocks):
        tiles = -(-s // d)
        n *= -(-tiles // b)
    return n


def launch(phi, moving, fixed, tile, blocks):
    """Launch on the current stream; returns the 0-dim sum of squared differences."""
    nx, ny, nz, _ = phi.shape
    X, Y, Z = moving.shape
    n = num_partials(moving.shape, tile, blocks)
    partials = torch.empty(n, dtype=torch.float32, device=phi.device)
    out = torch.empty((), dtype=torch.float32, device=phi.device)
    lib = load_library()
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        rc = lib.bsi_fused_ssd_f32(
            phi.data_ptr(), bsi_ttli.stage_luts(tile, phi.device).data_ptr(),
            moving.data_ptr(), fixed.data_ptr(), partials.data_ptr(), n,
            out.data_ptr(), nx, ny, nz, *tile, X, Y, Z, *blocks, stream)
    if rc:
        raise RuntimeError(f"bsi_fused kernel launch failed: cudaError_t {rc}")
    return out


def plain(phi, moving, fixed, tile):
    """The kernel's function in tensor ops: the sum of squared differences."""
    X, Y, Z = moving.shape
    with torch.no_grad():
        disp = bsi_ttli.plain(phi, tile, (X, Y, Z))
        dev = moving.device
        axes = [torch.arange(s, dtype=torch.float32, device=dev) for s in (X, Y, Z)]
        ident = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32, device=dev)
        c = torch.minimum(torch.clamp(ident + disp, min=0.0), hi)
        f = torch.floor(c)
        t = c - f
        i0 = f.long()
        i1 = torch.minimum(i0 + 1, hi.long())
        flat = moving.reshape(-1)

        def at(ix, iy, iz):
            return flat[(ix * Y + iy) * Z + iz]

        x0, y0, z0 = i0.unbind(-1)
        x1, y1, z1 = i1.unbind(-1)
        tx, ty, tz = t.unbind(-1)
        c00 = at(x0, y0, z0) * (1 - tx) + at(x1, y0, z0) * tx
        c01 = at(x0, y0, z1) * (1 - tx) + at(x1, y0, z1) * tx
        c10 = at(x0, y1, z0) * (1 - tx) + at(x1, y1, z0) * tx
        c11 = at(x0, y1, z1) * (1 - tx) + at(x1, y1, z1) * tx
        c0 = c00 * (1 - ty) + c10 * ty
        c1 = c01 * (1 - ty) + c11 * ty
        w = c0 * (1 - tz) + c1 * tz
        return torch.sum((w - fixed) ** 2)
