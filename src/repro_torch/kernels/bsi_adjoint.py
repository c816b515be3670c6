"""The BSI adjoint, separable form: the CUDA kernel's launch and its plain version.

The kernel (``csrc/bsi_adjoint.cu``) replaces the JAX package's Pallas kernel
``repro/kernels/bsi_adjoint.py:bsi_adjoint_separable_pallas``: three gather
sweeps (z, then y, then x) contract the cotangent of the dense field against
the ``(d, 4)`` weight LUTs into the control-grid cotangent, masking the voxels
outside the volume instead of padding.  :func:`plain` is the same function in
tensor ops; ``kernels.ops.bsi_adjoint`` picks between the two by the tensor's
device.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.bspline import weight_lut
from repro_torch.core.interpolate import bsi_adjoint
from repro_torch.kernels.build import load_library

__all__ = ["weight_luts", "launch", "plain"]


@functools.lru_cache(maxsize=None)
def weight_luts(tile, device) -> tuple:
    """The three ``(d, 4)`` float32 weight LUTs on ``device``."""
    return tuple(weight_lut(d, torch.float32, device) for d in tile)


def launch(g, out, tile):
    """Launch the three sweeps on the current stream: ``g`` -> ``out``.

    The two intermediates, ``(X, Y, Nz, C)`` and ``(X, Ny, Nz, C)``, are
    allocated here; PyTorch's caching allocator reuses their memory only for
    work queued after these launches on the same stream.
    """
    X, Y, Z, c = g.shape
    nx, ny, nz, _ = out.shape
    hz = torch.empty((X, Y, nz, c), dtype=torch.float32, device=g.device)
    hy = torch.empty((X, ny, nz, c), dtype=torch.float32, device=g.device)
    wx, wy, wz = weight_luts(tile, g.device)
    lib = load_library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = lib.bsi_adjoint_f32(
            g.data_ptr(), wx.data_ptr(), wy.data_ptr(), wz.data_ptr(),
            hz.data_ptr(), hy.data_ptr(), out.data_ptr(),
            X, Y, Z, c, nx, ny, nz, *tile, stream)
    if rc:
        raise RuntimeError(f"bsi_adjoint kernel launch failed: cudaError_t {rc}")


def plain(g, tile, grid_shape):
    """The kernel's function in tensor ops: zero-pad to whole tiles, then
    :func:`repro_torch.core.interpolate.bsi_adjoint_separable`."""
    return bsi_adjoint(g, tile, grid_shape, impl="torch")
