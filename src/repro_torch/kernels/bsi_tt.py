"""Forward BSI in the TT form: the CUDA kernel's launch and its plain version.

The kernel (``csrc/bsi_tt.cu``) replaces the JAX package's Pallas kernel
``repro/kernels/bsi_tt.py:bsi_tt_pallas``, the paper's thread-per-tile form
(§3.2).  A thread block owns a block of tiles and stages its control window
and the three ``(d, 4)`` weight LUTs in shared memory; a thread holds one
(tile, channel)'s 64 control values in registers and forms each voxel's
value as the 64 terms ``window[k] * ((wx[a,l] * wy[b,m]) * wz[c,n])`` added
in ``l, m, n`` order, writing only the voxels inside the volume.
:func:`plain` is :func:`repro_torch.core.interpolate.bsi_tt` cropped, which
rounds every product and sum as the kernel does; ``kernels.ops.bsi_tt``
picks between the two by the tensor's device.
"""

from __future__ import annotations

import torch

from repro_torch.core.interpolate import bsi_tt
from repro_torch.kernels.build import load_library
from repro_torch.kernels.bsi_separable import weight_luts
from repro_torch.kernels.bsi_ttli import check_smem

__all__ = ["block_tiles", "check_blocks", "launch", "plain", "smem_bytes"]


def block_tiles(tile) -> tuple:
    """Tiles per block: 4 x 4 x 16, so a block of 256 threads owns 3
    (tile, channel) pairs each at 3 channels, whatever the tile."""
    return (4, 4, 16)


def smem_bytes(tile, blocks, channels) -> int:
    """Shared memory of a block: the weight LUTs and the control window."""
    (dx, dy, dz), (bx, by, bz) = tile, blocks
    return 4 * (4 * (dx + dy + dz) + (bx + 3) * (by + 3) * (bz + 3) * channels)


def check_blocks(tile, blocks, channels):
    """Raise if a block's LUTs and window exceed what a block may use."""
    check_smem(f"the TT kernel at tile {tile}", smem_bytes(tile, blocks, channels))


def launch(phi, out, tile):
    """Launch the kernel on the current stream: ``phi`` -> ``out`` (cropped);
    raises if its blocks do not fit."""
    nx, ny, nz, c = phi.shape
    X, Y, Z, _ = out.shape
    blocks = block_tiles(tile)
    check_blocks(tile, blocks, c)
    lib = load_library()
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        rc = lib.bsi_tt_f32(
            phi.data_ptr(), weight_luts(tile, phi.device).data_ptr(), out.data_ptr(),
            nx, ny, nz, c, *tile, X, Y, Z, *blocks, stream)
    if rc:
        raise RuntimeError(f"bsi_tt kernel launch failed: cudaError_t {rc}")


def plain(phi, tile, vol_shape):
    """The kernel's function in tensor ops: :func:`bsi_tt`, cropped."""
    X, Y, Z = vol_shape
    return bsi_tt(phi, tile)[:X, :Y, :Z]
