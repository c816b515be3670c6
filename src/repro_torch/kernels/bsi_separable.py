"""Forward BSI in the separable form: the CUDA kernel's launch and its plain version.

The kernel (``csrc/bsi_separable.cu``) replaces the JAX package's Pallas
kernel ``repro/kernels/bsi_separable.py:bsi_separable_pallas``.  A thread
block owns a block of tiles, stages its control window and the three
``(d, 4)`` weight LUTs in shared memory and runs the x, y and z sweeps of
:func:`repro_torch.core.interpolate.bsi_separable`, each output a 4-term
weighted sum of the previous stage, writing only the voxels inside the
volume.  :func:`plain` is the same function in tensor ops;
``kernels.ops.bsi_separable`` picks between the two by the tensor's device.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.bspline import weight_lut
from repro_torch.core.interpolate import bsi_separable
from repro_torch.kernels import bsi_ttli
from repro_torch.kernels.build import load_library

__all__ = ["block_tiles", "check_blocks", "launch", "plain", "weight_luts"]

# The staging of the TTLI kernel, with the weight LUTs in place of its lerp
# LUTs: the same tiles per block.
block_tiles = bsi_ttli.block_tiles


@functools.lru_cache(maxsize=None)
def weight_luts(tile, device) -> torch.Tensor:
    """The ``(d, 4)`` weight LUTs of x, then y, then z, flattened into one
    float32 tensor on ``device``."""
    return torch.cat([weight_lut(d, torch.float32, device).reshape(-1) for d in tile])


def check_blocks(tile, blocks, channels):
    """Raise if the staging of a block exceeds what a block may use."""
    bsi_ttli.check_smem(f"the separable kernel at tile {tile} with {channels} channels",
                        bsi_ttli.stage_smem_bytes(tile, blocks, channels, lut_rows=4))


def launch(phi, out, tile, blocks):
    """Launch the kernel on the current stream: ``phi`` -> ``out`` (cropped)."""
    nx, ny, nz, c = phi.shape
    X, Y, Z, _ = out.shape
    lib = load_library()
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        rc = lib.bsi_separable_f32(
            phi.data_ptr(), weight_luts(tile, phi.device).data_ptr(), out.data_ptr(),
            nx, ny, nz, c, *tile, X, Y, Z, *blocks, stream)
    if rc:
        raise RuntimeError(f"bsi_separable kernel launch failed: cudaError_t {rc}")


def plain(phi, tile, vol_shape):
    """The kernel's function in tensor ops: :func:`bsi_separable`, cropped."""
    X, Y, Z = vol_shape
    return bsi_separable(phi, tile)[:X, :Y, :Z]
