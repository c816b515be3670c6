"""Forward BSI in the TTLI form: the CUDA kernel's launch and its plain version.

The kernel (``csrc/bsi_ttli.cu``) replaces the JAX package's Pallas kernel
``repro/kernels/bsi_ttli.py:bsi_ttli_pallas``.  A thread block owns a block
of tiles, stages its control window in shared memory and runs the x, y and z
lerp stages of :func:`repro_torch.core.interpolate.bsi_ttli`, writing only
the voxels inside the volume.  :func:`plain` is the same function in tensor
ops; ``kernels.ops.bsi_ttli`` picks between the two by the tensor's device.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.bspline import lerp_luts
from repro_torch.core.interpolate import bsi_ttli
from repro_torch.kernels.build import load_library

__all__ = ["block_tiles", "check_blocks", "check_smem", "stage_luts", "stage_smem_bytes",
           "launch", "plain"]

MAX_SMEM_BYTES = 232_448  # dynamic shared memory one H100 block may use
KERNEL_THREADS = 256  # threads per block of every BSI kernel (csrc: kThreads)


def block_tiles(tile) -> tuple:
    """Tiles per thread block: about 10 x 10 x 40 voxels whatever the tile."""
    dx, dy, dz = tile
    return (max(1, 10 // dx), max(1, 10 // dy), max(1, 40 // dz))


def stage_smem_bytes(tile, blocks, channels, lut_rows=3) -> int:
    """Shared memory of the staging in ``csrc/bsi_common.cuh``: LUTs, control
    window and y-stage values; ``lut_rows`` LUT values per voxel offset and
    axis (3 lerp LUTs here, 4 weights in ``kernels.bsi_separable``)."""
    (dx, dy, dz), (bx, by, bz), c = tile, blocks, channels
    floats = (lut_rows * (dx + dy + dz) + (bx + 3) * (by + 3) * (bz + 3) * c
              + bx * dx * by * dy * (bz + 3) * c)
    return 4 * floats


@functools.lru_cache(maxsize=None)
def stage_luts(tile, device) -> torch.Tensor:
    """``(t0, t1, s)`` of x, then y, then z, as one float32 tensor on ``device``."""
    return torch.cat([t for d in tile for t in lerp_luts(d, torch.float32, device)])


def check_smem(what, smem):
    """Raise if ``smem`` bytes exceed what a block may use; ``what`` names
    the kernel and its shape in the message."""
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{what} needs {smem} B of shared memory per block, more than the "
            f"{MAX_SMEM_BYTES} B a block may use")


def check_blocks(tile, blocks, channels, extra_bytes=0):
    """Raise if the staging, plus a kernel's ``extra_bytes``, exceeds what a
    block may use."""
    check_smem(f"tile {tile} with {channels} channels",
               stage_smem_bytes(tile, blocks, channels) + extra_bytes)


def launch(phi, out, tile, blocks):
    """Launch the kernel on the current stream: ``phi`` -> ``out`` (cropped)."""
    nx, ny, nz, c = phi.shape
    X, Y, Z, _ = out.shape
    lib = load_library()
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        rc = lib.bsi_ttli_f32(
            phi.data_ptr(), stage_luts(tile, phi.device).data_ptr(), out.data_ptr(),
            nx, ny, nz, c, *tile, X, Y, Z, *blocks, stream)
    if rc:
        raise RuntimeError(f"bsi_ttli kernel launch failed: cudaError_t {rc}")


def plain(phi, tile, vol_shape):
    """The kernel's function in tensor ops: :func:`bsi_ttli`, cropped."""
    X, Y, Z = vol_shape
    return bsi_ttli(phi, tile)[:X, :Y, :Z]
