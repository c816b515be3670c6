"""Forward BSI in the TTLI form: the CUDA kernel's launch and its plain version.

The kernel (``csrc/bsi_ttli.cu``, its device code in ``csrc/bsi_forward.cuh``)
replaces the JAX package's Pallas kernel
``repro/kernels/bsi_ttli.py:bsi_ttli_pallas``.  A thread block owns one
(x tile, y tile) and a run of tiles along z (:func:`forward_blocks`): it
runs the x and y lerp stages of :func:`repro_torch.core.interpolate.bsi_ttli`
into shared memory, then the z stage, each position's offsets from a table
the block decodes once, writing whole rows of the field and only the voxels
inside the volume.  :func:`plain` is the same function in
tensor ops; ``kernels.ops.bsi_ttli`` picks between the two by the tensor's
device.  Both take a float32, bf16 or fp16 grid and write a field of its
dtype (entry points ``bsi_ttli_f32``, ``bsi_ttli_bf16`` and
``bsi_ttli_f16``): in bf16 or fp16 the kernel reads the grid and the LUTs
rounded to its dtype, computes in float32 and rounds once at the store,
the contract of ``core.interpolate``.  :func:`block_tiles` and :func:`stage_smem_bytes` size the fused
nmi kernel's staging (``csrc/bsi_common.cuh``), which runs the same x and y
stages; the fused ssd, stats and ncc kernels run on :func:`forward_blocks`
(``kernels.bsi_fused.moment_blocks``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.bspline import lerp_luts
from repro_torch.core.interpolate import bsi_ttli
from repro_torch.kernels.build import load_library

__all__ = ["ENTRY_SUFFIX", "ForwardBlocks", "block_tiles", "check_smem", "forward_blocks",
           "kernel_symbol", "launch", "launch_forward", "plain", "stage_luts",
           "stage_smem_bytes"]

MAX_SMEM_BYTES = 232_448  # dynamic shared memory one H100 block may use
KERNEL_THREADS = 256  # threads per block of every BSI kernel (csrc: kThreads)
# shared memory a forward block aims to stay within: four blocks an SM
FORWARD_SMEM_BYTES = MAX_SMEM_BYTES // 4


def block_tiles(tile) -> tuple:
    """Tiles per thread block of the fused kernels' staging: about 10 x 10 x
    40 voxels whatever the tile."""
    dx, dy, dz = tile
    return (max(1, 10 // dx), max(1, 10 // dy), max(1, 40 // dz))


def stage_smem_bytes(tile, blocks, channels) -> int:
    """Shared memory of the fused kernels' staging in ``csrc/bsi_common.cuh``:
    the lerp LUTs, the control window and the y-stage values."""
    (dx, dy, dz), (bx, by, bz), c = tile, blocks, channels
    floats = (3 * (dx + dy + dz) + (bx + 3) * (by + 3) * (bz + 3) * c
              + bx * dx * by * dy * (bz + 3) * c)
    return 4 * floats


@dataclasses.dataclass(frozen=True)
class ForwardBlocks:
    """The forward kernels' blocks for one volume (``csrc/bsi_forward.cuh``).

    A block owns one (x tile, y tile), so ``dx * dy`` columns of voxels, and
    ``bz`` tiles along z; ``grid`` is the launch's grid, blocks along (y, x,
    z).  A column's run in a block is ``run = bz * dz * channels`` floats,
    contiguous in the field, written by all the block's threads.  ``smem``
    is the z table (an int a position: its offset into the column's y-stage
    values and its voxel offset along z), the z LUT
    (``4 * dz`` floats at most) and the y-stage values, ``dx * dy * (bz +
    3) * channels`` floats."""

    bz: int
    grid: tuple
    run: int
    smem: int


def check_smem(what, smem):
    """Raise if ``smem`` bytes exceed what a block may use; ``what`` names
    the kernel and its shape in the message."""
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{what} needs {smem} B of shared memory per block, more than the "
            f"{MAX_SMEM_BYTES} B a block may use")


def _forward_smem(tile, channels, bz) -> int:
    dx, dy, dz = tile
    return 4 * (bz * dz * channels + 4 * dz + dx * dy * (bz + 3) * channels)


@functools.lru_cache(maxsize=None)
def forward_blocks(tile, channels, vol_shape) -> ForwardBlocks:
    """The blocks of ``bsi_ttli`` and ``bsi_separable`` for a ``vol_shape``
    field of ``channels`` channels at ``tile``; the same for both (the z
    LUT's room is the weights' 4 rows).

    ``bz`` is the most tiles along z, up to the volume's, for which a block
    stays within :data:`FORWARD_SMEM_BYTES` (one tile at least), then
    evened out over the blocks along z.  Raises if a block of one tile
    along z exceeds what a block may use."""
    tile, c = tuple(int(d) for d in tile), int(channels)
    X, Y, Z = (int(s) for s in vol_shape)
    dx, dy, dz = tile
    check_smem(f"the forward kernels at tile {tile} with {c} channels",
               _forward_smem(tile, c, 1))
    tiles_z = -(-Z // dz)
    bz = 1
    while bz < tiles_z and _forward_smem(tile, c, bz + 1) <= FORWARD_SMEM_BYTES:
        bz += 1
    blocks_z = -(-tiles_z // bz)
    bz = -(-tiles_z // blocks_z)
    return ForwardBlocks(bz=bz, grid=(-(-Y // dy), -(-X // dx), blocks_z),
                         run=bz * dz * c, smem=_forward_smem(tile, c, bz))


# the entry point of each dtype the BSI kernels take (a grid, field,
# cotangent or moving volume): float32, and the reduced compute dtypes
ENTRY_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


def kernel_symbol(stem, dtype=torch.float32) -> str:
    """The ``__global__`` name of kernel ``stem`` (``"bsi_tt"``) for ``dtype``:
    ``bsi_tt_kernel``, ``bsi_tt_bf16_kernel``, ``bsi_tt_f16_kernel``, the
    part of its instantiation's name in its ``-Xptxas -v`` line."""
    return stem + ("" if dtype == torch.float32 else f"_{ENTRY_SUFFIX[dtype]}") + "_kernel"


@functools.lru_cache(maxsize=None)
def stage_luts(tile, device, dtype=torch.float32) -> torch.Tensor:
    """``(t0, t1, s)`` of x, then y, then z, rounded to ``dtype`` and held as
    one float32 tensor on ``device`` (the kernels compute in float32)."""
    return torch.cat([t.float() for d in tile for t in lerp_luts(d, dtype, device)])


def launch_forward(entry, phi, luts, out, tile, lib=None):
    """Launch forward kernel ``entry`` (``"bsi_ttli"``, ``"bsi_separable"``) of
    ``phi``'s dtype (float32, bf16 or fp16, ``out`` the same) on the current
    stream with its LUTs: ``phi`` -> ``out`` (cropped); ``lib`` a
    measurement build (default: the kernels as built).  Raises if the block
    does not fit or the launch fails."""
    nx, ny, nz, c = phi.shape
    X, Y, Z, _ = out.shape
    tile = tuple(int(d) for d in tile)
    geo = forward_blocks(tile, c, (X, Y, Z))
    lib = lib or load_library()
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        rc = getattr(lib, f"{entry}_{ENTRY_SUFFIX[phi.dtype]}")(
            phi.data_ptr(), luts.data_ptr(), out.data_ptr(), nx, ny, nz, c, *tile, X, Y,
            Z, geo.bz, stream)
    if rc:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError_t {rc}")


def launch(phi, out, tile, lib=None):
    """Launch the kernel on the current stream: ``phi`` -> ``out`` (cropped);
    ``lib`` a measurement build (default: the kernels as built)."""
    launch_forward("bsi_ttli", phi, stage_luts(tuple(tile), phi.device, phi.dtype), out,
                   tile, lib)


def plain(phi, tile, vol_shape):
    """The kernel's function in tensor ops: :func:`bsi_ttli`, cropped; for a
    bf16 or fp16 ``phi`` the float32 form on the widened grid and LUTs,
    rounded once."""
    X, Y, Z = vol_shape
    return bsi_ttli(phi, tile)[:X, :Y, :Z]
