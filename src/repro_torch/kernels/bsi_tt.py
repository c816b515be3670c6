"""Forward BSI in the TT form: the CUDA kernel's launch and its plain version.

The kernel (``csrc/bsi_tt.cu``) replaces the JAX package's Pallas kernel
``repro/kernels/bsi_tt.py:bsi_tt_pallas``, the paper's thread-per-tile form
(§3.2).  A thread owns one slot (y tile, z tile, channel) of an x tile and
holds its 64 control values in registers; groups of 64 threads take
consecutive slots, a block four groups (:func:`tt_blocks`), and walks the
voxel columns ``(a, b)`` of the x tile, each value the 64 terms
``window[k] * w[k]`` added in ``l, m, n`` order with the weights of
:func:`weight_table` (``(wx[a,l] * wy[b,m]) * wz[r,n]``), which every lane
reads alike from shared memory.  A group stages a column's values in the
field's order and stores them by bulk copies, only the voxels inside the
volume.  Built without FMA contraction, each term is a rounded product and
a rounded add: 128 instructions an output value, about 0.52 ms at phantom1
with 3 channels on an H100 at one instruction a clock, the form's floor
under its rounding (the function's bytes take 0.16 ms).  :func:`plain` is
:func:`repro_torch.core.interpolate.bsi_tt` cropped, which rounds every
product and sum as the kernel does; ``kernels.ops.bsi_tt`` picks between
the two by the tensor's device.  Both take a float32, bf16 or fp16 grid and
write a field of its dtype (entry points ``bsi_tt_f32``, ``bsi_tt_bf16``
and ``bsi_tt_f16``): in bf16 or fp16 the grid is widened as it is loaded,
the weights are products of the LUTs rounded to the dtype, in float32, the
sums float32 as before, and each value is rounded once where it is staged,
so the reduced kernels are their plain version bit for bit too; the
staging and its bulk stores move 2-byte values, 8 to 16 bytes.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.bspline import weight_lut
from repro_torch.core.interpolate import bsi_tt
from repro_torch.kernels.build import load_library
from repro_torch.kernels.bsi_adjoint import card_sms
from repro_torch.kernels.bsi_ttli import (ENTRY_SUFFIX, KERNEL_THREADS, MAX_SMEM_BYTES,
                                          check_smem, kernel_symbol)

__all__ = ["MAX_CHUNK", "TTBlocks", "launch", "occupancy_key", "plain", "tt_blocks",
           "weight_table"]

MAX_CHUNK = 8  # z offsets a thread sums together at most (csrc: kMaxChunk)
GROUP_THREADS = 64  # threads sharing a staging buffer and a barrier (csrc: kGroupThreads)
GROUPS = KERNEL_THREADS // GROUP_THREADS
# shared memory a TT block aims to stay within: two blocks an SM
TT_SMEM_BYTES = MAX_SMEM_BYTES // 2
# blocks a launch aims for, per SM of the card, before it splits the columns
BLOCKS_PER_SM = 16


@dataclasses.dataclass(frozen=True)
class TTBlocks:
    """The TT kernel's blocks for one volume (``csrc/bsi_tt.cu``).

    The slots of an x tile, ``(y tile, z tile, channel)`` numbered channel
    fastest, ``row_slots`` to a (x tile, y tile); a block's :data:`GROUPS`
    groups of :data:`GROUP_THREADS` threads take ``slots`` consecutive ones
    each (a whole number of z tiles; a group's threads where the channels
    exceed them, ``direct``), and the block ``part_cols`` of the x tile's
    ``dx * dy`` voxel columns.  ``grid``: (slot blocks, x tiles, parts).
    ``chunk`` z offsets are summed together, a column's weight slice has
    ``weight_rows`` rows (``dz`` in whole chunks).  ``smem``: the part's
    weight slices and each group's two stagings of ``slots * dz`` values
    (and up to 3 floats of alignment offset)."""

    slots: int
    row_slots: int
    part_cols: int
    grid: tuple
    chunk: int
    weight_rows: int
    direct: bool
    smem: int


def _chunk_rows(dz) -> tuple:
    """``(chunk, rows)``: the z offsets summed together and ``dz`` in whole
    chunks."""
    chunk = min(dz, MAX_CHUNK)
    return chunk, -(-dz // chunk) * chunk


def _stage_floats(slots, dz) -> int:
    return -(-slots * dz // 4) * 4 + 4


def _smem(slots, dz, rows, part_cols) -> int:
    return 4 * (part_cols * rows * 64 + GROUPS * 2 * _stage_floats(slots, dz))


@functools.lru_cache(maxsize=None)
def tt_blocks(tile, channels, vol_shape, sms=132) -> TTBlocks:
    """The blocks of ``bsi_tt`` for a ``vol_shape`` field of ``channels``
    channels at ``tile`` on a card of ``sms`` SMs.

    ``slots`` is the most whole z tiles' slots a group's threads hold;
    ``part_cols`` the columns, all of them unless their weight slices
    would pass :data:`TT_SMEM_BYTES` or the blocks fall short of
    :data:`BLOCKS_PER_SM` an SM, then split into the fewest parts that
    avoid both.  Raises if a block of one column exceeds what a block may
    use."""
    tile, c = tuple(int(d) for d in tile), int(channels)
    X, Y, Z = (int(s) for s in vol_shape)
    dx, dy, dz = tile
    chunk, rows = _chunk_rows(dz)
    direct = c > GROUP_THREADS
    slots = GROUP_THREADS if direct else GROUP_THREADS // c * c
    check_smem(f"the TT kernel at tile {tile} with {c} channels",
               _smem(slots, dz, rows, 1))
    cols = dx * dy
    fit = max(1, min(cols, (TT_SMEM_BYTES // 4 - GROUPS * 2 * _stage_floats(slots, dz))
                     // (rows * 64)))
    tx, ty, tz = -(-X // dx), -(-Y // dy), -(-Z // dz)
    row_slots = tz * c
    blocks = -(-(ty * row_slots) // (GROUPS * slots)) * tx
    parts = max(-(-cols // fit), min(cols, -(-BLOCKS_PER_SM * sms // blocks)))
    part_cols = -(-cols // parts)
    return TTBlocks(slots=slots, row_slots=row_slots, part_cols=part_cols,
                    grid=(blocks // tx, tx, -(-cols // part_cols)), chunk=chunk,
                    weight_rows=rows, direct=direct,
                    smem=_smem(slots, dz, rows, part_cols))


def occupancy_key(tile, channels, vol_shape, sms=132, dtype=torch.float32) -> tuple:
    """``(symbol, smem, grid)``: the part of the kernel's instantiation's
    name in its ``-Xptxas -v`` line (the kernel of ``dtype``, on the same
    blocks for every dtype), its shared memory a block and its grid."""
    geo = tt_blocks(tuple(tile), channels, tuple(vol_shape), sms)
    return f"{kernel_symbol('bsi_tt', dtype)}ILi{geo.chunk}E", geo.smem, geo.grid


@functools.lru_cache(maxsize=None)
def weight_table(tile, device, dtype=torch.float32) -> torch.Tensor:
    """The kernel's weights, ``(dx * dy, rows * 64)`` float32 on ``device``:
    row ``a * dy + b`` holds column ``(a, b)``'s slice, ``w[r * 64 + k] =
    (wx[a,l] * wy[b,m]) * wz[r,n]`` at ``k = (l * 4 + m) * 4 + n``, of the
    LUTs rounded to ``dtype`` and widened, the products in float32 as the
    plain :func:`bsi_tt` rounds them; 0 for ``r >= dz`` (the rows that fill
    the last chunk)."""
    dx, dy, dz = tile
    _, rows = _chunk_rows(dz)
    wx, wy, wz = (weight_lut(d, dtype, "cpu").float() for d in tile)
    w = torch.zeros((dx, dy, rows, 4, 4, 4))
    w[:, :, :dz] = ((wx[:, None, None, :, None, None] * wy[None, :, None, None, :, None])
                    * wz[None, None, :, None, None, :])
    return w.reshape(dx * dy, rows * 64).to(device)


def launch(phi, out, tile, lib=None):
    """Launch the kernel of ``phi``'s dtype (float32, bf16 or fp16, ``out``
    the same) on the current stream: ``phi`` -> ``out`` (cropped);
    ``lib`` a measurement build (default: the kernels as built); raises if
    its blocks do not fit."""
    nx, ny, nz, c = phi.shape
    X, Y, Z, _ = out.shape
    tile = tuple(int(d) for d in tile)
    geo = tt_blocks(tile, c, (X, Y, Z), card_sms(phi.device))
    lib = lib or load_library()
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        rc = getattr(lib, f"bsi_tt_{ENTRY_SUFFIX[phi.dtype]}")(
            phi.data_ptr(), weight_table(tile, phi.device, phi.dtype).data_ptr(),
            out.data_ptr(),
            nx, ny, nz, c, *tile, X, Y, Z, geo.part_cols, stream)
    if rc:
        raise RuntimeError(f"bsi_tt kernel launch failed: cudaError_t {rc}")


def plain(phi, tile, vol_shape):
    """The kernel's function in tensor ops: :func:`bsi_tt`, cropped."""
    X, Y, Z = vol_shape
    return bsi_tt(phi, tile)[:X, :Y, :Z]
