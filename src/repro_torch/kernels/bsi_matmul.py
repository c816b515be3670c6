"""Forward BSI in the matrix form: the CUDA kernel's launch and its plain version.

The kernel (``csrc/bsi_matmul.cu``) replaces the JAX package's Pallas kernel
``repro/kernels/bsi_matmul.py:bsi_matmul_pallas``.  It runs the form's
product ``out[v, (tk, ch)] = sum_k B[v, k] * W[k, (tk, ch)]`` of the
``(d^3, 64)`` Kronecker basis and the control window's column matrix on the
tensor cores (``wgmma`` m64n24k8 TF32: the basis from registers, W^T from
shared memory), a unit of work one (x tile, y tile) and a chunk of whole z
tiles (:func:`matmul_blocks`), in a 3xTF32 split: the basis as hi + lo TF32
parts split once on the host (:func:`basis_fragments`), the window split
once per staged value, and per k-step ``lo_B hi_W + hi_B lo_W`` into one
float32 accumulator and ``hi_B hi_W`` into another (``lo_B lo_W``
dropped), added once at the end.  Each voxel column's run of the field is
staged in the field's order and stored by one bulk copy; only the voxels
inside the volume are written.  Its bound at phantom1 (tile 5^3, 3
channels) on an H100 is the bytes, 544.3 MB in 0.1625 ms; its three TF32
products take 0.109 ms at 495 TFLOP/s.  It rounds otherwise than
:func:`plain` and is held to it at 1e-5 absolute (:func:`exact` is the
float64 yardstick of both).  ``kernels.ops.bsi_matmul`` picks between the
two by the tensor's device.

On a bf16 grid (``compute_dtype="bfloat16"``, entry ``bsi_matmul_bf16``)
both follow the contract of ``core.interpolate``: the grid widened, the
basis rounded to bf16 (``basis_matrix(tile, bfloat16)``, the JAX kernel's
operand) and widened, float32 sums, one rounding to bf16 at the store.  A
bf16 value is exact in TF32, so the split's lo parts are zero and the
kernel runs only the ``hi_B hi_W`` product, one wgmma a k-step, in the
float32 kernel's order: its bits are those of the float32 kernel on the
widened grid with the bf16 basis's fragments, rounded once.  It stages the
bf16 rows as they are and writes a bf16 field.  On an fp16 grid
(``compute_dtype="float16"``, entry ``bsi_matmul_f16``) the same holds with
fp16 in place of bf16: an fp16 value, and so the fp16 basis
(``basis_matrix(tile, float16)``), has at most 11 significant bits and
exponents inside TF32's range, subnormals included, so it too is exact in
TF32.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.bspline import REDUCED_DTYPES, basis_matrix
from repro_torch.kernels.build import load_library
from repro_torch.kernels.bsi_ttli import (ENTRY_SUFFIX, MAX_SMEM_BYTES, check_smem,
                                          kernel_symbol)

__all__ = ["MatmulBlocks", "basis", "basis_fragments", "basis_sum", "exact", "launch",
           "matmul_blocks", "occupancy_key", "plain", "tf32_rna", "tf32_split"]

MAX_COLUMNS = 48  # a unit's (z tile, channel) columns at most, past one z tile
HALF = 24  # columns of a warpgroup's task, the wgmma's N (csrc: kHalf)
# shared memory a block aims to stay within: two blocks an SM
MATMUL_SMEM_BYTES = MAX_SMEM_BYTES // 2
BLOCKS_PER_SM = 2  # persistent blocks a launch starts per SM


@functools.lru_cache(maxsize=None)
def basis(tile, device, dtype=torch.float32) -> torch.Tensor:
    """The ``(d^3, 64)`` basis on ``device`` (float64, cast once to
    ``dtype``), held as float32."""
    return basis_matrix(tile, dtype, device).float().contiguous()


def tf32_rna(x) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32 as the kernels round it (csrc:
    ``tf32_rna``): 10 mantissa bits, ties away from zero, by adding 2^12 to
    the bits and clearing the low 13."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x) -> tuple:
    """``(hi, lo)``: the 3xTF32 split of float32 ``x`` (csrc: ``split_tf32``),
    ``hi`` the nearest TF32 and ``lo`` the nearest TF32 of the rest."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


@functools.lru_cache(maxsize=None)
def basis_fragments(tile, device, dtype=torch.float32) -> torch.Tensor:
    """The basis (:func:`basis` of ``dtype``; of bf16 and fp16 the lo parts
    are zero: their values are exact in TF32) as hi and lo TF32 parts in the kernel's A fragments, each
    warp's 16 rows of a wgmma's 64 in the ``m16n8k8`` layout: ``(m16 tiles,
    8 k-steps, hi/lo, 32 lanes, 4)`` float32 on ``device``, rows padded to
    whole 64-row tiles with zeros (warp ``w`` of a warpgroup holds m16 tile
    ``4 mi + w`` of 64-row tile ``mi``).  Lane ``(g, t) =
    (lane // 4, lane % 4)`` of m tile ``mi`` at k-step ``s`` holds rows
    ``16 mi + g (+8)`` and columns ``8 s + t (+4)``: entry ``r`` is row
    ``16 mi + g + 8 (r % 2)``, column ``8 s + t + 4 (r // 2)``."""
    b = basis(tuple(int(d) for d in tile), "cpu", dtype)
    nv = b.shape[0]
    mt = -(-nv // 64) * 4  # whole 64-row tiles, a warpgroup's
    padded = torch.zeros((mt * 16, 64))
    padded[:nv] = b
    parts = torch.stack(tf32_split(padded))  # (2, rows, 64)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    r = torch.arange(4)
    rows = (16 * torch.arange(mt)[:, None, None, None] + g[None, None, :, None]
            + 8 * (r % 2)[None, None, None, :])  # (mt, 1, 32, 4)
    cols = (8 * torch.arange(8)[None, :, None, None] + t[None, None, :, None]
            + 4 * (r // 2)[None, None, None, :])  # (1, 8, 32, 4)
    frag = parts[:, rows, cols]  # (2, mt, 8, 32, 4)
    return frag.permute(1, 2, 0, 3, 4).contiguous().to(device)


@dataclasses.dataclass(frozen=True)
class MatmulBlocks:
    """The kernel's work for one volume (``csrc/bsi_matmul.cu``).

    A unit is one (x tile, y tile) and ``z_tiles`` whole z tiles (the last
    chunk of a row fewer), numbered chunk fastest, then y tile, then x tile;
    ``units`` in all, walked round robin by ``grid`` persistent blocks.  The
    ``d^3`` voxel offsets make ``m_groups`` 64-row tiles and a unit's
    ``z_tiles * channels`` columns ``halves`` of :data:`HALF`; a task, one
    tile by one half, is a warpgroup's.  A raw window row holds ``raw_row``
    floats (its values from their start rounded down to 16 bytes), a staged
    run's slot ``run``; ``smem``: 1 KB of alignment, W^T hi and lo (8
    k-steps of ``halves * HALF`` rows of 32 bytes each), two stagings of
    ``dx * dy`` runs and the raw window, 16 rows."""

    z_tiles: int
    chunks: int
    units: int
    m_groups: int
    halves: int
    raw_row: int
    run: int
    grid: int
    smem: int


def _halves(zt, c) -> int:
    return -(-zt * c // HALF)


def _raw_row(zt, c) -> int:
    return -(-((zt + 3) * c + 3) // 4) * 4


def _run(zt, dz, c) -> int:
    return -(-zt * dz * c // 4) * 4 + 4


def _smem(tile, c, zt) -> int:
    dx, dy, dz = tile
    return (1024 + 2 * 8 * _halves(zt, c) * HALF * 32
            + 2 * dx * dy * _run(zt, dz, c) * 4 + 16 * _raw_row(zt, c) * 4)


@functools.lru_cache(maxsize=None)
def matmul_blocks(tile, channels, vol_shape, sms=132) -> MatmulBlocks:
    """The work of ``bsi_matmul`` for a ``vol_shape`` field of ``channels``
    channels at ``tile`` on a card of ``sms`` SMs.

    ``z_tiles`` is the most z tiles (at most ``MAX_COLUMNS // channels``, at
    least one) whose block stays within :data:`MATMUL_SMEM_BYTES`; raises if
    a block of one z tile exceeds what a block may use."""
    tile, c = tuple(int(d) for d in tile), int(channels)
    dx, dy, dz = tile
    tx, ty, tz = (-(-int(s) // d) for s, d in zip(vol_shape, tile))
    check_smem(f"the matmul kernel at tile {tile} with {c} channels", _smem(tile, c, 1))
    zt = min(tz, max(1, MAX_COLUMNS // c))
    while zt > 1 and _smem(tile, c, zt) > MATMUL_SMEM_BYTES:
        zt -= 1
    chunks = -(-tz // zt)
    units = tx * ty * chunks
    return MatmulBlocks(z_tiles=zt, chunks=chunks, units=units,
                        m_groups=-(-dx * dy * dz // 64), halves=_halves(zt, c),
                        raw_row=_raw_row(zt, c), run=_run(zt, dz, c),
                        grid=min(units, BLOCKS_PER_SM * sms), smem=_smem(tile, c, zt))


def occupancy_key(tile, channels, vol_shape, sms=132, dtype=torch.float32) -> tuple:
    """``(symbol, smem, grid)``: the part of the kernel's instantiation's
    name in its ``-Xptxas -v`` line (the kernel of ``dtype``, on the same
    blocks for every dtype), its shared memory a block and its grid."""
    geo = matmul_blocks(tuple(tile), channels, tuple(vol_shape), sms)
    return (f"{kernel_symbol('bsi_matmul', dtype)}ILi{3 if channels == 3 else 0}E",
            geo.smem, geo.grid)


def launch(phi, out, tile, lib=None):
    """Launch the kernel of ``phi``'s dtype (float32, bf16 or fp16, ``out``
    the same) on the current stream: ``phi`` -> ``out`` (cropped); ``lib`` a
    measurement build (default: the kernels as built); raises if its blocks
    do not fit."""
    nx, ny, nz, c = phi.shape
    X, Y, Z, _ = out.shape
    tile = tuple(int(d) for d in tile)
    from repro_torch.kernels.bsi_adjoint import card_sms  # bsi_adjoint imports this module

    geo = matmul_blocks(tile, c, (X, Y, Z), card_sms(phi.device))
    lib = lib or load_library()
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        rc = getattr(lib, f"bsi_matmul_{ENTRY_SUFFIX[phi.dtype]}")(
            phi.data_ptr(), basis_fragments(tile, phi.device, phi.dtype).data_ptr(),
            out.data_ptr(), nx, ny, nz, c, *tile, X, Y, Z, geo.z_tiles, geo.grid,
            stream)
    if rc:
        raise RuntimeError(f"bsi_matmul kernel launch failed: cudaError_t {rc}")


def basis_sum(phi, b, tile, vol_shape):
    """The 64 terms ``b[:, k] * window[k]`` added one at a time, ``k`` in
    order, in the dtype of ``phi`` and ``b``, cropped to ``vol_shape``."""
    dx, dy, dz = tile
    tx, ty, tz = (int(n) - 3 for n in phi.shape[:3])
    c = phi.shape[3]
    X, Y, Z = vol_shape
    with torch.no_grad():
        acc = torch.zeros((tx, dx, ty, dy, tz, dz, c), dtype=phi.dtype, device=phi.device)
        for k in range(64):
            l, m, n = k >> 4, (k >> 2) & 3, k & 3
            sl = phi[l:l + tx, m:m + ty, n:n + tz][:, None, :, None, :, None, :]
            acc = acc + b[:, k].reshape(1, dx, 1, dy, 1, dz, 1) * sl
        return acc.reshape(tx * dx, ty * dy, tz * dz, c)[:X, :Y, :Z]


def plain(phi, tile, vol_shape):
    """The kernel's function in tensor ops, cropped to ``vol_shape``: the 64
    terms ``B[v, k] * window[k]`` added one at a time, ``k`` in order, each
    product and sum rounded to float32.  The fused kernels' matrix-form
    displacement, built without FMA contraction, rounds the same way; the
    tensor-core kernel does not (3xTF32) and is held to it at 1e-5.  A bf16
    or fp16 ``phi`` gives the same sums of the widened grid and the basis
    rounded to its dtype, rounded once to a field of its dtype."""
    tile = tuple(int(d) for d in tile)
    if phi.dtype in REDUCED_DTYPES:
        b = basis(tile, phi.device, phi.dtype)
        return basis_sum(phi.float(), b, tile, vol_shape).to(phi.dtype)
    return basis_sum(phi, basis(tile, phi.device), tile, vol_shape)


def exact(phi, tile, vol_shape):
    """The function in float64, the basis too (``basis_matrix`` before its
    cast), cropped to ``vol_shape``: the yardstick of both the kernel's and
    :func:`plain`'s rounding."""
    tile = tuple(int(d) for d in tile)
    b = basis_matrix(tile, torch.float64, phi.device)
    return basis_sum(phi.double(), b, tile, vol_shape)
