"""The BSI adjoint: the CUDA kernels' launches and their plain versions.

The kernels (``csrc/bsi_adjoint.cu``) replace the JAX package's Pallas
kernels in ``repro/kernels/bsi_adjoint.py``, masking the voxels outside the
volume instead of padding:

``bsi_adjoint_separable_pallas``  the z, y and x sweeps contract the
    cotangent of the dense field against the ``(d, 4)`` weight LUTs
    (:func:`launch`, :func:`plain`): one launch streams each x plane's rows
    through shared memory and runs the z and y sweeps, writing the y-reduced
    intermediate as one partial per run of y tiles; a second launch sums
    the runs' partials and runs the x sweep (:func:`stream_blocks` is the
    geometry).  The cotangent is float32 or bf16 (entry points
    ``bsi_adjoint_f32`` and ``bsi_adjoint_bf16``, the backward of a bf16
    field): a bf16 one is staged as bf16 in the float32 kernel's ring and
    widened as it is loaded, with the float32 kernel's geometry, LUTs and
    sums, so it gives the float32 kernel's bits on the widened cotangent;
``bsi_adjoint_matmul_pallas``  each tile's cotangent contracted against the
    ``(d^3, 64)`` Kronecker basis into 64 bands, then the bands overlap-added
    onto the control points (:func:`launch_matmul`, :func:`plain_matmul`).
    A block contracts a box of tiles at a time and overlap-adds its bands
    into one partial per control point it touches; a second launch sums the
    partials of the boxes that share a point (:func:`matmul_blocks` is the
    geometry, :func:`plain_matmul_blocked` the same reduction in tensor ops).
    The cotangent is float32 or bf16 (``bsi_adjoint_matmul_f32``,
    ``bsi_adjoint_matmul_bf16``): a bf16 one is staged as bf16 in the
    float32 kernel's ring and widened as each plane is moved into place,
    with the float32 basis (the JAX package's, ``repro/kernels/ops.py:208``)
    and the float32 kernel's geometry and sums, so it gives that kernel's
    bits on the widened cotangent.

``kernels.ops.bsi_adjoint`` and ``kernels.ops.bsi_adjoint_matmul`` pick
between a kernel and its plain version by the tensor's device.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.bspline import weight_lut
from repro_torch.core.interpolate import bsi_adjoint, bsi_adjoint_matmul
from repro_torch.core.interpolate import _pad_to_tiles
from repro_torch.kernels import bsi_matmul, bsi_ttli
from repro_torch.kernels.build import load_library

__all__ = ["weight_luts", "StreamBlocks", "stream_smem_bytes", "stream_geometry",
           "stream_blocks", "card_sms", "launch",
           "plain", "MatmulBlocks", "matmul_smem_bytes", "matmul_blocks", "launch_matmul",
           "plain_matmul", "plain_matmul_blocked"]

# the streaming kernel (csrc: adjoint_stream_kernel): ring slots, one row
# each (kStreamStages); a lane a z tile, the 29 lanes 3..31 of a warp
# owning control points (kStreamOutputs), at most 9 warps a block
# (kStreamThreads); and the warps a launch aims to put in flight on each
# SM before it splits a plane's y tiles into runs
STREAM_STAGES = 4
STREAM_OUTPUTS = 29
STREAM_MAX_WARPS = 9
STREAM_FILL_WARPS_PER_SM = 16
_STREAM_LANES = STREAM_OUTPUTS * STREAM_MAX_WARPS + 3  # z tiles a block's warps hold
H100_SMS = 132  # streaming multiprocessors of an H100 SXM, the geometry's default

# the box kernel's instantiations (csrc: adjoint_matmul_box_kernel<COLS>):
# columns a block contracts at once, two threads each
MATMUL_COLS = (128, 64)
MATMUL_STAGES = 3  # ring slots of its staging (csrc: kAdjStages)


@functools.lru_cache(maxsize=None)
def weight_luts(tile, device) -> tuple:
    """The three ``(d, 4)`` float32 weight LUTs on ``device``."""
    return tuple(weight_lut(d, torch.float32, device) for d in tile)


class StreamBlocks(NamedTuple):
    """The separable adjoint's launch geometry (csrc: ``StreamGeo``).  A block
    streams the rows of one x plane, a run of ``run`` y tiles, and owns
    ``span`` z control points of ``channels`` channels: a lane a z tile,
    ``span + 3`` a channel (three of them a halo)."""

    span: int  # z control points a block owns
    channels: int  # channels a block owns (all, unless more than 66)
    zparts: int  # blocks along z and channels: ceil((Tz + 3) / span) * ceil(C / channels)
    run: int  # y tiles a block streams: at least 3, or all of them
    runs: int  # ceil(Ty / run)
    threads: int  # warps whose lanes 3..31 follow on: ceil((channels (span + 3) - 3) / 29)
    segment: int  # floats of a row a block stages, at most: min(Z, (span + 3) dz) C
    slot: int  # floats of a ring slot: the 16-byte chunks covering a segment
    smem: int  # bytes of shared memory a block
    partial_floats: int  # X * runs * (run + 3) * (Tz + 3) * C: the runs' partials of hy


def stream_segment(tile, span, channels, Z) -> int:
    """Floats of a row a block stages, at most (csrc: ``stream_segment``):
    the z voxels its ``span`` control points reach, ``span + 3`` tiles, cut
    at the volume's ``Z``; all ``channels`` channels of the row."""
    return min(Z, (span + 3) * tile[2]) * channels


def stream_smem_bytes(tile, span, channels, Z) -> int:
    """Shared memory of the streaming kernel (csrc: ``stream_smem``): an
    8-byte mbarrier a slot, rounded up to 16 bytes; a ring of
    :data:`STREAM_STAGES` slots, each the 16-byte chunks that cover a
    segment shifted by up to 3 floats, ``4 * ((segment + 6) // 4)`` floats;
    then the y and z LUTs, ``4 * dy`` and ``4 * dz`` floats."""
    slot = 4 * ((stream_segment(tile, span, channels, Z) + 6) // 4)
    bars = 16 * -(-STREAM_STAGES // 2)
    return bars + 4 * (STREAM_STAGES * slot + 4 * tile[1] + 4 * tile[2])


def stream_geometry(tile, channels, vol_shape, span, run) -> StreamBlocks:
    """The streaming kernel's geometry for a ``vol_shape`` cotangent of
    ``channels`` channels at ``tile`` with blocks of ``span`` z control
    points (at most those the volume reaches) and runs of ``run`` y tiles
    (at least 3, or all of them: a point's partials lie in two runs at
    most).  The channels a block owns are all of them unless four lanes
    each would not fit :data:`STREAM_MAX_WARPS` warps."""
    tile, vol_shape = tuple(int(d) for d in tile), tuple(int(s) for s in vol_shape)
    (X, Y, Z), (_, dy, dz) = vol_shape, tile
    Ty, nzh = -(-Y // dy), -(-Z // dz) + 3
    cb = min(channels, _STREAM_LANES // 4)
    span = min(span, nzh)
    run = min(Ty, max(run, 3))
    runs = -(-Ty // run)
    segment = stream_segment(tile, span, channels, Z)
    return StreamBlocks(span, cb, -(-nzh // span) * -(-channels // cb), run, runs,
                        32 * -(-(cb * (span + 3) - 3) // STREAM_OUTPUTS), segment,
                        4 * ((segment + 6) // 4), stream_smem_bytes(tile, span, channels, Z),
                        X * runs * (run + 3) * nzh * channels)


@functools.lru_cache(maxsize=None)
def stream_blocks(tile, channels, vol_shape, sms=H100_SMS) -> StreamBlocks:
    """The streaming kernel's geometry for a ``vol_shape`` cotangent of
    ``channels`` channels at ``tile`` on a card of ``sms`` SMs.

    A block owns every z control point the volume reaches, ``Tz + 3``, of
    every channel, if their lanes fit :data:`STREAM_MAX_WARPS` warps; else
    spans of as many as fit (fewer channels a block only past 66 channels),
    halved until its ring fits its shared memory.  The y tiles of a plane
    are split into runs, of 3 tiles at least, only when the planes and parts
    give fewer than :data:`STREAM_FILL_WARPS_PER_SM` warps an SM.  Raises if
    no block fits."""
    tile, vol_shape = tuple(int(d) for d in tile), tuple(int(s) for s in vol_shape)
    (X, Y, Z), (_, dy, dz) = vol_shape, tile
    Ty, nzh = -(-Y // dy), -(-Z // dz) + 3
    span = min(nzh, _STREAM_LANES // min(channels, _STREAM_LANES // 4) - 3)
    while span > 1 and stream_smem_bytes(tile, span, channels, Z) > bsi_ttli.MAX_SMEM_BYTES:
        span = -(-span // 2)
    bsi_ttli.check_smem(f"the separable adjoint at tile {tile} with {channels} channels",
                        stream_smem_bytes(tile, span, channels, Z))
    one = stream_geometry(tile, channels, vol_shape, span, Ty)
    warps = X * one.zparts * one.threads // 32
    runs = min(Ty, max(1, -(-STREAM_FILL_WARPS_PER_SM * sms // warps)))
    return stream_geometry(tile, channels, vol_shape, span, -(-Ty // runs))


def card_sms(device) -> int:
    """Streaming multiprocessors of the card ``device`` lies on."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(g, out, tile, lib=None, geo=None):
    """Launch the streaming z-y kernel and the x sweep on the current
    stream: ``g`` (float32 or bf16) -> ``out`` (float32), with the geometry
    ``geo`` (by default :func:`stream_blocks` for the card's SMs, the same
    for both dtypes: the float32 slots hold a bf16 row).  The runs' partials
    of hy (:attr:`StreamBlocks.partial_floats`) are allocated here; PyTorch's
    caching allocator reuses their memory only for work queued after these
    launches on the same stream."""
    X, Y, Z, c = g.shape
    nx, ny, nz, _ = out.shape
    geo = geo or stream_blocks(tile, c, (X, Y, Z), card_sms(g.device))
    hyp = torch.empty(geo.partial_floats, dtype=torch.float32, device=g.device)
    wx, wy, wz = weight_luts(tile, g.device)
    lib = lib or load_library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = getattr(lib, f"bsi_adjoint_{bsi_ttli.ENTRY_SUFFIX[g.dtype]}")(
            g.data_ptr(), wx.data_ptr(), wy.data_ptr(), wz.data_ptr(), hyp.data_ptr(),
            out.data_ptr(), X, Y, Z, c, nx, ny, nz, *tile, geo.span, geo.channels, geo.run,
            geo.threads, stream)
    if rc:
        raise RuntimeError(f"bsi_adjoint kernel launch failed: cudaError_t {rc}")


def plain(g, tile, grid_shape):
    """The kernel's function in tensor ops: zero-pad to whole tiles, then
    :func:`repro_torch.core.interpolate.bsi_adjoint_separable`."""
    return bsi_adjoint(g, tile, grid_shape, impl="torch")


class MatmulBlocks(NamedTuple):
    """The matmul adjoint's launch geometry (csrc: ``AdjointBoxes``)."""

    box: tuple  # tiles per box, (bx, by, bz)
    cols: int  # the box kernel's columns (box tiles x channels, padded), two threads each
    boxes: tuple  # boxes per axis: ceil(tiles / box)
    channels: int
    smem: int  # bytes of shared memory a block

    @property
    def partial_floats(self) -> int:
        """Floats of the partials: each box's ``b + 3`` control points per axis,
        ``channels`` each (csrc: ``box_partial_floats``)."""
        return math.prod(self.boxes) * math.prod(b + 3 for b in self.box) * self.channels


def matmul_smem_bytes(tile, cols, box, channels) -> int:
    """Shared memory of the box kernel (csrc: ``adjoint_box_smem``): the
    ``(d^3, 64)`` basis; a ring of :data:`MATMUL_STAGES` planes of ``bx * by
    * dy`` rows along z, each the 16-byte chunks covering ``bz * dz *
    channels`` floats; one plane of U, ``max(dy * dz, 64)`` rows of ``cols +
    4`` (the bands' room too); and the tables (a row's and a plane's)."""
    (dx, dy, dz), (bx, by, bz) = tile, box
    row, rows = bz * dz * channels, bx * by * dy
    return 4 * (64 * dx * dy * dz + MATMUL_STAGES * rows * 4 * ((row + 6) // 4)
                + max(dy * dz, 64) * (cols + 4) + row + 2 * rows)


@functools.lru_cache(maxsize=None)
def matmul_blocks(tile, channels, vol_shape) -> MatmulBlocks:
    """The box kernel's geometry for a ``vol_shape`` cotangent of ``channels``
    channels at ``tile``.

    The most columns of :data:`MATMUL_COLS` for which a block fits its shared
    memory; then, of the boxes of at most that many (tile, channel) columns,
    the one that costs the fewest thread instructions a launch, by the
    kernel's count: a box takes ``64 d^3`` multiply-adds a column, about 8
    a lane of its staging and transposition (a warp a row of ``bz * dz *
    channels`` floats) and about 200 a float of its partial (the owner's
    sum, its write and the seam's read); then the smallest partial.  Raises if no block holds the
    basis and one tile."""
    tile, vol_shape = tuple(int(d) for d in tile), tuple(int(s) for s in vol_shape)
    if channels > MATMUL_COLS[0]:
        raise ValueError(f"the matmul adjoint takes at most {MATMUL_COLS[0]} channels, "
                         f"not {channels}")
    least = min(c for c in MATMUL_COLS if c >= channels)
    bsi_ttli.check_smem(f"the matmul adjoint at tile {tile} with {channels} channels",
                        matmul_smem_bytes(tile, least, (1, 1, 1), channels))
    nv = math.prod(tile)
    tiles = [-(-s // d) for s, d in zip(vol_shape, tile)]
    for cols in MATMUL_COLS:
        best = None
        for bx in range(1, min(tiles[0], cols // channels) + 1):
            for by in range(1, min(tiles[1], cols // (channels * bx)) + 1):
                for bz in range(1, min(tiles[2], cols // (channels * bx * by)) + 1):
                    box = (bx, by, bz)
                    smem = matmul_smem_bytes(tile, cols, box, channels)
                    if smem > bsi_ttli.MAX_SMEM_BYTES:
                        continue
                    boxes = tuple(-(-t // b) for t, b in zip(tiles, box))
                    partial = math.prod(b + 3 for b in box) * channels
                    row = bz * tile[2] * channels
                    lanes = bx * tile[0] * by * tile[1] * 32 * -(-row // 32)
                    cost = math.prod(boxes) * (64 * nv * cols + 8 * lanes + 200 * partial)
                    cand = (cost, partial, box, MatmulBlocks(box, cols, boxes, channels, smem))
                    best = cand if best is None else min(best, cand)
        if best is not None:
            return best[-1]
    raise AssertionError("unreachable: the least block fits")


def launch_matmul(g, out, tile, lib=None):
    """Launch the box kernel of ``g``'s dtype (float32 or bf16) and the seam
    pass on the current stream: ``g`` -> ``out`` (float32).  The partials
    (:attr:`MatmulBlocks.partial_floats`) are allocated here."""
    X, Y, Z, c = g.shape
    nx, ny, nz, _ = out.shape
    geo = matmul_blocks(tile, c, (X, Y, Z))
    partials = torch.empty(geo.partial_floats, dtype=torch.float32, device=g.device)
    lib = lib or load_library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = getattr(lib, f"bsi_adjoint_matmul_{bsi_ttli.ENTRY_SUFFIX[g.dtype]}")(
            g.data_ptr(), bsi_matmul.basis(tile, g.device).data_ptr(),
            partials.data_ptr(), out.data_ptr(), X, Y, Z, c, nx, ny, nz, *tile,
            *geo.box, geo.cols, stream)
    if rc:
        raise RuntimeError(f"bsi_adjoint_matmul kernel launch failed: cudaError_t {rc}")


def plain_matmul(g, tile, grid_shape):
    """The matmul kernels' function in tensor ops: zero-pad to whole tiles,
    then :func:`repro_torch.core.interpolate.bsi_adjoint_matmul`."""
    with torch.no_grad():
        return bsi_adjoint_matmul(_pad_to_tiles(g, tile, grid_shape), tile)


def plain_matmul_blocked(g, tile, grid_shape):
    """The kernels' blocked reduction in tensor ops: each tile's 64 bands
    (as :func:`plain_matmul`), overlap-added per box of :func:`matmul_blocks`
    into its partial in band order, then each control point's partials
    summed in box order.  The tiles past the volume add zeros where the
    kernel skips them."""
    X, Y, Z, c = g.shape
    geo = matmul_blocks(tile, c, (X, Y, Z))
    (bx, by, bz), (nbx, nby, nbz) = geo.box, geo.boxes
    tiles = (nbx * bx, nby * by, nbz * bz)  # the boxes' tiles, past the volume too
    span = [max(n, t + 3) for n, t in zip(grid_shape, tiles)]
    with torch.no_grad():
        u = g.new_zeros(tuple(t * d for t, d in zip(tiles, tile)) + (c,))
        u[:X, :Y, :Z] = g
        u = u.reshape(tiles[0], tile[0], tiles[1], tile[1], tiles[2], tile[2], c)
        u = u.permute(0, 2, 4, 1, 3, 5, 6).reshape(*tiles, math.prod(tile), c)
        bands = torch.einsum("vk,xyzvc->xyzck", bsi_matmul.basis(tile, g.device), u)
        bands = bands.reshape(nbx, bx, nby, by, nbz, bz, c, 4, 4, 4)
        bands = bands.permute(0, 2, 4, 1, 3, 5, 6, 7, 8, 9)
        part = g.new_zeros((nbx, nby, nbz, bx + 3, by + 3, bz + 3, c))
        for l in range(4):
            for m in range(4):
                for n in range(4):
                    part[:, :, :, l:l + bx, m:m + by, n:n + bz] += bands[..., l, m, n]
        out = g.new_zeros(tuple(span) + (c,))
        for i in range(nbx):
            for j in range(nby):
                for k in range(nbz):
                    out[i * bx:i * bx + bx + 3, j * by:j * by + by + 3,
                        k * bz:k * bz + bz + 3] += part[i, j, k]
        return out[:grid_shape[0], :grid_shape[1], :grid_shape[2]].contiguous()
