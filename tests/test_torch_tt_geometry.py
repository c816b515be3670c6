"""The TT forward kernel's blocks and thread mapping, in pure arithmetic.

``csrc/bsi_tt.cu`` runs in blocks sized by ``kernels.bsi_tt.tt_blocks``.
This file writes out, in numpy over a block's threads, the kernel's own
index arithmetic: each thread's slot (y tile, z tile, channel) decoded once
and its 64 grid addresses, the parts of the voxel columns, the weight slice
a column reads, each value's staging position, and, in each column, each
row's piece stored from its start rounded down to 32 floats (or, past 256
channels, each thread's own stores).  It checks that every ``(x, y, z,
channel)`` of the field is written exactly once and nothing outside it,
that each address equals the flat index it stands for, that each warp's
stores fall in one aligned 128-byte line, that every shared-memory access
lands inside the block's buffers and the block fits, and that the parts
cover each column once.  Then, in torch on the CPU, that the weights as the
kernel builds them, summed in its order, give ``bsi_tt.plain`` bit for
bit.  The card runs the kernel itself (``tests/test_torch_cuda.py``).
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import ffd
from repro_torch.core.bspline import weight_lut
from repro_torch.kernels import bsi_tt
from repro_torch.kernels.bsi_ttli import KERNEL_THREADS, MAX_SMEM_BYTES

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
THREADS = KERNEL_THREADS
GROUP = bsi_tt.GROUP_THREADS
PHANTOM1 = (512, 228, 385)
COARSE = (256, 114, 192)  # the pyramid's coarse level of phantom1
TILES = [(5, 5, 5), (5, 4, 3), (3, 3, 3), (7, 6, 5), (1, 1, 1)]
# odd volumes: z off the tile, one-tile volumes, many slot blocks a row
SMALL = [(13, 11, 9), (12, 11, 9), (22, 15, 30), (11, 12, 45), (5, 4, 3), (1, 1, 1),
         (7, 6, 700), (6, 7, 1500)]
# the grids of tests/test_torch_kernels.py:FORM_GRIDS: (tiles per axis, tile)
FORM_GRIDS = [((2, 5, 3), (5, 5, 5)), ((6, 2, 4), (5, 5, 5)),
              ((2, 5, 3), (3, 4, 2)), ((6, 2, 4), (3, 4, 2)),
              ((2, 5, 3), (1, 1, 1)), ((6, 2, 4), (1, 1, 1))]


def _geometry(tile, c, vol):
    """The blocks, checked against the launch's own sums (``tt_grid``) and
    the budget."""
    geo = bsi_tt.tt_blocks(tile, c, vol)
    dx, dy, dz = tile
    X, Y, Z = vol
    tx, ty, tz = -(-X // dx), -(-Y // dy), -(-Z // dz)
    assert geo.row_slots == tz * c
    block_slots = bsi_tt.GROUPS * geo.slots
    assert geo.grid == (-(-(ty * tz * c) // block_slots), tx, -(-(dx * dy) // geo.part_cols))
    assert geo.chunk == min(dz, bsi_tt.MAX_CHUNK)
    assert geo.weight_rows % geo.chunk == 0 and dz <= geo.weight_rows < dz + geo.chunk
    assert geo.direct == (c > GROUP)
    # the launch's own count (bsi_tt_f32): whole z tiles, or a group's threads
    assert geo.slots == (GROUP if geo.direct else GROUP // c * c)
    if not geo.direct:
        assert geo.slots % c == 0  # whole z tiles
    nw = geo.weight_rows * 64
    stage = -(-geo.slots * dz // 4) * 4 + 4  # room to align the values like the field
    assert geo.smem == 4 * (geo.part_cols * nw + bsi_tt.GROUPS * 2 * stage)
    assert geo.smem <= MAX_SMEM_BYTES
    assert geo.smem <= bsi_tt.TT_SMEM_BYTES or geo.part_cols == 1
    return geo


def _weight_reads(geo, dz):
    """The float4 reads of a column's weight slice over the chunks, ``(r0 +
    rr) * 64 + 4 * q4``, stay in its ``rows * 64`` floats, and each r < dz
    is summed once."""
    rows, R = geo.weight_rows, geo.chunk
    summed = []
    for r0 in range(0, dz, R):
        for rr in range(R):
            assert (r0 + rr) * 64 + 4 * 15 + 3 < rows * 64
            if r0 + rr < dz:
                summed.append(r0 + rr)
    assert summed == list(range(dz))


def _block(geo, tile, c, vol, grid_shape, block, itemsize=4):
    """One block over its threads: the flat field index of every value it
    writes, after checking each address, each staging position and each
    warp's line.  ``itemsize``: the field's bytes a value, 4 (float32) or 2
    (the bf16 kernel: ``E = 8`` values to 16 bytes, 64 to a 128-byte line,
    the staging in the float32 kernel's buffers)."""
    E, L = 16 // itemsize, 128 // itemsize
    dx, dy, dz = tile
    X, Y, Z = vol
    nx, ny, nz = grid_shape
    bx, ti, part = block
    x0 = ti * dx
    col0 = part * geo.part_cols
    col1 = min(col0 + geo.part_cols, min(dx, X - x0) * dy)
    if col0 >= col1:
        return np.zeros(0, np.int64), []
    assert col1 - col0 <= geo.part_cols  # the part's slices fit their room
    tz, ty = -(-Z // dz), -(-Y // dy)
    srow = tz * c
    total = ty * srow
    sg = geo.slots
    t = np.arange(THREADS)
    grp, lg = t // GROUP, t % GROUP
    sg0 = (bx * bsi_tt.GROUPS + grp) * sg
    nslots = np.clip(total - sg0, 0, sg)
    active = lg < nslots
    s = sg0 + np.where(active, lg, 0)
    tj = s // srow
    rem = s - tj * srow
    k = rem // c
    ch = rem - k * c

    # the 64 loads: each the flat index of (ti + l, tj + m, k + n, ch)
    ys, xs = nz * c, ny * nz * c
    src = (((ti * ny + tj) * nz + k) * c + ch)[active]
    q = np.arange(64)[:, None]
    l, m, n = q >> 4, (q >> 2) & 3, q & 3
    tja, ka, cha = tj[active], k[active], ch[active]
    flat = (((ti + l) * ny + tja + m) * nz + ka + n) * c + cha
    assert np.array_equal(src + l * xs + m * ys + n * c, flat)
    assert ti + 3 < nx and (tja + 3 < ny).all() and (ka + 3 < nz).all()

    st0 = np.where(geo.direct, lg, (lg - ch) * dz + ch)
    stride = GROUP if geo.direct else c
    written, cols = [], []
    for col in range(col0, col1):
        cols.append(col)
        a, b = col // dy, col % dy
        x, y = x0 + a, tj * dy + b
        comp = active & (y < Y)
        for gi in range(bsi_tt.GROUPS):
            mine = comp & (grp == gi)
            # staging: each value once, in the group's 2 x slots * dz; not
            # direct, (tj, z = k * dz + r, ch) at F - F0, F its position in
            # the x tile's field order
            sbuf = (-(-sg * dz // 4) * 4 + 4) * 4 // itemsize  # values of a buffer
            F0, length, frow = sg0[gi * GROUP] * dz, nslots[gi * GROUP] * dz, srow * dz
            # the column's staging offset: its first value shares the
            # alignment of its place in the field modulo E values (the
            # field's base is aligned, as an allocation is)
            tj_lo = F0 // frow
            delta = ((x * Y + tj_lo * dy + b) * Z * c + F0 - tj_lo * frow) % E
            staged = np.full(sbuf, -1, np.int64)
            for r in range(dz):
                idx = delta + (st0 + r * stride)[mine]
                assert (idx >= 0).all() and (idx < sbuf).all()
                assert (staged[idx] == -1).all()
                F = (tj * frow + (k * dz + r) * c + ch)[mine]
                if not geo.direct:
                    assert np.array_equal(F0 + idx - delta, F)
                staged[idx] = F
            if geo.direct:  # each thread its own values, from its staging
                for r in range(dz):
                    ok = mine & (k * dz + r < Z)
                    addr = (((x * Y + y) * Z + k * dz + r) * c + ch)[ok]
                    assert np.array_equal(staged[delta + (st0 + r * stride)[ok]],
                                          (tj * frow + (k * dz + r) * c + ch)[ok])
                    written.append(addr)
                continue
            if length == 0:
                continue
            lane = np.arange(GROUP)
            for rj in range(tj_lo, (F0 + length - 1) // frow + 1):
                yr = rj * dy + b
                if yr >= Y:
                    break
                rs = rj * frow
                lo, hi = max(F0, rs), min(F0 + length, rs + Z * c)
                o, n = (x * Y + yr) * Z * c + (lo - rs), hi - lo
                v0 = delta + lo - F0  # the piece's first staged value

                def stored(addr, pos):
                    """Stores of staged positions ``pos`` at ``addr``: each
                    the value staged there, inside the volume."""
                    v = staged[pos]
                    assert (v >= 0).all()  # written in the column's compute
                    zc = v - rj * frow
                    assert np.array_equal(addr, (x * Y + yr) * Z * c + zc)
                    assert (zc < Z * c).all()
                    written.append(addr)

                head = (E - o % E) % E
                body = max(n - head, 0) // E * E
                if body > 0 and (v0 + head) % E == 0:
                    # the bulk copy: 16-byte aligned at both ends, whole 16
                    # bytes; the head and the tail, each in one 16-byte run,
                    # by the first lanes
                    assert (o + head) % E == 0 and v0 + head + body <= sbuf
                    stored(o + head + np.arange(body), v0 + head + np.arange(body))
                    tail = n - head - body
                    assert head < E and tail < E
                    stored(o + lane[:head], v0 + lane[:head])
                    stored(o + head + body + lane[:tail], v0 + head + body + lane[:tail])
                    continue
                # otherwise the group's lanes from the piece's start rounded
                # down to a line of L values: every warp one aligned 128-byte
                # line (of bf16 values, one aligned half of one)
                qq = lane - o % L
                while (qq < n).any():
                    w = (qq >= 0) & (qq < n)
                    addr = o + qq
                    line = np.where(w, addr * itemsize // 128, -1).reshape(-1, 32)
                    has = w.reshape(-1, 32).any(axis=1)
                    lo_line = np.where(w.reshape(-1, 32), line, 1 << 62).min(axis=1)
                    assert (line.max(axis=1)[has] == lo_line[has]).all()  # a line a warp
                    stored(addr[w], v0 + qq[w])
                    qq = qq + GROUP
    out = np.concatenate(written) if written else np.zeros(0, np.int64)
    return out, cols


def _x_tile(geo, tile, c, vol, grid_shape, ti, itemsize=4):
    """Every slot block and part of x tile ``ti``: the parts cover each of
    its columns once; returns the flat indices of its values."""
    dx, dy, _ = tile
    cols, addrs = [], []
    for bx, part in itertools.product(range(geo.grid[0]), range(geo.grid[2])):
        addr, block_cols = _block(geo, tile, c, vol, grid_shape, (bx, ti, part), itemsize)
        addrs.append(addr)
        if bx == 0:
            cols += block_cols
    assert sorted(cols) == list(range(min(dx, vol[0] - ti * dx) * dy))
    return np.concatenate(addrs)


def _written_once(geo, tile, c, vol, tiles, itemsize=4):
    """The values of x tiles ``tiles``: each of theirs exactly once."""
    grid_shape = ffd.grid_shape_for_volume(vol, tile)
    X, Y, Z = vol
    plane = Y * Z * c
    for ti in tiles:
        x0 = ti * tile[0]
        addr = _x_tile(geo, tile, c, vol, grid_shape, ti, itemsize) - x0 * plane
        n = min(tile[0], X - x0) * plane
        assert (addr >= 0).all() and (addr < n).all()
        assert (np.bincount(addr, minlength=n) == 1).all()


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("vol", SMALL)
def test_every_value_written_once_small(tile, c, vol):
    """Every block of a small volume, the whole field counted."""
    geo = _geometry(tile, c, vol)
    _weight_reads(geo, tile[2])
    _written_once(geo, tile, c, vol, range(geo.grid[1]))


@pytest.mark.parametrize("vol,tile", [((13, 11, 9), (5, 4, 3)), ((7, 6, 20), (3, 3, 3))])
def test_many_channels_store_directly(vol, tile):
    """Past 256 channels a block holds 256 slots of one z tile and each
    thread stores its own values: still each value once."""
    c = 300
    geo = _geometry(tile, c, vol)
    assert geo.direct and geo.slots == GROUP
    _written_once(geo, tile, c, vol, range(geo.grid[1]))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("vol", [PHANTOM1, COARSE])
def test_every_value_written_once_phantom1(tile, c, vol):
    """phantom1 and its coarse level: a block's mapping depends on its x
    tile only through its offset and the volume's edge, so the first and
    last x tiles, with all their slot blocks and parts, stand for the
    rest; each value of theirs is written once."""
    geo = _geometry(tile, c, vol)
    _weight_reads(geo, tile[2])
    _written_once(geo, tile, c, vol, sorted({0, geo.grid[1] - 1}))


def test_phantom1_blocks():
    """At phantom1, tile 5^3, 3 channels: 63 slots a group of 64 threads
    (21 z tiles), 252 a block (a y tile's row has 231), 43 slot blocks an x
    tile, all 25 columns a block and their weight slices, 42,240 B of shared
    memory.  At the coarse level the 572 blocks fall short of 16 an SM, so
    each takes 7 of the 25 columns: 2,288 blocks."""
    geo = bsi_tt.tt_blocks((5, 5, 5), 3, PHANTOM1)
    assert (geo.slots, geo.row_slots, geo.grid, geo.part_cols) == (63, 231, (43, 103, 1), 25)
    assert (geo.chunk, geo.weight_rows, geo.smem) == (5, 5, 42_240)
    coarse = bsi_tt.tt_blocks((5, 5, 5), 3, COARSE)
    assert (coarse.grid, coarse.part_cols) == ((11, 52, 4), 7)
    assert bsi_tt.occupancy_key((5, 5, 5), 3, PHANTOM1) == (
        "bsi_tt_kernelILi5E", 42_240, (43, 103, 1))


def test_the_constants_are_the_csrc_ones():
    """A group's threads, the most z offsets summed together and a block's
    threads, as the geometry counts them, are the kernel's own."""
    csrc = Path(bsi_tt.__file__).parent.parent / "csrc"

    def const(name, file):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             (csrc / file).read_text()).group(1))

    assert const("kGroupThreads", "bsi_tt.cu") == bsi_tt.GROUP_THREADS
    assert const("kMaxChunk", "bsi_tt.cu") == bsi_tt.MAX_CHUNK
    assert const("kThreads", "bsi_common.cuh") == THREADS == 4 * bsi_tt.GROUP_THREADS


def test_blocks_refuse_what_does_not_fit():
    """A tile whose weight slices alone exceed a block's shared memory is
    refused before any launch; a long z tile runs in chunks of 8."""
    with pytest.raises(ValueError, match="shared memory"):
        bsi_tt.tt_blocks((5, 5, 1000), 3, (40, 40, 2000))
    geo = bsi_tt.tt_blocks((2, 2, 10), 3, (8, 8, 50))
    assert (geo.chunk, geo.weight_rows) == (8, 16)
    _weight_reads(geo, 10)


@pytest.mark.parametrize("tiles,tile", FORM_GRIDS)
def test_weight_slice_sums_equal_plain_bit_for_bit(tiles, tile):
    """The kernel's weight table (``bsi_tt.weight_table``) equals ``(wx *
    wy) * wz`` bit for bit, and the 64 terms ``acc + p * w`` in ``l, m, n``
    order with it (each rounded, as the kernel built without FMA
    contraction rounds them) give ``bsi_tt.plain`` bit for bit."""
    dx, dy, dz = tile
    tx, ty, tz = tiles
    rng = np.random.default_rng(33)
    phi = torch.from_numpy(
        rng.standard_normal((tx + 3, ty + 3, tz + 3, 3)).astype(np.float32) * 2.5)
    rows = bsi_tt.tt_blocks(tile, 3, tile).weight_rows
    W = bsi_tt.weight_table(tile, "cpu").reshape(dx, dy, rows, 64)
    wx, wy, wz = (weight_lut(d, torch.float32, "cpu") for d in tile)
    ref_w = ((wx[:, None, None, :, None, None] * wy[None, :, None, None, :, None])
             * wz[None, None, :, None, None, :]).reshape(dx, dy, dz, 64)
    assert torch.equal(W[:, :, :dz], ref_w)
    assert not W[:, :, dz:].any()
    acc = torch.zeros((tx, dx, ty, dy, tz, dz, 3))
    for q in range(64):
        l, m, n = q >> 4, (q >> 2) & 3, q & 3
        p = phi[l:l + tx, m:m + ty, n:n + tz][:, None, :, None, :, None, :]
        acc = acc + p * W[:, :, :dz, q][None, :, None, :, None, :, None]
    full = tuple(t * d for t, d in zip(tiles, tile))
    assert torch.equal(acc.reshape(full + (3,)), bsi_tt.plain(phi, tile, full))
