"""The forward kernels' blocks and thread mapping, in pure arithmetic.

``csrc/bsi_forward.cuh`` (the device code of ``bsi_ttli`` and
``bsi_separable``) runs in blocks sized by
``kernels.bsi_ttli.forward_blocks``.  This file writes out, in numpy over a
block's threads, the kernel's own index arithmetic: the x-y stage's slots
and grid addresses, the z table the block decodes in its prologue (each
position's offset and voxel offset, packed in one int), and, in each of
the block's columns, each thread's positions from the column's start
rounded down to 32 floats.  It checks that every ``(x, y, z, channel)`` of
the field is written exactly once and nothing outside it, that each
address equals the flat index it stands for, that each warp's stores fall
in one aligned 128-byte line, that every shared-memory read and write
lands inside the block's y-stage values, and that the block fits.  The
bf16 kernels (``bsi_ttli_bf16``, ``bsi_separable_bf16``) share all of it
but the stores: a thread takes pairs of positions from the column's start
rounded down to 64 values, so the same checks run on their mapping, each
pair one aligned 4-byte store and a pair straddling the run's ends storing
its one value inside.  The card runs the kernels themselves
(``tests/test_torch_cuda.py``).
"""

import itertools

import numpy as np
import pytest

from repro_torch.core import ffd
from repro_torch.kernels import bsi_ttli

THREADS = bsi_ttli.KERNEL_THREADS
PHANTOM1 = (512, 228, 385)
TILES = [(5, 5, 5), (5, 4, 3), (3, 3, 3), (7, 6, 5)]
# odd volumes: z off the block, one-tile volumes, several blocks along z
SMALL = [(13, 11, 9), (12, 11, 9), (22, 15, 30), (11, 12, 45), (5, 4, 3), (1, 1, 1),
         (7, 6, 700), (6, 7, 1500)]


def _xy_stage(geo, tile, c, grid_shape, block):
    """The x-y stage of one block: each slot's 16 grid addresses equal the
    flat indices of its neighbours, and the y-stage values are written once
    each, behind the z table in shared memory."""
    (dx, dy, dz), (nx, ny, nz) = tile, grid_shape
    tj, ti, bk = block
    tk0 = bk * geo.bz
    q_cols = (geo.bz + 3) * c
    assert ti + 3 < nx and tj + 3 < ny  # the x and y neighbours need no guard
    q = np.arange(q_cols)  # slots q = threadIdx.x, + THREADS, ...
    inside = q < (nz - tk0) * c
    zrow = nz * c
    src = (ti * ny + tj) * zrow + tk0 * c
    for l, m in itertools.product(range(4), range(4)):
        addr = src + (l * ny + m) * zrow + q
        flat = (((ti + l) * ny + (tj + m)) * nz + tk0 + q // c) * c + q % c
        assert np.array_equal(addr[inside], flat[inside])
        assert addr[inside].max(initial=0) < nx * ny * nz * c
    writes = np.zeros(dx * dy * q_cols, np.int64)
    for a, b in itertools.product(range(dx), range(dy)):
        np.add.at(writes, (a * dy + b) * q_cols + q, 1)
    assert (writes == 1).all()
    assert 4 * (geo.run + 4 * dz + writes.size) == geo.smem


def _table(geo, tile, c):
    """The z table as the kernel builds it, each thread's positions stepped
    with carries, and reads it, each entry checked against the position it
    stands for: the offsets."""
    dz = tile[2]
    tab = np.full(geo.run, -1, np.int32)
    zs = THREADS // c
    cs, ks, rs = THREADS - zs * c, zs // dz, zs - (zs // dz) * dz
    for t in range(THREADS):  # each thread's first position, then its steps
        z = t // c
        ch, k = t - z * c, z // dz
        r = z - k * dz
        for i in range(t, geo.run, THREADS):
            assert tab[i] == -1  # each entry written once
            tab[i] = (k * c + ch) << 16 | r
            ch += cs
            carry = int(ch >= c)
            ch -= carry * c
            r += rs + carry
            k += ks
            if r >= dz:
                r -= dz
                k += 1
    assert (tab >= 0).all()
    off, cz = tab >> 16, tab & 0xFFFF
    p = np.arange(geo.run)
    z, ch = p // c, p % c
    assert np.array_equal(off, (z // dz) * c + ch) and np.array_equal(cz, z % dz)
    return off


def _z_stage(geo, tile, c, vol, block, off):
    """The z stage of one block, over its threads: the ``(x, y, z, channel)``
    of every value written, one array each, after checking each address
    against the flat index it stands for, each warp's stores against one
    aligned 32-float line (the field's base is aligned, as an allocation
    is) and each y-stage read against the block's."""
    dx, dy, dz = tile
    X, Y, Z = vol
    tj, ti, bk = block
    q_cols = (geo.bz + 3) * c
    assert geo.run == geo.bz * dz * c
    z0 = bk * geo.bz * dz
    run = min(geo.run, (Z - z0) * c)
    t = np.arange(THREADS)
    x0, y0 = ti * dx, tj * dy
    written = []
    for xl, yl in itertools.product(range(min(dx, X - x0)), range(min(dy, Y - y0))):
        x, y = x0 + xl, y0 + yl
        start = (x * Y + y) * Z * c + z0 * c
        p = t - start % 32  # the kernel's first position; then + THREADS
        while (p < run).any():
            w = (p >= 0) & (p < run)
            pw = p[w]
            addr = start + pw
            flat = ((x * Y + y) * Z + z0 + pw // c) * c + pw % c
            assert np.array_equal(addr, flat)
            for warp in np.unique(t[w] // 32):  # one aligned 128-byte line a warp
                assert len(np.unique(addr[t[w] // 32 == warp] // 32)) == 1
            # the four y-stage values read: (a, b, tz + n, ch) of the block
            assert (off[pw] // c + 3 < geo.bz + 3).all()
            assert ((xl * dy + yl) * q_cols + off[pw] + 3 * c < dx * dy * q_cols).all()
            written.append(np.stack([np.full_like(pw, x), np.full_like(pw, y),
                                     z0 + pw // c, pw % c]))
            p = p + THREADS
    return np.concatenate(written, axis=1) if written else np.zeros((4, 0), np.int64)


def _z_stage_bf16(geo, tile, c, vol, block, off):
    """:func:`_z_stage` for the bf16 kernels: thread ``t`` stores the pairs
    ``(2t - s, 2t - s + 1) + k * 2 * THREADS``, ``s`` the column's start
    modulo 64 values; a pair with both inside the run is one 4-byte store
    at an even value, a pair with one inside stores that one, and every
    store of a warp falls in one aligned 128-byte line (64 values).  The
    positions a thread computes but does not store stay inside the run."""
    dx, dy, dz = tile
    X, Y, Z = vol
    tj, ti, bk = block
    q_cols = (geo.bz + 3) * c
    z0 = bk * geo.bz * dz
    run = min(geo.run, (Z - z0) * c)
    t = np.arange(THREADS)
    x0, y0 = ti * dx, tj * dy
    written = []
    for xl, yl in itertools.product(range(min(dx, X - x0)), range(min(dy, Y - y0))):
        x, y = x0 + xl, y0 + yl
        start = (x * Y + y) * Z * c + z0 * c
        p = 2 * t - start % 64  # the kernel's first pair; then + 2 * THREADS
        while (p < run).any():
            live = p < run
            in0 = live & (p >= 0)
            in1 = live & (p + 1 >= 0) & (p + 1 < run)
            # the z-table reads of both positions, clamped into the run
            for q in (np.maximum(p[live], 0), np.minimum(np.maximum(p[live] + 1, 0), run - 1)):
                assert ((q >= 0) & (q < run)).all()
            pair = in0 & in1
            assert ((start + p[pair]) % 2 == 0).all()  # 4-byte aligned pairs
            stored = np.concatenate([p[in0], p[in1] + 1])
            owner = np.concatenate([t[in0], t[in1]])
            addr = start + stored
            flat = ((x * Y + y) * Z + z0 + stored // c) * c + stored % c
            assert np.array_equal(addr, flat)
            for warp in np.unique(owner // 32):  # one aligned 128-byte line a warp
                assert len(np.unique(addr[owner // 32 == warp] // 64)) == 1
            assert ((xl * dy + yl) * q_cols + off[stored] + 3 * c < dx * dy * q_cols).all()
            written.append(np.stack([np.full_like(stored, x), np.full_like(stored, y),
                                     z0 + stored // c, stored % c]))
            p = p + 2 * THREADS
    return np.concatenate(written, axis=1) if written else np.zeros((4, 0), np.int64)


def _geometry(tile, c, vol):
    geo = bsi_ttli.forward_blocks(tile, c, vol)
    dx, dy, dz = tile
    assert geo.smem <= bsi_ttli.MAX_SMEM_BYTES
    assert geo.smem <= max(bsi_ttli.FORWARD_SMEM_BYTES, 4 * (dz * c + 4 * dz + dx * dy * 4 * c))
    tiles = [-(-s // d) for s, d in zip(vol, tile)]
    assert geo.grid == (tiles[1], tiles[0], -(-tiles[2] // geo.bz))
    # the blocks' boxes tile the volume: whole tiles along x and y, runs of
    # bz tiles along z, the last of each axis reaching past the volume
    assert (geo.grid[2] - 1) * geo.bz < tiles[2] <= geo.grid[2] * geo.bz
    return geo


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("vol", SMALL)
def test_every_voxel_written_once_small(tile, c, vol):
    """Every block of a small volume, the whole field counted."""
    geo = _geometry(tile, c, vol)
    grid_shape = ffd.grid_shape_for_volume(vol, tile)
    off = _table(geo, tile, c)
    count = np.zeros(int(np.prod(vol)) * c, np.int64)
    for block in itertools.product(*(range(n) for n in geo.grid)):
        _xy_stage(geo, tile, c, grid_shape, block)
        x, y, z, ch = _z_stage(geo, tile, c, vol, block, off)
        assert (x < vol[0]).all() and (y < vol[1]).all() and (z < vol[2]).all()
        np.add.at(count, ((x * vol[1] + y) * vol[2] + z) * c + ch, 1)
    assert (count == 1).all()


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("c", [1, 3])
def test_every_voxel_written_once_phantom1(tile, c):
    """phantom1: a block's mapping depends on the block only through its
    offsets and the volume's edges, so the first and last block of each
    axis (all their combinations) stand for the rest; each writes its box
    within the volume exactly once."""
    geo = _geometry(tile, c, PHANTOM1)
    grid_shape = ffd.grid_shape_for_volume(PHANTOM1, tile)
    dx, dy, dz = tile
    off = _table(geo, tile, c)
    for block in itertools.product(*({0, n - 1} for n in geo.grid)):
        _xy_stage(geo, tile, c, grid_shape, block)
        pos = _z_stage(geo, tile, c, PHANTOM1, block, off)
        tj, ti, bk = block
        lo = np.array([ti * dx, tj * dy, bk * geo.bz * dz, 0])
        hi = np.minimum(lo + [dx, dy, geo.bz * dz, c], PHANTOM1 + (c,))
        assert ((pos >= lo[:, None]) & (pos < hi[:, None])).all()
        n = hi - lo
        local = pos - lo[:, None]
        count = np.zeros(int(np.prod(n)), np.int64)
        np.add.at(count, ((local[0] * n[1] + local[1]) * n[2] + local[2]) * n[3]
                  + local[3], 1)
        assert (count == 1).all()


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("vol", SMALL)
def test_bf16_every_value_written_once_small(tile, c, vol):
    """The bf16 stores: every block of a small volume (odd runs, columns
    starting on odd values), the whole field counted."""
    geo = _geometry(tile, c, vol)
    off = _table(geo, tile, c)
    count = np.zeros(int(np.prod(vol)) * c, np.int64)
    for block in itertools.product(*(range(n) for n in geo.grid)):
        x, y, z, ch = _z_stage_bf16(geo, tile, c, vol, block, off)
        assert (x < vol[0]).all() and (y < vol[1]).all() and (z < vol[2]).all()
        np.add.at(count, ((x * vol[1] + y) * vol[2] + z) * c + ch, 1)
    assert (count == 1).all()


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("c", [1, 3])
def test_bf16_every_value_written_once_phantom1(tile, c):
    """The bf16 stores at phantom1, the first and last block of each axis
    as in :func:`test_every_voxel_written_once_phantom1`."""
    geo = _geometry(tile, c, PHANTOM1)
    dx, dy, dz = tile
    off = _table(geo, tile, c)
    for block in itertools.product(*({0, n - 1} for n in geo.grid)):
        pos = _z_stage_bf16(geo, tile, c, PHANTOM1, block, off)
        tj, ti, bk = block
        lo = np.array([ti * dx, tj * dy, bk * geo.bz * dz, 0])
        hi = np.minimum(lo + [dx, dy, geo.bz * dz, c], PHANTOM1 + (c,))
        assert ((pos >= lo[:, None]) & (pos < hi[:, None])).all()
        n = hi - lo
        local = pos - lo[:, None]
        count = np.zeros(int(np.prod(n)), np.int64)
        np.add.at(count, ((local[0] * n[1] + local[1]) * n[2] + local[2]) * n[3]
                  + local[3], 1)
        assert (count == 1).all()


def test_phantom1_blocks_span_the_volume_along_z():
    """At phantom1 and tile 5^3 a block holds the whole z extent: whole
    (x, y) rows of the field, 5 rows of one x contiguous."""
    geo = bsi_ttli.forward_blocks((5, 5, 5), 3, PHANTOM1)
    assert geo.grid == (46, 103, 1) and geo.bz == 77
    assert (geo.run, geo.smem) == (1155, 28_700)


def test_forward_blocks_refuse_what_does_not_fit():
    """A tile whose block of one tile along z exceeds a block's shared
    memory (the four z control points of its dx * dy columns, or its z
    table) is refused before any launch."""
    with pytest.raises(ValueError, match="shared memory"):
        bsi_ttli.forward_blocks((70, 70, 5), 3, (140, 140, 40))
    with pytest.raises(ValueError, match="shared memory"):
        bsi_ttli.forward_blocks((5, 5, 10_000), 3, (40, 40, 20_000))
    bsi_ttli.forward_blocks((60, 60, 5), 3, (120, 120, 40))
