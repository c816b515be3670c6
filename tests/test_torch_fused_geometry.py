"""The lerp-form fused ssd and stats kernels' blocks and walk, in pure arithmetic.

``csrc/bsi_fused.cu:bsi_fused_walk_kernel`` runs on the forward kernels'
blocks, sized by ``kernels.bsi_fused.moment_blocks``: a block stages the
y-stage values of one (x tile, y tile) (``csrc/bsi_forward.cuh``:
``fwd_xy_stage``) and a z table of one float4 a voxel of a column's run
(its tile's offset, its three z lerp weights; stepped by
``fwd_z_positions``), then deals the lines of 32 voxels of its columns to its
8 warps.  This file writes out, in numpy over a block's threads, the
kernel's own index arithmetic: the z table as the prologue decodes it, each
warp's share of the lines and its stepping from column to column, each
lane's voxel from the column's start modulo 32 floats.  It checks that every voxel of the
volume is visited exactly once and none outside it, that the table's entry
of each voxel decodes to its flat index, that each warp's reads of the
streamed volume fall in one aligned 128-byte line, that every shared-memory
access stays inside the block's regions and that the block fits, with
``num_partials`` equal to the grid.  The card runs the kernels themselves
(``tests/test_torch_cuda.py``).
"""

import itertools
import math

import numpy as np
import pytest

from repro_torch.core import ffd
from repro_torch.kernels import bsi_fused, bsi_ttli

THREADS = bsi_ttli.KERNEL_THREADS
WARPS = THREADS // 32
PHANTOM1 = (512, 228, 385)
TILES = [(5, 5, 5), (5, 4, 3), (3, 3, 3), (7, 6, 5)]
# odd volumes: z off the tile, one-tile volumes, tall z (several blocks
# along z), and volumes of fewer lines than warps
SMALL = [(13, 11, 9), (12, 11, 9), (22, 15, 30), (11, 12, 45), (5, 4, 3), (1, 1, 1),
         (7, 6, 700), (6, 7, 1500)]


def _geometry(tile, vol):
    """The blocks, checked against the forward kernels' and the launch."""
    geo = bsi_fused.moment_blocks(tile, vol)
    fwd = bsi_ttli.forward_blocks(tile, 3, vol)
    dx, dy, dz = tile
    assert (geo.bz, geo.grid) == (fwd.bz, fwd.grid)
    assert geo.run == geo.bz * dz
    assert geo.smem == 16 * geo.run + 4 * dx * dy * (geo.bz + 3) * 3
    assert geo.smem <= bsi_ttli.MAX_SMEM_BYTES
    assert math.prod(geo.grid) == bsi_fused.num_partials(vol, tile, geo.tiles)
    assert geo.grid == (-(-vol[1] // dy), -(-vol[0] // dx), geo.grid[2])
    tiles_z = -(-vol[2] // dz)
    assert (geo.grid[2] - 1) * geo.bz < tiles_z <= geo.grid[2] * geo.bz
    return geo


def _z_table(geo, tile):
    """``fwd_z_positions(run, 1, dz, ...)``: each thread's first voxel
    decoded, then stepped 256 voxels at a time with carries; each entry
    written once, and each holds its voxel's tile offset into the column's
    y-stage values (3 floats a z control point) and the z LUT row z % dz of
    its weights, kept here as offset / 3 << 16 | row."""
    dz, c = tile[2], 1
    tab = np.full(geo.run, -1, np.int64)
    zs = THREADS // c
    cs, ks, rs = THREADS - zs * c, zs // dz, zs - (zs // dz) * dz
    for t in range(THREADS):
        z = t // c
        ch, k = t - z * c, z // dz
        r = z - k * dz
        for i in range(t, geo.run, THREADS):
            assert tab[i] == -1 and ch == 0
            tab[i] = k << 16 | r  # the float4 (3 k, t0[r], t1[r], s[r])
            ch += cs
            carry = int(ch >= c)
            ch -= carry * c
            r += rs + carry
            k += ks
            if r >= dz:
                r -= dz
                k += 1
    assert (tab >= 0).all() and (tab < 2**31).all()
    p = np.arange(geo.run)
    assert np.array_equal((tab >> 16) * dz + (tab & 0xFFFF), p)
    assert np.array_equal(tab & 0xFFFF, p % dz)
    return tab


def _xy_writes(geo, tile):
    """``fwd_xy_stage`` at 3 channels: every y-stage value of the block's
    columns written once, inside the region behind the table."""
    dx, dy, _ = tile
    q_cols = (geo.bz + 3) * 3
    writes = np.zeros(dx * dy * q_cols, np.int64)
    q = np.arange(q_cols)
    for a, b in itertools.product(range(dx), range(dy)):
        np.add.at(writes, (a * dy + b) * q_cols + q, 1)
    assert (writes == 1).all()


def _walk(geo, tile, vol, block, tab):
    """The walk of one block over its threads: the ``(x, y, z)`` of every
    voxel visited, one array each, after checking each warp's share of the
    lines, each lane's address against the flat index its table entry
    decodes to, each warp's reads of a line against one aligned 32-float
    line (the volume's base is aligned, as an allocation is) and each shared
    read against its region."""
    dx, dy, dz = tile
    X, Y, Z = vol
    tj, ti, bk = block
    q_cols = (geo.bz + 3) * 3
    hy_floats = dx * dy * q_cols
    x0, y0, z0 = ti * dx, tj * dy, bk * geo.bz * dz
    run = min(geo.run, Z - z0)
    nyl = min(dy, Y - y0)
    L = (run + 62) // 32  # the lines a run can touch, whatever its start
    assert 32 * L >= run + 31
    total = min(dx, X - x0) * nyl * L
    lane = np.arange(32)
    visited, shares = [], []
    for warp in range(WARPS):
        line, end = warp * total // WARPS, (warp + 1) * total // WARPS
        shares.append(end - line)
        l, xl, yl = line % L, line // L // nyl, line // L % nyl
        while line < end:
            n = min(L - l, end - line)
            at = ((x0 + xl) * Y + y0 + yl) * Z + z0
            h = (xl * dy + yl) * q_cols
            s = at % 32
            for p in 32 * np.arange(l, l + n)[:, None] + lane[None, :] - s:
                p = p[(p >= 0) & (p < run)]  # (unsigned)p < run
                if not p.size:
                    continue
                e = tab[p]
                off, cz = 3 * (e >> 16), e & 0xFFFF  # the offset, the LUT row
                assert (off // 3 * dz + cz == p).all()  # the table's voxel is the lane's
                addr = at + p
                assert np.array_equal(addr, ((x0 + xl) * Y + y0 + yl) * Z + z0 + p)
                assert len(np.unique(addr // 32)) == 1  # one aligned 128-byte line
                # the y-stage values read: 4 z control points x 3 channels
                assert (h + off >= 0).all() and (h + off + 11 < h + q_cols).all()
                assert (h + q_cols <= hy_floats) and (cz < dz).all()
                assert (p < geo.run).all()  # the table entry read is the block's
                visited.append(np.stack([np.full_like(p, x0 + xl),
                                         np.full_like(p, y0 + yl), z0 + p]))
            line += n
            l = 0
            yl += 1
            if yl == nyl:
                yl, xl = 0, xl + 1
    assert sum(shares) == total and max(shares) - min(shares) <= 1
    return np.concatenate(visited, axis=1) if visited else np.zeros((3, 0), np.int64)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("vol", SMALL)
def test_every_voxel_visited_once_small(tile, vol):
    """Every block of a small volume, the whole volume counted."""
    geo = _geometry(tile, vol)
    tab = _z_table(geo, tile)
    _xy_writes(geo, tile)
    count = np.zeros(math.prod(vol), np.int64)
    for block in itertools.product(*(range(n) for n in geo.grid)):
        x, y, z = _walk(geo, tile, vol, block, tab)
        assert (x < vol[0]).all() and (y < vol[1]).all() and (z < vol[2]).all()
        np.add.at(count, (x * vol[1] + y) * vol[2] + z, 1)
    assert (count == 1).all()


@pytest.mark.parametrize("tile", TILES)
def test_every_voxel_visited_once_phantom1(tile):
    """phantom1: a block's walk depends on the block only through its
    offsets and the volume's edges, so the first and last block of each
    axis (all their combinations) stand for the rest; each visits its box
    within the volume exactly once."""
    geo = _geometry(tile, PHANTOM1)
    tab = _z_table(geo, tile)
    _xy_writes(geo, tile)
    dx, dy, dz = tile
    for block in itertools.product(*({0, n - 1} for n in geo.grid)):
        pos = _walk(geo, tile, PHANTOM1, block, tab)
        tj, ti, bk = block
        lo = np.array([ti * dx, tj * dy, bk * geo.bz * dz])
        hi = np.minimum(lo + [dx, dy, geo.bz * dz], PHANTOM1)
        assert ((pos >= lo[:, None]) & (pos < hi[:, None])).all()
        n = hi - lo
        local = pos - lo[:, None]
        count = np.zeros(math.prod(n), np.int64)
        np.add.at(count, (local[0] * n[1] + local[1]) * n[2] + local[2], 1)
        assert (count == 1).all()


def test_phantom1_blocks():
    """At phantom1 and tile 5^3 a block holds the whole z extent, 25 columns
    of 385 voxels in 13 lines each; 4,738 blocks of 30.2 KB."""
    geo = bsi_fused.moment_blocks((5, 5, 5), PHANTOM1)
    assert (geo.bz, geo.grid, geo.run) == (77, (46, 103, 1), 385)
    assert geo.smem == 30_160 and bsi_fused.num_partials(PHANTOM1, (5, 5, 5),
                                                         geo.tiles) == 4738


def test_walk_geometry_matches_the_grid_shape():
    """The x-y stage's grid reads stay inside the control grid: x and y
    neighbours need no guard, z slots past the grid are masked (the forward
    kernels' own test checks the addresses)."""
    for tile, vol in itertools.product(TILES, SMALL + [PHANTOM1]):
        geo = bsi_fused.moment_blocks(tile, vol)
        nx, ny, nz = ffd.grid_shape_for_volume(vol, tile)
        assert geo.grid[1] + 3 <= nx and geo.grid[0] + 3 <= ny
        assert (geo.grid[2] - 1) * geo.bz < nz


def test_moment_blocks_refuse_what_does_not_fit():
    """A tile whose block of one tile along z exceeds a block's shared
    memory is refused before any launch."""
    with pytest.raises(ValueError, match="shared memory"):
        bsi_fused.moment_blocks((70, 70, 5), (140, 140, 40))
