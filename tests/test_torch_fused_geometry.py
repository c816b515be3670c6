"""The fused ssd, stats and ncc kernels' blocks and walk, in pure arithmetic.

``csrc/bsi_fused.cu:bsi_fused_walk_kernel`` runs, in both displacement
forms, on the forward kernels' blocks, sized by
``kernels.bsi_fused.moment_blocks``, and deals the lines of 32 voxels of a
block's columns to its 8 warps (``walk_lines``).  The lerp form stages the
y-stage values of one (x tile, y tile) (``csrc/bsi_forward.cuh``:
``fwd_xy_stage``) and a z table of one float4 a voxel of a column's run
(its tile's offset, its three z lerp weights; stepped by
``fwd_z_positions``), then walks each run in one pass.  The matrix form
stages the basis, then takes the run in chunks of z tiles: it stages the
chunk's control window, computes the displacement of its voxels into
shared memory, one item of two tiles of a column a thread
(``walk_chunk_disp``), and walks the chunk's voxels.  This file writes out,
in numpy over a block's threads, the kernel's own index arithmetic: the z
table as the prologue decodes it, the matrix form's items, each warp's share
of the lines and its stepping from column to column, each lane's voxel from
the start modulo 32 floats.  It checks that every voxel of the volume is
visited exactly once and none outside it, that the table's entry of each
voxel decodes to its flat index, that the matrix form's items write each
voxel's displacement once and the walk reads it there, that each warp's
reads of the streamed volume fall in one aligned 128-byte line, that every
shared-memory access stays inside the block's regions and a warp's 16-byte
window loads take the fewest wavefronts their points allow, and that the
block fits, with ``num_partials`` equal to the grid.  A float32 twin of the
matrix form's chunks, separate multiplies and adds in ``k`` order from the
staged basis and window, equals ``bsi_matmul.plain`` and the warp of
``bsi_fused.warped`` bit for bit.  The card runs the kernels themselves
(``tests/test_torch_cuda.py``).
"""

import itertools
import math
import re
from pathlib import Path

import numpy as np
import pytest

import torch

from repro_torch.core import ffd
from repro_torch.kernels import bsi_fused, bsi_matmul, bsi_ttli

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
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


def _lines(tile, vol, block, bz, za, zb, itemsize=4):
    """``walk_lines`` of one block over its threads, voxels [za, zb) of each
    run: ``(xl, yl, at, p)`` for each warp's line with voxels in it (``p``
    the lanes' voxels inside [za, zb), ``at`` the column's flat index of
    voxel 0 of the run), after checking the warps' shares of the lines, each
    lane's address against the flat index and each warp's reads of a line
    against one aligned line of 32 values of ``itemsize`` bytes (the
    volume's base is aligned, as an allocation is): a 128-byte line of
    floats, a 64-byte half of one of bf16 values (the bf16 stats walk)."""
    dx, dy, dz = tile
    X, Y, Z = vol
    tj, ti, bk = block
    x0, y0, z0 = ti * dx, tj * dy, bk * bz * dz
    nyl = min(dy, Y - y0)
    L = (zb - za + 62) // 32  # the lines [za, zb) can touch, whatever its start
    assert 32 * L >= zb - za + 31
    total = min(dx, X - x0) * nyl * L
    lane = np.arange(32)
    out, shares = [], []
    for warp in range(WARPS):
        line, end = warp * total // WARPS, (warp + 1) * total // WARPS
        shares.append(end - line)
        l, xl, yl = line % L, line // L // nyl, line // L % nyl
        while line < end:
            n = min(L - l, end - line)
            at = ((x0 + xl) * Y + y0 + yl) * Z + z0
            s = (at + za) % 32
            for p in za + 32 * np.arange(l, l + n)[:, None] + lane[None, :] - s:
                p = p[(p >= za) & (p < zb)]  # (unsigned)(p - za) < zb - za
                if not p.size:
                    continue
                addr = at + p
                assert np.array_equal(addr, ((x0 + xl) * Y + y0 + yl) * Z + z0 + p)
                assert len(np.unique(addr // 32)) == 1  # one aligned line of 32 values
                assert len(np.unique(addr * itemsize // 128)) == 1  # in one 128-byte line
                out.append((xl, yl, at, p))
            line += n
            l = 0
            yl += 1
            if yl == nyl:
                yl, xl = 0, xl + 1
    assert sum(shares) == total and max(shares) - min(shares) <= 1
    return out


def _positions(tile, vol, block, bz, visits):
    dx, dy, dz = tile
    tj, ti, bk = block
    x0, y0, z0 = ti * dx, tj * dy, bk * bz * dz
    if not visits:
        return np.zeros((3, 0), np.int64)
    return np.concatenate([np.stack([np.full_like(p, x0 + xl), np.full_like(p, y0 + yl),
                                     z0 + p]) for xl, yl, _, p in visits], axis=1)


def _walk(geo, tile, vol, block, tab):
    """The lerp form's walk of one block over its threads: the ``(x, y, z)``
    of every voxel visited, one array each, after checking the lines
    (:func:`_lines`), each lane's table entry against its voxel and each
    shared read against its region."""
    dx, dy, dz = tile
    q_cols = (geo.bz + 3) * 3
    hy_floats = dx * dy * q_cols
    z0 = block[2] * geo.bz * dz
    run = min(geo.run, vol[2] - z0)
    visits = _lines(tile, vol, block, geo.bz, 0, run)
    for xl, yl, _, p in visits:
        h = (xl * dy + yl) * q_cols
        e = tab[p]
        off, cz = 3 * (e >> 16), e & 0xFFFF  # the offset, the LUT row
        assert (off // 3 * dz + cz == p).all()  # the table's voxel is the lane's
        # the y-stage values read: 4 z control points x 3 channels
        assert (h + off >= 0).all() and (h + off + 11 < h + q_cols).all()
        assert (h + q_cols <= hy_floats) and (cz < dz).all()
        assert (p < geo.run).all()  # the table entry read is the block's
    return _positions(tile, vol, block, geo.bz, visits)


def _wavefronts(quads):
    """16-byte shared loads of a warp at float4 offsets ``quads``: the
    wavefronts they take (a wavefront serves one 16-byte quad of each of the
    8 bank groups; lanes at one address share it) and the least any layout
    could give them."""
    quads = np.unique(quads)
    return np.bincount(quads % 8, minlength=8).max(), -(-len(quads) // 8)


def _chunks(geo, tile, vol, block):
    """The matrix form's chunks of one block: for each, ``(c0, zt, items,
    visits)``: its first tile and tile count, its items ``(i, c, t)`` (the
    thread of item i sums column c's ``WALK_TILES`` tiles from t) and the
    walk of its voxels (:func:`_lines`), after checking that the items write
    the
    displacement of each voxel of the chunk's tiles once, that every shared
    read stays in its region, that a warp's window loads, and in a block of
    whole columns its basis loads, take the fewest wavefronts their
    addresses allow, and that the walk reads each voxel's displacement where
    its item wrote it."""
    dx, dy, dz = tile
    X, Y, Z = vol
    tj, ti, bk = block
    x0, y0, z0 = ti * dx, tj * dy, bk * geo.bz * dz
    run = min(geo.run, Z - z0)
    nyl, ncols = min(dy, Y - y0), min(dx, X - x0) * min(dy, Y - y0)
    full = ncols == dx * dy  # a block of whole columns: its rows are consecutive
    chunk, wq, cv = geo.chunk, bsi_fused.window_part(geo.chunk), geo.chunk * dz
    nv, B, T = dx * dy * dz, bsi_fused.BASIS_ROW, bsi_fused.WALK_TILES
    tiles = -(-run // dz)
    out = []
    for c0 in range(0, tiles, chunk):
        zt = min(chunk, tiles - c0)
        items = -(-zt // T)
        i = np.arange(ncols * items)
        c, t = i // items, T * (i % items)
        xl, yl = c // nyl, c % nyl
        written = np.zeros(ncols * cv, np.int64)
        for j in range(T):
            real = t + j < zt  # tiles of an item past the chunk are not stored
            for r in range(dz):
                np.add.at(written, (c * cv + (t + j) * dz + r)[real], 1)
                rows = (xl * dy + yl) * dz + r  # the basis row, 16 quads every B
                assert (rows >= 0).all() and (rows < nv).all()
                for w0 in range(0, len(i) * full, 32):  # a warp's loads of quad q
                    got, least = _wavefronts(B * rows[w0:w0 + 32])
                    assert got == least
        for m in range(T + 3):
            # window point (q, t + m), q = l * 4 + m: its quad in the row's
            # part of z points t + m mod T, within the staged points or, for
            # tiles not stored, the room past them
            kz = t + m
            quad = (kz % T) * wq + kz // T
            used = t + max(0, m - 3) < zt  # by a tile of the item that is stored
            assert (quad < T * wq).all() and (kz // T < wq).all()
            assert (kz[used] < zt + 3).all()
            for w0 in range(0, len(i), 32):  # a warp's loads: quad q T wq + quad
                got, least = _wavefronts(quad[w0:w0 + 32])
                assert got == least
        assert np.array_equal(written.reshape(ncols, cv)[:, :zt * dz],
                              np.ones((ncols, zt * dz), np.int64))
        assert (written.reshape(ncols, cv)[:, zt * dz:] == 0).all()
        za = c0 * dz
        visits = _lines(tile, vol, block, geo.bz, za, min(run, za + zt * dz))
        for vxl, vyl, _, p in visits:  # the displacement read: x, then y and z at +su
            idx = (vxl * nyl + vyl) * cv + p - za
            assert (idx >= 0).all() and (idx < ncols * cv).all()
            assert (written[idx] == 1).all()
        out.append((c0, zt, (i, c, t), visits))
    return out


def _matmul_walk(geo, tile, vol, block):
    """The matrix form's walk of one block: the ``(x, y, z)`` of every voxel
    visited (:func:`_chunks`)."""
    visits = [v for _, _, _, vs in _chunks(geo, tile, vol, block) for v in vs]
    return _positions(tile, vol, block, geo.bz, visits)


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
@pytest.mark.parametrize("vol", SMALL[:4] + [PHANTOM1])
def test_bf16_stats_lines_are_aligned_half_lines(tile, vol):
    """The bf16 stats walk (``bsi_fused_walk_bf16_kernel<F, kStats>``) streams
    the bf16 moving volume: the same lines of 32 voxels, aligned to 32
    values, each warp's reads one aligned 64-byte half of a 128-byte line;
    the first and last block of each axis."""
    geo = _geometry(tile, vol)
    dz = tile[2]
    for block in itertools.product(*({0, n - 1} for n in geo.grid)):
        z0 = block[2] * geo.bz * dz
        run = min(geo.run, vol[2] - z0)
        visits = _lines(tile, vol, block, geo.bz, 0, run, itemsize=2)
        nx, ny = (min(d, s - b * d) for d, s, b in zip(tile, vol, (block[1], block[0])))
        assert sum(len(p) for *_, p in visits) == nx * ny * run


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


def _matmul_geometry(tile, vol):
    """The matrix form's blocks: the forward kernels', its chunk and its
    shared memory (basis, the chunk's window, its displacement)."""
    geo = bsi_fused.moment_blocks(tile, vol, "matmul")
    lerp = bsi_fused.moment_blocks(tile, vol)
    dx, dy, dz = tile
    assert (geo.bz, geo.grid, geo.run) == (lerp.bz, lerp.grid, lerp.run)
    T = bsi_fused.WALK_TILES
    assert geo.chunk == min(geo.bz, T * max(1, THREADS // (dx * dy)))
    assert geo.smem == (16 * (bsi_fused.BASIS_ROW * dx * dy * dz
                              + 2 * 16 * T * bsi_fused.window_part(geo.chunk))
                        + 12 * dx * dy * geo.chunk * dz)
    assert geo.smem <= bsi_ttli.MAX_SMEM_BYTES
    return geo


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("vol", SMALL)
def test_matmul_every_voxel_visited_once_small(tile, vol):
    """The matrix form: every block of a small volume, the whole volume
    counted, chunk by chunk."""
    geo = _matmul_geometry(tile, vol)
    count = np.zeros(math.prod(vol), np.int64)
    for block in itertools.product(*(range(n) for n in geo.grid)):
        x, y, z = _matmul_walk(geo, tile, vol, block)
        assert (x < vol[0]).all() and (y < vol[1]).all() and (z < vol[2]).all()
        np.add.at(count, (x * vol[1] + y) * vol[2] + z, 1)
    assert (count == 1).all()


@pytest.mark.parametrize("tile", TILES)
def test_matmul_every_voxel_visited_once_phantom1(tile):
    """phantom1 in the matrix form: the first and last block of each axis
    visit their boxes once."""
    geo = _matmul_geometry(tile, PHANTOM1)
    dx, dy, dz = tile
    for block in itertools.product(*({0, n - 1} for n in geo.grid)):
        pos = _matmul_walk(geo, tile, PHANTOM1, block)
        tj, ti, bk = block
        lo = np.array([ti * dx, tj * dy, bk * geo.bz * dz])
        hi = np.minimum(lo + [dx, dy, geo.bz * dz], PHANTOM1)
        n = hi - lo
        local = pos - lo[:, None]
        assert ((local >= 0) & (local < n[:, None])).all()
        count = np.zeros(math.prod(n), np.int64)
        np.add.at(count, (local[0] * n[1] + local[1]) * n[2] + local[2], 1)
        assert (count == 1).all()


def test_phantom1_matmul_blocks():
    """At phantom1 and tile 5^3 the matrix form's block holds the whole z
    extent in chunks of 20 tiles, 250 items of two tiles each (one a thread
    but 6), 76,288 B of shared memory (34,000 B of basis, two windows of
    6,144, 30,000 of displacement): three blocks an SM."""
    geo = _matmul_geometry((5, 5, 5), PHANTOM1)
    assert (geo.bz, geo.grid, geo.chunk, geo.smem) == (77, (46, 103, 1), 20, 76_288)
    assert 233_472 // (geo.smem + 128 + 1024) == 3


@pytest.mark.parametrize("tile,vol", [((10, 10, 10), (40, 40, 40)),  # its basis, 256 KB
                                      ((70, 70, 5), (140, 140, 40))])
def test_matmul_moment_blocks_refuse_what_does_not_fit(tile, vol):
    """The matrix form refuses a tile whose basis and chunk exceed a
    block's shared memory before any launch; an unknown form is refused."""
    with pytest.raises(ValueError, match="shared memory"):
        bsi_fused.moment_blocks(tile, vol, "matmul")
    with pytest.raises(ValueError, match="disp_form"):
        bsi_fused.moment_blocks((5, 5, 5), (40, 40, 40), "tt")


@pytest.mark.parametrize("form", bsi_fused.DISP_FORMS)
@pytest.mark.parametrize("kind", ["ssd", "stats", "ncc"])
def test_occupancy_key(kind, form):
    """Each (form, moment) names its own instantiation of the walk, with its
    block's shared memory and grid."""
    symbol, smem, grid = bsi_fused.occupancy_key(kind, form, (5, 5, 5), PHANTOM1)
    f, k = bsi_fused.DISP_FORMS.index(form), ("ssd", "stats", "ncc").index(kind)
    assert symbol == f"bsi_fused_walk_kernelILi{f}ELi{k}EE"
    geo = bsi_fused.moment_blocks((5, 5, 5), PHANTOM1, form)
    assert (smem, grid) == (geo.smem, geo.grid)
    # the bf16 and fp16 kernels of the same form, on the same blocks
    for dtype, sx in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        assert bsi_fused.occupancy_key(kind, form, (5, 5, 5), PHANTOM1, dtype=dtype) == (
            f"bsi_fused_walk_{sx}_kernelILi{f}ELi{k}EE", smem, grid)


def test_the_constants_are_the_csrc_ones():
    """The matrix-form walk's basis row stride, tiles an item and a block's
    threads, as this file and ``moment_blocks`` count them, are the
    kernel's own (the card checks the layout itself:
    ``bsi_fused.check_walk_layout`` at every launch)."""
    csrc = Path(bsi_fused.__file__).parent.parent / "csrc"

    def const(name, file):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             (csrc / file).read_text()).group(1))

    assert const("kBasisRow", "bsi_fused.cu") == bsi_fused.BASIS_ROW
    assert const("kWalkTiles", "bsi_fused.cu") == bsi_fused.WALK_TILES
    assert const("kThreads", "bsi_common.cuh") == THREADS


def _matmul_twin(phi, tile, vol, geo):
    """The matrix form's walk in float32 numpy, block by block and chunk by
    chunk, from its staged basis and window (0 past the grid and past the
    chunk's points), each read at the quad :func:`_chunks` checks: per item
    and tile, per channel, the 64 products rounded, then added, in ``k``
    order; the walk reads each voxel's sum back.  Returns the displacement
    at every voxel, ``vol + (3,)``."""
    dx, dy, dz = tile
    nz = phi.shape[2]
    B = bsi_fused.BASIS_ROW
    rows_ = bsi_matmul.basis(tile, "cpu").numpy().reshape(-1, 16, 4)
    s_basis = np.zeros((len(rows_) * B, 4), np.float32)
    s_basis[(np.arange(len(rows_))[:, None] * B + np.arange(16)).ravel()] = \
        rows_.reshape(-1, 4)
    out = np.full(vol + (3,), np.nan, np.float32)
    wq, cv, T = bsi_fused.window_part(geo.chunk), geo.chunk * dz, bsi_fused.WALK_TILES
    for block in itertools.product(*(range(n) for n in geo.grid)):
        tj, ti, bk = block
        tk0 = bk * geo.bz
        x0, y0, z0 = ti * dx, tj * dy, tk0 * dz
        nyl = min(dy, vol[1] - y0)
        for c0, zt, (_, c, t), visits in _chunks(geo, tile, vol, block):
            win = np.zeros((16, T * wq, 4), np.float32)
            for lm, kz in itertools.product(range(16), range(zt + 3)):
                if tk0 + c0 + kz < nz:
                    win[lm, (kz % T) * wq + kz // T, :3] = \
                        phi[ti + lm // 4, tj + lm % 4, tk0 + c0 + kz]
            xl, yl = c // nyl, c % nyl
            s_u = np.zeros((3, len(np.unique(c)) if len(c) else 0, cv), np.float32)
            for j in range(T):
                real = t + j < zt
                for r in range(dz):
                    row = ((xl * dy + yl) * dz + r) * B
                    u = np.zeros((len(c), 3), np.float32)
                    for q in range(16):
                        b = s_basis[row + q]
                        for n in range(4):
                            kz = t + j + n
                            u = u + b[:, n:n + 1] * win[q, (kz % T) * wq + kz // T, :3]
                    s_u[:, c[real], ((t + j) * dz + r)[real]] = u[real].T
            for vxl, vyl, _, p in visits:
                out[x0 + vxl, y0 + vyl, z0 + p] = \
                    s_u[:, vxl * nyl + vyl, p - c0 * dz].T
    return out


def _sample(moving, c):
    """``bsi_fused.warped``'s clamped 8-tap sample in float32 numpy."""
    X, Y, Z = moving.shape
    hi = np.array([X - 1, Y - 1, Z - 1], np.float32)
    c = np.minimum(np.maximum(c, np.float32(0)), hi)
    f = np.floor(c)
    t = c - f
    i0 = f.astype(np.int64)
    i1 = np.minimum(i0 + 1, hi.astype(np.int64))
    (x0, y0, z0), (x1, y1, z1), (tx, ty, tz) = i0.T, i1.T, t.T
    one = np.float32(1)
    c00 = moving[x0, y0, z0] * (one - tx) + moving[x1, y0, z0] * tx
    c01 = moving[x0, y0, z1] * (one - tx) + moving[x1, y0, z1] * tx
    c10 = moving[x0, y1, z0] * (one - tx) + moving[x1, y1, z0] * tx
    c11 = moving[x0, y1, z1] * (one - tx) + moving[x1, y1, z1] * tx
    c0 = c00 * (one - ty) + c10 * ty
    c1 = c01 * (one - ty) + c11 * ty
    return c0 * (one - tz) + c1 * tz


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("vol", [(13, 11, 9), (22, 15, 30), (7, 6, 700)])
def test_matmul_walk_twin_is_plain_bit_for_bit(tile, vol):
    """The twin of the matrix form's walk gives ``bsi_matmul.plain``'s
    displacement and, sampled as the kernel samples, ``bsi_fused.warped``'s
    warp, bit for bit."""
    geo = _matmul_geometry(tile, vol)
    rng = np.random.default_rng(sum(tile) + sum(vol))
    phi = rng.standard_normal(ffd.grid_shape_for_volume(vol, tile) + (3,)).astype(np.float32)
    moving = rng.uniform(0, 1, vol).astype(np.float32)
    u = _matmul_twin(phi, tile, vol, geo)
    ref = bsi_matmul.plain(torch.from_numpy(phi), tile, vol).numpy()
    assert np.array_equal(u, ref)
    ident = np.stack(np.meshgrid(*(np.arange(s, dtype=np.float32) for s in vol),
                                 indexing="ij"), axis=-1)
    w = _sample(moving, (ident + u).reshape(-1, 3)).reshape(vol)
    want = bsi_fused.warped(torch.from_numpy(phi), torch.from_numpy(moving), tile,
                            "matmul").numpy()
    assert np.array_equal(w, want)
