"""The matrix-form forward kernel's work, fragments and stores, in pure arithmetic.

``csrc/bsi_matmul.cu`` runs its units as ``kernels.bsi_matmul.matmul_blocks``
sizes them.  This file writes out, in numpy over a block's warps and lanes,
the kernel's own index arithmetic: each unit's (x tile, y tile, chunk of z
tiles), the window's copy (a thread's row and entries, the grid index each
loads), the B-fragment address of each lane at each k-step and n8 tile,
each accumulator entry's staging position and, per voxel column, the bulk
copy of its run's body and the lanes' stores of its ends.  It checks that
every ``(x, y, z, channel)`` of the field is written exactly once and
nothing outside it, each from the staged value of that very voxel (so no
padding row or column is stored), that each B-fragment entry is the window
entry that ``repro``'s ``contract_window`` puts in its column matrix for
that (k, column), that every shared-memory access lands inside the block's
buffers and the block fits, and that each bulk copy's body is 16-byte
aligned at both ends.  Then, in torch on the CPU, that
``bsi_matmul.basis_fragments`` unpacked by the ``m16n8k8`` A layout gives
back the hi and lo TF32 parts of the float32 basis, and that a twin of the
kernel's arithmetic (the split in integers, the three products per k-step
in the kernel's order, summed in float32) agrees with ``bsi_matmul.plain``
and the float64 function.  The tensor cores' own accumulation cannot be
reproduced here: the twin checks operands and order, not bits.  The card
runs the kernel itself (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bsi_matmul import contract_window
from repro_torch.core import ffd
from repro_torch.kernels import bsi_matmul
from repro_torch.kernels.bsi_ttli import KERNEL_THREADS, MAX_SMEM_BYTES
from repro_torch.launch.bounds import matmul_tf32_ms

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
CSRC = Path(bsi_matmul.__file__).parent.parent / "csrc"


def _const(name, file):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         (CSRC / file).read_text()).group(1))


GROUPS = KERNEL_THREADS // 128  # warpgroups a block
HALF = _const("kHalf", "bsi_matmul.cu")  # columns of a task
PHANTOM1 = (512, 228, 385)
COARSE = (256, 114, 192)  # the pyramid's coarse level of phantom1
TILES = [(5, 5, 5), (5, 4, 3), (3, 3, 3), (7, 6, 5), (1, 1, 1)]
# odd volumes: z off the tile, one-tile volumes, long z rows of many chunks
SMALL = [(13, 11, 9), (12, 11, 9), (22, 15, 30), (11, 12, 45), (5, 4, 3), (1, 1, 1),
         (7, 6, 700), (6, 7, 1500)]


def _geometry(tile, c, vol):
    """The blocks, checked against the kernel's own sums (``mm_nchunks``,
    ``mm_mgroups``, ``mm_raw_row``, ``mm_run``, ``mm_smem_bytes``) and the
    budget."""
    geo = bsi_matmul.matmul_blocks(tile, c, vol)
    dx, dy, dz = tile
    tx, ty, tz = (-(-s // d) for s, d in zip(vol, tile))
    zt = geo.z_tiles
    assert 1 <= zt <= min(tz, max(1, bsi_matmul.MAX_COLUMNS // c))
    assert geo.chunks == -(-tz // zt) and geo.units == tx * ty * geo.chunks
    assert geo.m_groups == -(-dx * dy * dz // 64)
    assert geo.halves == -(-zt * c // HALF)
    assert geo.raw_row == -(-((zt + 3) * c + 3) // 4) * 4 and geo.raw_row % 4 == 0
    assert geo.run == -(-zt * dz * c // 4) * 4 + 4 and geo.run % 4 == 0
    wt = 8 * geo.halves * HALF * 32  # W^T, hi or lo
    stage, raw = 2 * dx * dy * geo.run * 4, 16 * geo.raw_row * 4
    assert geo.smem == 1024 + 2 * wt + stage + raw <= MAX_SMEM_BYTES
    assert geo.smem <= bsi_matmul.MATMUL_SMEM_BYTES or zt == 1
    assert geo.grid == min(geo.units, bsi_matmul.BLOCKS_PER_SM * 132)
    return geo


def _decode(geo, tile, vol, u):
    """Unit ``u``: (ti, tj, tk0, ztu), chunk fastest."""
    ty, tz = (-(-s // d) for s, d in zip(vol[1:], tile[1:]))
    h, r = u % geo.chunks, u // geo.chunks
    tk0 = h * geo.z_tiles
    return r // ty, r % ty, tk0, min(geo.z_tiles, tz - tk0)


def _window(geo, c, grid_shape, ti, tj, tk0, ztu, itemsize=4):
    """The window's copy: thread ``tid`` copies 16-byte chunks ``tid % 16 +
    16 i`` of row ``tid // 16``, from the row's start rounded down to 16
    bytes, only the unit's values read (the rest of a chunk zeros).  Each
    of the unit's values lands once, at its row's shift plus its place in
    the row, from the grid's flat index of its control point.  Returns the
    raw rows holding the unit's own index of each value, ``((l * 4 + m) *
    (ztu + 3) + z) * c + ch``, -1 for a zero, and each row's shift.
    ``itemsize``: the grid's bytes a value (bf16: 2, ``E = 8`` values a
    chunk, in the float32 kernel's rows)."""
    E = 16 // itemsize
    nx, ny, nz = grid_shape
    nval = (ztu + 3) * c
    row = geo.raw_row * 4 // itemsize  # values of a raw row
    raw = np.full((16, row), -2, np.int64)
    shifts = []
    for wr in range(16):
        l, m = wr // 4, wr % 4
        start = (((ti + l) * ny + tj + m) * nz + tk0) * c  # the row's first value
        shift = start % E  # the grid's base is 16-byte aligned
        shifts.append(shift)
        q = np.arange(16)
        q = np.concatenate([q + 16 * i for i in range(-(-row // (16 * E)))])
        q = q[E * q < shift + nval]
        assert (E * q + E <= row).all()  # inside the raw row
        for qq in q:
            valid = min(shift + nval - E * qq, E)
            assert 1 <= valid <= E
            flat = start - shift + E * qq + np.arange(E)
            i = flat - start  # the value's place in the row
            assert (raw[wr, E * qq:E * qq + E] == -2).all()  # each chunk once
            ok = (np.arange(E) < valid) & (i >= 0)
            zi, ch = tk0 + i // c, i % c
            assert (flat[ok] == (((ti + l) * ny + tj + m) * nz + zi[ok]) * c + ch[ok]).all()
            assert (flat[np.arange(E) < valid] < nx * ny * nz * c).all()
            raw[wr, E * qq:E * qq + E] = np.where(ok, ((l * 4 + m) * (ztu + 3)) * c + i, -1)
        # every value of the row is there, at its shift
        assert np.array_equal(raw[wr, shift:shift + nval],
                              (l * 4 + m) * (ztu + 3) * c + np.arange(nval))
    return raw, shifts


def _wt(geo, c, raw, shifts, ztu):
    """W^T's build: job (row wr, column n) reads the values at n + i c, i <
    4, of raw row wr (past its shift) and writes them, as one 16-byte
    chunk, to row n of k-step 2 l + m / 2, chunk m % 2 swizzled by row bit
    2.  Every chunk of W^T once; returns it as the unit's indices, one per
    4 bytes (-1: a zero)."""
    nrows = geo.halves * HALF
    ncols = ztu * c
    wt = np.full(8 * nrows * 8, -2, np.int64)  # 8 k-steps x nrows x 32 bytes
    for job in range(16 * nrows):
        wr, n = divmod(job, nrows)
        if n < ncols:
            pos = shifts[wr] + n + c * np.arange(4)
            assert (pos < raw.shape[1]).all()
            vals = raw[wr, pos]
            assert (vals >= 0).all()  # the unit's values, never a zero
        else:
            vals = np.full(4, -1)
        s, q = (wr // 4) * 2 + (wr // 2) % 2, (wr % 2) ^ ((n >> 2) & 1)
        off = s * nrows * 32 + n * 32 + q * 16
        assert off % 16 == 0 and off + 16 <= 8 * nrows * 32
        assert (wt[off // 4:off // 4 + 4] == -2).all()
        wt[off // 4:off // 4 + 4] = vals
    assert (wt != -2).all()
    return wt


def _operands_read_the_column_matrix(geo, c, wt, ztu):
    """What each wgmma reads as B (8 x 24 at k-step s, half nh): element (k,
    n) of the 32-byte-swizzled K-major tile at the descriptor's start
    ``(s * halves + nh) * 24 * 32``, row n at 32 n, its 16-byte chunk k / 4
    XOR bit 2 of n.  For the unit's columns it is the entry ``repro``'s
    ``contract_window`` puts in its column matrix at (8 s + k, 24 nh + n);
    past them, a zero."""
    # the unit's window holding each value's own index (exact in float32);
    # with the identity as the basis (a 4^3 tile: 64 voxel offsets) the
    # product is the column matrix itself: cols[k, col] at voxel offset k
    w4 = jnp.arange(16 * (ztu + 3) * c, dtype=jnp.float32).reshape(4, 4, ztu + 3, c)
    out = np.asarray(contract_window(w4, jnp.eye(64, dtype=jnp.float32), (4, 4, 4),
                                     (1, 1, ztu)))
    k = np.arange(64)[:, None]
    col = np.arange(ztu * c)[None, :]
    cols = out[k >> 4, (k >> 2) & 3, (col // c) * 4 + (k & 3), col % c].astype(np.int64)
    ncols = ztu * c
    kk, n = np.meshgrid(np.arange(8), np.arange(HALF), indexing="ij")
    for s in range(8):
        for nh in range(geo.halves):
            start = (s * geo.halves + nh) * HALF * 32
            assert start % 256 == 0  # the swizzle's phase: bit 2 of the row
            byte = start + n * 32 + (((kk >> 2) ^ ((n >> 2) & 1)) << 4) + (kk & 3) * 4
            got = wt[byte // 4]
            cc = nh * HALF + n
            ok = cc < ncols
            assert np.array_equal(got[ok], cols[8 * s + kk[ok], cc[ok]])
            assert (got[~ok] == -1).all()


def _unit(geo, tile, c, vol, u, obase=0, itemsize=4):
    """Unit ``u`` over the block's warps and lanes: each accumulator entry's
    staging position, then each voxel column's stores.  Returns the flat
    field indices written.  ``obase``: the field's base in values past a
    16-byte boundary; ``itemsize``: its bytes a value (bf16: 2, ``E = 8``
    values to 16 bytes, a run's slot ``2 * run`` values)."""
    E = 16 // itemsize
    dx, dy, dz = tile
    X, Y, Z = vol
    ty, tz = -(-Y // dy), -(-Z // dz)
    YY, ZZ = ty * dy, tz * dz  # the whole tiles' field: an id per value
    ti, tj, tk0, ztu = _decode(geo, tile, vol, u)
    ncols, nv, ncol, run = ztu * c, dx * dy * dz, dx * dy, geo.run * 4 // itemsize
    stage = np.full(ncol * run, -1, np.int64)
    lane = np.arange(32)
    gq, tq = lane // 4, lane % 4
    e2 = np.arange(2)
    tasks = geo.m_groups * geo.halves
    for w in range(KERNEL_THREADS // 32):
        wg, wq = divmod(w, 4)
        for q in range(wg, tasks, GROUPS):
            mi, nh = q % geo.m_groups, q // geo.m_groups
            if nh * HALF >= ncols:
                continue
            v = 64 * mi + 16 * wq + gq[:, None] + 8 * e2[None, :]  # (lane, e)
            rok = v < nv
            ra = v // (dy * dz)
            rb = (v - ra * dy * dz) // dz
            rz = v - ra * dy * dz - rb * dz
            x, y = ti * dx + ra, tj * dy + rb
            delta = (obase + ((x * Y + y) * Z + tk0 * dz) * c) % E
            sb = (ra * dy + rb) * run + delta + rz * c
            for i in range(HALF // 8):  # the task's n8 slices
                col = nh * HALF + 8 * i + 2 * tq[:, None] + e2[None, :]  # (lane, j)
                tk = col // c
                pc = tk * dz * c + col - tk * c
                ok = (col < ncols)[:, :, None] & rok[:, None, :]  # (lane, j, e)
                pos = (sb[:, None, :] + pc[:, :, None])[ok]
                assert (pos >= 0).all() and (pos < ncol * run).all()
                assert (stage[pos] == -1).all() and len(set(pos)) == len(pos)
                zz = (tk0 + tk)[:, :, None] * dz + rz[:, None, :]
                ids = ((x[:, None, :] * YY + y[:, None, :]) * ZZ + zz) * c + (
                    col - tk * c)[:, :, None]
                stage[pos] = ids[ok]
    assert (stage >= 0).sum() == nv * ncols  # every entry of the product staged once

    written = []
    z0 = tk0 * dz
    n = (min(z0 + ztu * dz, Z) - z0) * c

    def stored(addr, pos, ab):
        """Stores of staged positions ``pos`` at ``addr``: inside the run's
        slot, each the value of the voxel and channel stored to."""
        assert ((pos >= ab * run) & (pos < (ab + 1) * run)).all()
        ch, rest = addr % c, addr // c
        z, rest = rest % Z, rest // Z
        yy, xx = rest % Y, rest // Y
        assert np.array_equal(stage[pos], ((xx * YY + yy) * ZZ + z) * c + ch)
        written.append(addr)

    for ab in range(ncol):
        a, b = divmod(ab, dy)
        x, y = ti * dx + a, tj * dy + b
        if x >= X or y >= Y:
            continue
        o = ((x * Y + y) * Z + z0) * c
        v0 = ab * run + (obase + o) % E
        head = (E - (obase + o) % E) % E
        body = max(n - head, 0) // E * E
        if body > 0:
            # the bulk copy: 16-byte aligned at both ends (the staging's base
            # is), whole 16 bytes; the head and the tail by lanes
            assert (obase + o + head) % E == 0 and (v0 + head) % E == 0
            stored(o + head + np.arange(body), v0 + head + np.arange(body), ab)
            tail = n - head - body
            assert head < E and tail < E
            stored(o + lane[:head], v0 + lane[:head], ab)
            stored(o + head + body + lane[:tail], v0 + head + body + lane[:tail], ab)
        else:
            assert n < 32
            stored(o + lane[:n], v0 + lane[:n], ab)
    return np.concatenate(written) if written else np.zeros(0, np.int64)


def _written_once(geo, tile, c, vol, units, obase=0, xs=None, itemsize=4):
    """The values of ``units``, all in the x planes ``xs`` (default: the
    volume's): each exactly once, nothing outside the field.  Returns the
    count of each value of those planes."""
    X, Y, Z = vol
    x0, x1 = xs or (0, X)
    plane = Y * Z * c
    addr = np.concatenate([_unit(geo, tile, c, vol, u, obase, itemsize) for u in units])
    addr = addr - x0 * plane
    assert (addr >= 0).all() and (addr < (x1 - x0) * plane).all()
    counts = np.bincount(addr, minlength=(x1 - x0) * plane)
    assert counts.max() == 1
    return counts


def _check_windows(geo, tile, c, vol, units, itemsize=4):
    grid_shape = ffd.grid_shape_for_volume(vol, tile)
    for u in units:
        ti, tj, tk0, ztu = _decode(geo, tile, vol, u)
        raw, shifts = _window(geo, c, grid_shape, ti, tj, tk0, ztu, itemsize)
        _operands_read_the_column_matrix(geo, c, _wt(geo, c, raw, shifts, ztu), ztu)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("vol", SMALL)
def test_every_value_written_once_small(tile, c, vol):
    """Every unit of a small volume, the whole field counted; the windows
    and fragments of its first and last units."""
    geo = _geometry(tile, c, vol)
    counts = _written_once(geo, tile, c, vol, range(geo.units))
    assert (counts == 1).all()
    _check_windows(geo, tile, c, vol, sorted({0, geo.units - 1}))


def _tile_rows_once(geo, tile, c, vol, ti, tjs):
    """The units of x tile ``ti`` and y tiles ``tjs``, all their chunks of z
    tiles: each value of those (x, y) rows written exactly once."""
    dx, dy, _ = tile
    X, Y, Z = vol
    ty = -(-Y // dy)
    units = [(ti * ty + tj) * geo.chunks + h for tj in tjs for h in range(geo.chunks)]
    addr = np.concatenate([_unit(geo, tile, c, vol, u) for u in units])
    rest, zc = addr // (Z * c), addr % (Z * c)
    x, y = rest // Y, rest % Y
    assert ((x >= ti * dx) & (x < min(X, (ti + 1) * dx))).all()
    ys = np.concatenate([np.arange(tj * dy, min(Y, (tj + 1) * dy)) for tj in tjs])
    assert np.isin(y, ys).all()
    local = ((x - ti * dx) * len(ys) + np.searchsorted(np.sort(ys), y)) * Z * c + zc
    counts = np.bincount(local, minlength=(min(X, (ti + 1) * dx) - ti * dx) * len(ys) * Z * c)
    assert counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("vol", [PHANTOM1, COARSE])
def test_every_value_written_once_phantom1(tile, c, vol):
    """phantom1 and its coarse level: a unit's mapping depends on its x and
    y tiles only through their offsets and the volume's edges, so the first
    and last x tiles, each with its first two and last two y tiles (all
    their chunks of z tiles), stand for the rest; each of their values is
    written exactly once."""
    geo = _geometry(tile, c, vol)
    tx, ty = (-(-v // d) for v, d in zip(vol[:2], tile[:2]))
    tjs = sorted({0, 1, ty - 2, ty - 1})
    for ti in sorted({0, tx - 1}):
        _tile_rows_once(geo, tile, c, vol, ti, tjs)
    _check_windows(geo, tile, c, vol, sorted({0, geo.chunks - 1, geo.units - 1}))


@pytest.mark.parametrize("obase", [1, 2, 3])
def test_unaligned_field_base(obase):
    """A field whose base is not 16-byte aligned (the kernel takes its
    alignment from the pointer): the runs still leave by aligned bulk
    copies, each value once."""
    tile, c, vol = (5, 4, 3), 3, (22, 15, 30)
    geo = _geometry(tile, c, vol)
    assert (_written_once(geo, tile, c, vol, range(geo.units), obase) == 1).all()


@pytest.mark.parametrize("tile,c,vol", [((5, 4, 3), 40, (13, 11, 9)),
                                        ((10, 10, 10), 3, (23, 20, 31)),
                                        ((5, 5, 5), 5, (40, 33, 47)),
                                        ((1, 1, 1), 7, (11, 12, 45))])
def test_other_geometries(tile, c, vol):
    """Many channels (one z tile a unit), a tile of 63 m tiles (the warps
    loop over them), 5 channels (9 z tiles a unit) and a 1^3 tile at 7
    channels (8 warps share its one m tile): each value once."""
    geo = _geometry(tile, c, vol)
    assert (_written_once(geo, tile, c, vol, range(geo.units)) == 1).all()
    _check_windows(geo, tile, c, vol, sorted({0, geo.units - 1}))


def test_phantom1_blocks():
    """At phantom1, tile 5^3, 3 channels: 16 z tiles a unit (48 columns, two
    halves), 5 chunks a row (the last of 13 tiles), 23,690 units over 264
    persistent blocks, 2 tiles of 64 voxel offsets, 78,240 B of shared
    memory; the coarse level has 3 chunks a row, 3,588 units.  Their
    products: 29 n8 slices a (x tile, y tile), 26.38 M m16n8k8-sized
    products, 0.109 ms at 495 TFLOP/s."""
    geo = bsi_matmul.matmul_blocks((5, 5, 5), 3, PHANTOM1)
    assert (geo.z_tiles, geo.chunks, geo.units, geo.m_groups, geo.halves) == (
        16, 5, 23_690, 2, 2)
    assert (geo.raw_row, geo.run, geo.grid, geo.smem) == (60, 244, 264, 78_240)
    coarse = bsi_matmul.matmul_blocks((5, 5, 5), 3, COARSE)
    assert (coarse.chunks, coarse.units, coarse.grid) == (3, 3_588, 264)
    mma, gflop, ms = matmul_tf32_ms(PHANTOM1, (5, 5, 5), 3)
    assert mma == 103 * 46 * 29 * 8 * 8 * 3
    assert abs(ms - 0.109) < 0.001 and abs(gflop - 54.03) < 0.01
    assert bsi_matmul.occupancy_key((5, 5, 5), 3, PHANTOM1) == (
        "bsi_matmul_kernelILi3E", 78_240, 264)


def test_the_constants_are_the_csrc_ones():
    assert HALF == bsi_matmul.HALF
    assert _const("kThreads", "bsi_common.cuh") == KERNEL_THREADS == 128 * GROUPS
    assert "__launch_bounds__(kThreads, 2)" in (CSRC / "bsi_matmul.cu").read_text()
    assert bsi_matmul.BLOCKS_PER_SM == 2


def test_blocks_refuse_what_does_not_fit():
    """A tile whose one z tile of runs exceeds a block's shared memory is
    refused before any launch; where the staging would pass the two-block
    budget, fewer z tiles a unit."""
    with pytest.raises(ValueError, match="shared memory"):
        bsi_matmul.matmul_blocks((10, 10, 10), 40, (40, 40, 40))
    assert bsi_matmul.matmul_blocks((10, 10, 10), 3, PHANTOM1).z_tiles < 16


# --- the fragments and the arithmetic, in torch


def _tf32_bits(x):
    """The kernels' ``tf32_rna`` in numpy's unsigned integers."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("tile", TILES + [(10, 10, 10)])
def test_basis_fragments_unpack_to_the_split_basis(tile):
    """``basis_fragments`` unpacked by the m16n8k8 A layout, which is each
    warp's 16 rows of the wgmma's (entry r of lane (g, t): row 16 mi + g +
    8 (r % 2), column 8 s + t + 4 (r // 2)), gives back hi and lo of the
    float32 basis, each a TF32 value, hi + lo within 2^-22 of it, and zeros
    in the padding rows up to a whole 64-row tile."""
    frag = bsi_matmul.basis_fragments(tile, "cpu").numpy()
    b = bsi_matmul.basis(tile, "cpu").numpy()
    nv = b.shape[0]
    mt = -(-nv // 64) * 4  # whole 64-row tiles of m16 tiles
    assert frag.shape == (mt, 8, 2, 32, 4)
    parts = np.full((2, mt * 16, 64), np.nan, np.float32)
    mi, s, h, lane, r = np.indices(frag.shape)
    rows = 16 * mi + lane // 4 + 8 * (r % 2)
    cols = 8 * s + lane % 4 + 4 * (r // 2)
    assert np.isnan(parts[h, rows, cols]).all()  # each entry of A once
    parts[h, rows, cols] = frag
    assert not np.isnan(parts).any()
    hi, lo = parts[0], parts[1]
    assert not hi[nv:].any() and not lo[nv:].any()
    assert np.array_equal(hi[:nv], _tf32_bits(b))
    assert np.array_equal(lo[:nv], _tf32_bits(b - hi[:nv]))
    for p in (hi, lo):
        assert not (p.view(np.uint32) & np.uint32(0x1FFF)).any()  # TF32: 10 bits
    assert (np.abs(hi[:nv].astype(np.float64) + lo[:nv] - b) <= 2.0 ** -22 * b).all()


def _twin(phi, tile, vol):
    """The kernel's arithmetic in torch: A from ``basis_fragments``, the
    window split as the kernel splits it, and per k-step ``lo_A hi_w`` then
    ``hi_A lo_w`` into one float32 accumulator and ``hi_A hi_w`` into
    another, added at the end; cropped to ``vol``."""
    dx, dy, dz = tile
    tx, ty, tz = (int(n) - 3 for n in phi.shape[:3])
    c = phi.shape[3]
    nv = dx * dy * dz
    frag = bsi_matmul.basis_fragments(tile, "cpu")
    mt = frag.shape[0]
    mi, s, h, lane, r = (torch.from_numpy(a) for a in np.indices(tuple(frag.shape)))
    parts = torch.zeros((2, mt * 16, 64))
    parts[h, 16 * mi + lane // 4 + 8 * (r % 2), 8 * s + lane % 4 + 4 * (r // 2)] = frag
    ah, al = parts[0, :nv], parts[1, :nv]
    win = torch.stack([phi[l:l + tx, m:m + ty, n:n + tz] for l in range(4)
                       for m in range(4) for n in range(4)]).reshape(64, -1)
    bits = win.contiguous().view(torch.int32)
    wh = ((bits + 0x1000) & -0x2000).view(torch.float32)
    wl = (((win - wh).contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)
    big = torch.zeros((nv, win.shape[1]))
    small = torch.zeros((nv, win.shape[1]))
    for k in range(8):
        ks = slice(8 * k, 8 * k + 8)
        small = small + al[:, ks] @ wh[ks]
        small = small + ah[:, ks] @ wl[ks]
        big = big + ah[:, ks] @ wh[ks]
    out = (big + small).reshape(dx, dy, dz, tx, ty, tz, c)
    out = out.permute(3, 0, 4, 1, 5, 2, 6).reshape(tx * dx, ty * dy, tz * dz, c)
    return out[:vol[0], :vol[1], :vol[2]]


TWIN_CASES = ([(vol, tile, c) for vol in SMALL[:6] for tile in TILES for c in (1, 3)]
              + [(vol, (5, 5, 5), 3) for vol in ((7, 6, 700), (6, 7, 1500))])


def _held(phi, tile, vol):
    twin = _twin(phi, tile, vol)
    ref = bsi_matmul.plain(phi, tile, vol)
    exact = bsi_matmul.exact(phi, tile, vol)
    assert twin.shape == ref.shape == tuple(vol) + (phi.shape[3],)
    assert (twin - ref).abs().max().item() <= 1e-5
    # 3xTF32: each term within 2^-22 of |B w| (lo lo dropped, lo rounded),
    # and 17 float32 roundings of the sums at most; B sums to 1
    bound = 2.0 ** -20 * phi.abs().max().item()
    assert (twin.double() - exact).abs().max().item() <= bound


@pytest.mark.parametrize("vol,tile,c", TWIN_CASES)
def test_twin_of_the_arithmetic_small(vol, tile, c):
    rng = np.random.default_rng(41)
    gshape = ffd.grid_shape_for_volume(vol, tile)
    phi = torch.from_numpy(rng.standard_normal(gshape + (c,)).astype(np.float32) * 2.5)
    _held(phi, tile, vol)


@pytest.mark.parametrize("vol", [PHANTOM1, COARSE])
@pytest.mark.parametrize("c", [1, 3])
def test_twin_of_the_arithmetic_phantom1(vol, c):
    """A slab of phantom1's (and the coarse level's) grid, 2 x 3 x all z
    tiles: each output depends on its own window only, so the slab stands
    for the volume; its last z tile is cropped as the volume's is."""
    tile = (5, 5, 5)
    gshape = ffd.grid_shape_for_volume(vol, tile)
    rng = np.random.default_rng(43)
    phi = torch.from_numpy(
        rng.standard_normal((5, 6, gshape[2], c)).astype(np.float32) * 2.5)
    _held(phi, tile, (10, 15, vol[2]))
