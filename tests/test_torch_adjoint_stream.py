"""The separable adjoint kernel's streaming geometry (``kernels.bsi_adjoint.stream_blocks``).

Pure arithmetic on the shapes, so it runs on the CPU: the kernel itself runs
only on the card (``tests/test_torch_cuda.py``).  A block of
``adjoint_stream_kernel`` (``csrc/bsi_adjoint.cu``) streams the rows of one
x plane, a run of y tiles, through a ring of shared-memory slots, each row
copied as the 16-byte chunks that cover its segment from its start rounded
down; each lane loads one z tile of one channel of every row, and a control
point takes its four bands from its own lane and the three to its left.
The lane decode, the loads' places in a staged row, the copies' chunks and
the runs' seams are the kernel's arithmetic written out here: every load
must land inside the row's segment or be masked, every (voxel, channel,
band) must reach its control point exactly once, and the block must fit
its shared memory.
"""

import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import bsi_adjoint, bsi_ttli  # noqa: E402

TILES = [(1, 1, 1), (3, 3, 3), (5, 4, 3), (5, 5, 5), (7, 7, 7)]
PHANTOM1 = (512, 228, 385)
COARSE = (256, 114, 192)  # the pyramid's coarse level of phantom1 (ffd.downsample2)


def _volumes(tile):
    """Volumes off the tile grid; the second's z outputs outnumber a
    block's threads at 3 and 4 channels."""
    dx, dy, dz = tile
    return [(2 * dx + 1, 3 * dy + 2, 7 * dz + 3), (dx, dy + 1, 90 * dz - 1)]


def _nzh(tile, vol):
    return -(-vol[2] // tile[2]) + 3


def _lanes(geo, tile, c, vol, zp, cp):
    """Block part (zp, cp): its first z control point, its count, and each
    thread's (channel, z tile kz, voxels it loads, owner): the lanes run
    over the part's channels, each as ``span + 3`` tiles from ``kz0 - 3``,
    warp w taking entries 29w .. 29w + 31; lanes 3..31 past a channel's
    three halo tiles own control point kz (csrc: the decode of
    ``adjoint_stream_kernel``)."""
    dz, Z = tile[2], vol[2]
    kz0 = zp * geo.span
    nk = min(geo.span, _nzh(tile, vol) - kz0)
    ch0 = cp * geo.channels
    ncb = min(geo.channels, c - ch0)
    zs1 = min(Z, (kz0 + nk) * dz)
    per = nk + 3
    lanes = []
    for tid in range(geo.threads):
        lane = tid % 32
        u = tid // 32 * bsi_adjoint.STREAM_OUTPUTS + lane
        ch, e = ch0 + u // per, u % per
        kz = kz0 - 3 + e
        na = max(0, min(dz, zs1 - kz * dz)) if u < ncb * per and kz >= 0 else 0
        lanes.append((ch, kz, na, lane >= 3 and e >= 3 and u < ncb * per))
    return kz0, nk, lanes


def _parts(geo, tile, c, vol):
    nzp = -(-_nzh(tile, vol) // geo.span)
    assert geo.zparts == nzp * -(-c // geo.channels)
    for z in range(geo.zparts):
        yield z % nzp, z // nzp


def _segment(tile, vol, c, kz0, nk):
    """The z voxels [zs0, zs1) a part's control points reach, and the
    floats of a row it stages (csrc: zs0, zs1, seg)."""
    dz, Z = tile[2], vol[2]
    zs0, zs1 = max(0, (kz0 - 3) * dz), min(Z, (kz0 + nk) * dz)
    return zs0, (zs1 - zs0) * c


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("tile", TILES)
def test_every_z_tap_lands_in_the_row_or_is_masked(tile, c):
    """A lane loads voxel z = kz*dz + a of its tile, channel ch, from
    place + a*c of the staged segment for a < na, the voxels inside the
    volume and the part, and zeros for the rest; control point kz takes
    band n from the lane n to its left, whose tile is kz - n, so over all
    parts every (voxel, channel, band) reaches its control point once."""
    dz = tile[2]
    for vol in _volumes(tile):
        geo = bsi_adjoint.stream_blocks(tile, c, vol)
        Z = vol[2]
        reached = np.zeros((Z, c, 4), np.int64)
        for zp, cp in _parts(geo, tile, c, vol):
            kz0, nk, lanes = _lanes(geo, tile, c, vol, zp, cp)
            zs0, seg = _segment(tile, vol, c, kz0, nk)
            assert 0 < seg <= geo.segment and geo.segment + 3 <= geo.slot
            for ch, kz, na, _ in lanes:
                place = (kz * dz - zs0) * c + ch
                for a in range(na):
                    z = kz * dz + a
                    assert 0 <= z < Z and 0 <= place + a * c < seg
                    assert place + a * c == (z - zs0) * c + ch
            for tid, (ch, kz, _, owner) in enumerate(lanes):
                if not owner:
                    continue
                for n in range(4):
                    sch, skz, sna, _ = lanes[tid - n]
                    assert (tid - n) // 32 == tid // 32 and (sch, skz) == (ch, kz - n)
                    expect = [z for z in range(skz * dz, skz * dz + dz) if 0 <= z < Z]
                    assert list(range(skz * dz, skz * dz + sna)) == expect
                    reached[expect, ch, n] += 1
        assert (reached == 1).all(), (vol, tile, c)


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("tile", TILES)
def test_every_z_control_point_has_one_owner(tile, c):
    for vol in _volumes(tile) + [PHANTOM1]:
        geo = bsi_adjoint.stream_blocks(tile, c, vol)
        owned = []
        for zp, cp in _parts(geo, tile, c, vol):
            kz0, nk, lanes = _lanes(geo, tile, c, vol, zp, cp)
            assert geo.threads <= 32 * bsi_adjoint.STREAM_MAX_WARPS
            owned += [(kz, ch) for ch, kz, _, owner in lanes if owner]
            assert all(kz0 <= kz < kz0 + nk for _, kz, _, owner in lanes if owner)
        assert sorted(owned) == [(kz, ch) for kz in range(_nzh(tile, vol))
                                 for ch in range(c)]


def _bulk_copy(start, floats, end, per_chunk=4):
    """A row copy of ``floats`` values from value ``start`` of a tensor that
    ends at value ``end`` (addresses in values from a 16-byte boundary,
    ``per_chunk`` values a 16-byte chunk: 4 floats, 8 bf16; csrc:
    ``stage_bulk``): the whole 16-byte chunks from ``start`` rounded down,
    cut at the tensor's last whole chunk, then plain loads of the values
    past the cut.  Returns the chunks' first value, the values they copy
    and the values loaded one by one."""
    e = per_chunk
    lo = start - start % e
    hi = lo + e * ((start - lo + floats + e - 1) // e)
    cut = min(hi, end - end % e)
    tail = list(range(max(cut, start), min(start + floats, end)))
    return lo, max(0, cut - lo), tail


ALL_SHIFTS = {0, 1, 2, 3}


@pytest.mark.parametrize("vol,shifts", [((2, 7, 385), ALL_SHIFTS), ((2, 7, 384), {0}),
                                        ((2, 7, 13), ALL_SHIFTS), ((2, 7, 20), {0}),
                                        ((3, 5, 1200), {0, 2})])
@pytest.mark.parametrize("offset", [0, 1])
def test_row_copies_cover_the_segment_within_the_slot(vol, shifts, offset):
    """Rows of Z*3 floats (1155: phantom1's 4620 bytes; 1152 and 60 whole
    16-byte chunks; 39; and a long z in parts whose segments start on
    every other 8-byte boundary) of a tensor that starts ``offset`` floats
    past a 16-byte boundary: each block's copy of its segment of each row,
    by the geometry of ``stream_blocks``, lands in its slot from the
    segment's shift on, whole chunks a multiple of 16 bytes, the floats
    past the tensor's last whole chunk (its last row only) by plain loads;
    the shifts are those of the segments' starts, ``shifts`` moved by the
    offset."""
    tile, c = (5, 5, 5) if vol[2] < 1000 else (5, 5, 2), 3
    geo = bsi_adjoint.stream_blocks(tile, c, vol)
    assert geo.slot >= geo.segment + 3
    X, Y, Z = vol
    end = offset + X * Y * Z * c
    shifts_seen = set()
    for zp, cp in _parts(geo, tile, c, vol):
        kz0, nk, _ = _lanes(geo, tile, c, vol, zp, cp)
        zs0, seg = _segment(tile, vol, c, kz0, nk)
        for row in range(X * Y):
            start = offset + row * Z * c + zs0 * c
            lo, copied, tail = _bulk_copy(start, seg, end)
            shift = start - lo
            shifts_seen.add(shift)
            assert lo % 4 == 0 and copied % 4 == 0 and copied <= geo.slot
            assert shift + seg <= geo.slot  # the lanes' loads: slot[shift + place]
            covered = set(range(lo, lo + copied)) | set(tail)
            assert set(range(start, start + seg)) <= covered
            assert all(p - lo < geo.slot for p in tail)
            assert not tail or row == X * Y - 1
    assert shifts_seen == {(t + offset) % 4 for t in shifts}


@pytest.mark.parametrize("vol", [(2, 7, 385), (2, 7, 13), (3, 5, 1200), (2, 3, 7)])
@pytest.mark.parametrize("offset", [0, 1, 2, 7])
def test_bf16_row_copies_fit_the_float32_slots(vol, offset):
    """A bf16 cotangent's rows (``adjoint_stream_kernel<C, D, __nv_bfloat16>``):
    each block's copy of its segment of each row, as 16-byte chunks of 8
    values from the segment's start rounded down (a shift of 0..7 values,
    any parity: rows of Z*3 values start on odd values too), lands in the
    float32 geometry's slot, ``4 * slot`` bytes; the lanes' loads at
    ``shift + place + a*c`` stay inside the copied segment; the values past
    the tensor's last whole chunk (its last row only) by plain loads."""
    tile, c = (5, 5, 5) if vol[2] < 1000 else (5, 5, 2), 3
    geo = bsi_adjoint.stream_blocks(tile, c, vol)
    X, Y, Z = vol
    end = offset + X * Y * Z * c
    shifts = set()
    for zp, cp in _parts(geo, tile, c, vol):
        kz0, nk, lanes = _lanes(geo, tile, c, vol, zp, cp)
        zs0, seg = _segment(tile, vol, c, kz0, nk)
        for row in range(X * Y):
            start = offset + row * Z * c + zs0 * c
            lo, copied, tail = _bulk_copy(start, seg, end, per_chunk=8)
            shift = start - lo
            shifts.add(shift)
            assert lo % 8 == 0 and copied % 8 == 0 and 2 * copied <= 4 * geo.slot
            assert 2 * (shift + seg) <= 4 * geo.slot
            covered = set(range(lo, lo + copied)) | set(tail)
            assert set(range(start, start + seg)) <= covered
            assert all(2 * (p - lo) < 4 * geo.slot for p in tail)
            assert not tail or row == X * Y - 1
            for ch, kz, na, _ in lanes:
                place = (kz * tile[2] - zs0) * c + ch
                assert all(0 <= place + a * c < seg for a in range(na))
    assert len(shifts) > 1 and any(s % 2 for s in shifts) == bool(Z * c % 2 or offset % 2)


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("tile", TILES)
def test_shared_memory_is_the_csrc_sum_and_fits(tile, c):
    """An 8-byte mbarrier a slot, rounded up to 16 bytes, ring slots of ``4 *
    ((segment + 6) // 4)`` floats, ``segment = min(Z, (span + 3) * dz) * c``,
    and the y and z LUTs (csrc: ``stream_smem``); every slot starts on a
    16-byte boundary, as the bulk copies need."""
    for vol in _volumes(tile) + [PHANTOM1, COARSE]:
        geo = bsi_adjoint.stream_blocks(tile, c, vol)
        segment = min(vol[2], (geo.span + 3) * tile[2]) * c
        slot = 4 * ((segment + 6) // 4)
        assert (geo.segment, geo.slot) == (segment, slot)
        bars = 16 * -(-bsi_adjoint.STREAM_STAGES // 2)
        assert geo.smem == bars + 4 * (bsi_adjoint.STREAM_STAGES * slot + 4 * tile[1]
                                       + 4 * tile[2])
        assert bars % 16 == 0 and bars >= 8 * bsi_adjoint.STREAM_STAGES and slot % 4 == 0
        assert geo.smem <= bsi_ttli.MAX_SMEM_BYTES


def test_the_stream_constants_are_the_csrc_ones():
    """The ring's slots, a warp's owners and a block's threads, as the
    geometry counts them, are the kernel's own."""
    src = (Path(bsi_adjoint.__file__).parent.parent / "csrc" / "bsi_adjoint.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kStreamStages")) == bsi_adjoint.STREAM_STAGES
    assert int(const("kStreamOutputs")) == bsi_adjoint.STREAM_OUTPUTS
    assert const("kStreamThreads") == f"{bsi_adjoint.STREAM_MAX_WARPS} * 32"


def _check_runs(tiles, run, runs, n):
    """One axis of ``tiles`` y tiles in ``runs`` runs of ``run`` with ``n``
    control points: run r writes points [r*run, r*run + run + 3) of its
    tiles' bands (a tile's bands at its rows' end, the last three after its
    last tile) and the x sweep sums, for point j, the runs ``(j - 3) // run
    .. j // run`` (csrc: ``adjoint_xsweep_kernel``)."""
    landed = {}
    for j in range(n):
        rlo = (j - 3) // run if j >= 3 else 0
        rhi = min(runs - 1, j // run)
        assert rhi - rlo <= 1  # the x sweep reads two partials at most
        for r in range(rlo, rhi + 1):
            jl = j - r * run
            assert 0 <= jl < run + 3
            nt = min(run, tiles - r * run)
            for m in range(4):  # the bands of run r's tiles that land on j
                t = j - m
                if r * run <= t < r * run + nt:
                    landed.setdefault((t, m), []).append(j)
    assert sorted(landed) == [(t, m) for t in range(tiles) for m in range(4)]
    assert all(js == [t + m] for (t, m), js in landed.items())


@pytest.mark.parametrize("tile", TILES)
def test_every_y_band_lands_on_its_control_point_once(tile):
    for c in (1, 3):
        for vol in _volumes(tile) + [PHANTOM1, COARSE]:
            geo = bsi_adjoint.stream_blocks(tile, c, vol)
            ty = -(-vol[1] // tile[1])
            assert geo.runs == -(-ty // geo.run) and (geo.runs - 1) * geo.run < ty
            assert geo.run >= min(3, ty)
            _check_runs(ty, geo.run, geo.runs, ty + 3 + 2)


def test_phantom1_one_block_a_plane_and_small_partials():
    """At the paper's volume a block owns a whole plane, all 80 z control
    points of its 3 channels with 9 warps, and the planes fill an H100;
    the partials are hy itself, 24 MB, where the earlier design kept 136 MB.
    Its coarse level splits each plane into two runs to fill the card, and
    a card of fewer SMs into fewer."""
    fill = bsi_adjoint.H100_SMS * bsi_adjoint.STREAM_FILL_WARPS_PER_SM
    geo = bsi_adjoint.stream_blocks((5, 5, 5), 3, PHANTOM1)
    assert (geo.span, geo.zparts, geo.runs, geo.threads) == (80, 1, 1, 288)
    assert geo.smem == 18_752 and geo.segment == 385 * 3
    assert PHANTOM1[0] * geo.threads // 32 >= fill
    assert geo.partial_floats == 512 * 49 * 80 * 3
    coarse = bsi_adjoint.stream_blocks((5, 5, 5), 3, COARSE)
    assert (coarse.span, coarse.threads, coarse.runs, coarse.run) == (42, 160, 2, 12)
    assert COARSE[0] * coarse.runs * coarse.threads // 32 >= fill
    assert bsi_adjoint.stream_blocks((5, 5, 5), 3, COARSE, 64).runs == 1
    assert bsi_adjoint.stream_blocks((5, 5, 5), 3, COARSE, 264).runs == 4


def test_phantom1_taps_fall_on_distinct_banks():
    """dz*C = 15 is odd, so the lanes of a warp of one channel load 32
    distinct banks for each voxel offset; a warp that crosses a channel at
    most two-way conflicts."""
    tile, c, vol = (5, 5, 5), 3, PHANTOM1
    geo = bsi_adjoint.stream_blocks(tile, c, vol)
    _, _, lanes = _lanes(geo, tile, c, vol, 0, 0)
    for w in range(0, len(lanes), 32):
        warp = [(ch, kz) for ch, kz, na, _ in lanes[w:w + 32] if na]
        banks = np.bincount([(kz * tile[2] * c + ch) % 32 for ch, kz in warp], minlength=32)
        assert banks.max() <= (1 if len({ch for ch, _ in warp}) == 1 else 2)


def test_stream_blocks_refuse_what_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        bsi_adjoint.stream_blocks((5, 5, 5000), 3, (10, 10, 20000))
    many = bsi_adjoint.stream_blocks((1, 1, 1), 100, (2, 2, 2))  # two channel groups
    assert (many.channels, many.span, many.zparts) == (66, 1, 5 * 2)


def test_the_card_tests_span_runs_and_z_parts():
    """``tests/test_torch_cuda.py`` runs the kernel on volumes whose planes
    are split into several runs of y tiles, the last one short, and on one
    whose z outputs need several blocks."""
    several = bsi_adjoint.stream_blocks((5, 5, 5), 3, (40, 33, 47))
    assert several.runs >= 2 and several.runs * several.run > -(-33 // 5)
    assert bsi_adjoint.stream_blocks((5, 5, 2), 3, (6, 40, 1200)).zparts > 1
