"""The matmul adjoint kernel's box geometry (``kernels.bsi_adjoint.matmul_blocks``).

Pure arithmetic on the shapes, so it runs on the CPU: the kernel itself runs
only on the card (``tests/test_torch_cuda.py``).  A block contracts a box of
tiles and overlap-adds their 64 bands into one partial per control point the
box touches (``_box_bands``); the seam pass sums, for each control point, the
partials of the boxes that hold it (``_seam_boxes``), both the kernel's loop
bounds (``csrc/bsi_adjoint.cu``) written out here.  The index arithmetic is
separable, so it is checked per axis: every (tile, band) pair must land on
its control point exactly once, and the block must fit its shared memory.
"""

import math

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import bsi_adjoint, bsi_ttli  # noqa: E402

# the card tests' (volume, tile) cases, the one spanning several boxes per
# axis, and phantom1 and its coarse level
CASES = [
    ((13, 11, 9), (5, 4, 3)),
    ((40, 33, 47), (5, 5, 5)),
    ((12, 11, 9), (3, 3, 3)),
    ((22, 15, 30), (7, 7, 7)),
    ((11, 12, 45), (1, 1, 1)),
    ((83, 61, 97), (5, 4, 3)),
]
PHANTOM1 = [((512, 228, 385), (5, 5, 5)), ((256, 114, 193), (5, 5, 5))]
TWO_BLOCKS_SMEM_BYTES = 233_472 // 2 - 1024  # 228 KB an SM, 1 KB reserved a block


def _box_bands(q, own):
    """The bands ``l`` of one axis that land on a box's local control point
    ``q`` from its first ``own`` tiles, the tile being ``q - l`` (csrc: the
    owner's loops of ``adjoint_matmul_box_kernel``)."""
    return range(max(0, q - own + 1), min(3, q) + 1)


def _seam_boxes(p, b, nb):
    """The boxes of one axis whose partial holds control point ``p``: box
    ``i`` holds the points ``[i*b, i*b + b + 3)`` of ``nb`` boxes of ``b``
    tiles (csrc: ``adjoint_matmul_seam_kernel``)."""
    return range((p - 3) // b if p >= 3 else 0, min(nb - 1, p // b) + 1)


def _check_axis(tiles, b, nb, n):
    """One axis of ``tiles`` tiles in ``nb`` boxes of ``b`` with ``n`` control
    points: each (tile, band) pair is summed into one box's partial and that
    partial is read once, by the seam pass of the point ``tile + band``."""
    landed = {}  # (tile, band) -> points it reached through the seam
    reads = {}  # (box, local point) -> points whose seam read it
    for p in range(n):
        for i in _seam_boxes(p, b, nb):
            q = p - i * b
            assert 0 <= q < b + 3
            reads.setdefault((i, q), []).append(p)
    for i in range(nb):
        own = min(b, tiles - i * b)
        assert own >= 1
        for q in range(b + 3):
            for band in _box_bands(q, own):
                t = i * b + q - band
                assert i * b <= t < i * b + own and 0 <= band < 4
                landed.setdefault((t, band), []).extend(reads.get((i, q), []))
    assert all(len(ps) == 1 for ps in reads.values())
    assert sorted(landed) == [(t, band) for t in range(tiles) for band in range(4)]
    assert all(ps == [t + band] for (t, band), ps in landed.items())
    # no seam reads past the last box's points
    assert all(not _seam_boxes(p, b, nb) for p in range(nb * b + 3, n))


def _check(vol, tile, c, extra_points=0):
    geo = bsi_adjoint.matmul_blocks(tile, c, vol)
    tiles = [-(-s // d) for s, d in zip(vol, tile)]
    assert geo.cols in bsi_adjoint.MATMUL_COLS and math.prod(geo.box) * c <= geo.cols
    assert geo.boxes == tuple(-(-t // b) for t, b in zip(tiles, geo.box))
    assert geo.smem == bsi_adjoint.matmul_smem_bytes(tile, geo.cols, geo.box, c)
    assert geo.smem <= bsi_ttli.MAX_SMEM_BYTES
    assert geo.partial_floats == (math.prod(geo.boxes) * c
                                  * math.prod(b + 3 for b in geo.box))
    for t, b, nb in zip(tiles, geo.box, geo.boxes):
        _check_axis(t, b, nb, t + 3 + extra_points)
    return geo


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("vol,tile", CASES + PHANTOM1)
def test_every_band_lands_on_its_control_point_once(vol, tile, c):
    _check(vol, tile, c)


@pytest.mark.parametrize("vol,tile", CASES[:2])
def test_a_grid_beyond_the_tiles_reads_no_partial_past_the_boxes(vol, tile):
    """A control grid larger than the volume needs: its last points get no
    band, and the seam pass reads no partial for them."""
    _check(vol, tile, 3, extra_points=4)


def test_a_grid_that_is_not_a_multiple_of_the_box():
    vol, tile = CASES[-1]
    geo = _check(vol, tile, 3)
    tiles = [-(-s // d) for s, d in zip(vol, tile)]
    assert min(geo.boxes) >= 2
    assert any(nb * b > t for nb, b, t in zip(geo.boxes, geo.box, tiles))


@pytest.mark.parametrize("vol,tile", PHANTOM1)
def test_phantom1_boxes_share_an_sm_and_keep_the_partials_small(vol, tile):
    """At the paper's volume and its coarse level a block of 128 threads
    leaves room for a second on its SM, the boxes fill the card's 132 SMs
    several times over, and the partials stay under 64 MB, a sixth of the
    ``tiles x 3 x 64`` band sums."""
    geo = _check(vol, tile, 3)
    tiles = math.prod(-(-s // d) for s, d in zip(vol, tile))
    assert geo.cols == 128 and geo.smem <= TWO_BLOCKS_SMEM_BYTES
    assert math.prod(geo.boxes) >= 4 * 2 * 132
    assert 4 * geo.partial_floats <= 64e6
    assert 6 * geo.partial_floats <= tiles * 3 * 64


def test_matmul_blocks_refuse_what_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        bsi_adjoint.matmul_blocks((10, 10, 10), 3, (40, 40, 40))
    with pytest.raises(ValueError, match="channels"):
        bsi_adjoint.matmul_blocks((5, 5, 5), 129, (40, 40, 40))
