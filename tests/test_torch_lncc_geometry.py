"""The fused lncc kernel's column geometry (``kernels.bsi_fused.lncc_blocks``).

Pure arithmetic on the shapes, so it runs on the CPU: the kernel itself runs
only on the card (``tests/test_torch_cuda.py``).  A block owns a column of
``own`` tiles, marches along x and stages ``window - 1`` voxels beyond its
own positions on each axis.  Every VALID window position must belong to
exactly one block of the launch grid, the grid must be the ``num_partials``
the partial rows are sized by, and the shared memory must fit a block.
"""

import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import bsi_fused, bsi_ttli, ops  # noqa: E402

# the card tests' (volume, tile) cases, and phantom1 and its coarse level
CASES = [
    ((13, 11, 9), (5, 4, 3)),
    ((40, 33, 47), (5, 5, 5)),
    ((12, 11, 9), (3, 3, 3)),
    ((22, 15, 30), (7, 7, 7)),
    ((11, 12, 45), (1, 1, 1)),
]
PHANTOM1 = [((512, 228, 385), (5, 5, 5)), ((256, 114, 193), (5, 5, 5))]
# windows clamped to the smallest extent: 9, 15 and 11
CLAMPED = [((13, 11, 9), (5, 4, 3)), ((22, 15, 30), (7, 7, 7)),
           ((11, 12, 45), (1, 1, 1))]
TWO_BLOCKS_SMEM_BYTES = 233_472 // 2 - 1024  # 228 KB an SM, 1 KB reserved a block


def _grid(vol, tile, own):
    """Blocks per axis of the launch (csrc: tile_grid of the owned tiles)."""
    return [-(-(-(-s // d)) // o) for s, d, o in zip(vol, tile, own)]


def _check_columns(vol, tile, window, form):
    own, extra = bsi_fused.lncc_blocks(tile, window, form, vol)
    grid = _grid(vol, tile, own)
    assert math.prod(grid) == bsi_fused.num_partials(vol, tile, own)
    smem = bsi_fused._lncc_smem_bytes(tile, own, window, form)
    assert smem <= bsi_ttli.MAX_SMEM_BYTES
    total = 1
    for s, d, o, e, nb in zip(vol, tile, own, extra, grid):
        # the halo tiles hold the window's reach; the last block reaches the
        # volume's end
        assert e == -(-(window - 1) // d) and (nb - 1) * o * d < s <= nb * o * d
        valid = s - window + 1
        owners = np.zeros(valid, int)
        for b in range(nb):
            x0 = b * o * d
            n_own = min(o * d, valid - x0)  # csrc: nout, yv, zv
            if n_own > 0:
                owners[x0:x0 + n_own] += 1
                # the staged voxels of its windows lie in the volume and in
                # its staged tiles
                assert x0 + n_own + window - 1 <= min(s, x0 + (o + e) * d)
        assert (owners == 1).all()
        total *= int(owners.sum())
    assert total == math.prod(s - window + 1 for s in vol)
    return own


@pytest.mark.parametrize("form", bsi_fused.DISP_FORMS)
@pytest.mark.parametrize("window", [9, 5, 1])
@pytest.mark.parametrize("vol,tile", CASES + PHANTOM1)
def test_lncc_columns_own_every_valid_position_once(vol, tile, window, form):
    _check_columns(vol, tile, window, form)


@pytest.mark.parametrize("form", bsi_fused.DISP_FORMS)
@pytest.mark.parametrize("vol,tile", CLAMPED)
def test_lncc_columns_at_a_window_clamped_to_the_volume(vol, tile, form):
    window = ops.lncc_window(64, vol)
    assert window == min(vol)
    _check_columns(vol, tile, window, form)


@pytest.mark.parametrize("form", bsi_fused.DISP_FORMS)
@pytest.mark.parametrize("vol,tile", PHANTOM1)
def test_lncc_columns_at_phantom1_let_two_blocks_share_an_sm(vol, tile, form):
    """At the paper's volume and its coarse level the column fits two
    blocks an SM, fills the card's 132 SMs twice over, and warps 2-3.5
    voxels per own one (the coarse level trades warps for blocks)."""
    own = _check_columns(vol, tile, 9, form)
    assert bsi_fused._lncc_smem_bytes(tile, own, 9, form) <= TWO_BLOCKS_SMEM_BYTES
    staged = math.prod(s - 8 + -(-(s - 8) // (o * d)) * 8
                       for s, d, o in zip(vol, tile, own))
    assert staged / math.prod(s - 8 for s in vol) < 3.5
    assert bsi_fused.num_partials(vol, tile, own) >= 2 * 2 * 132


def test_lncc_columns_refuse_what_no_block_holds():
    """A window of 33 at a 5^3 tile needs a ring of 33 slices: no column of
    one tile fits a block's shared memory."""
    with pytest.raises(ValueError, match="shared memory"):
        bsi_fused.lncc_blocks((5, 5, 5), 33, "lerp", (40, 33, 47))
