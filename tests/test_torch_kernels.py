"""The kernels' plain versions (what runs on the CPU) against the JAX package.

The reference's Pallas kernels run in interpret mode on the CPU, as its own
tests run them.  Tolerances: 1e-5 for BSI forms and adjoints in fp32 (the
reference holds its own forms to it), relative to the largest magnitude for
sums.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ffd as rffd  # noqa: E402
from repro.core import interpolate as rint  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.core import interpolate as tint  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# (control grid points, tile): non-cubic tiles, the paper's 5^3
GRIDS = [
    ((7, 6, 5), (5, 4, 3)),
    ((9, 9, 9), (5, 5, 5)),
    ((5, 13, 9), (4, 6, 5)),
    ((4, 4, 4), (3, 3, 3)),
]
# (volume, tile) with volumes off the tile grid
VOLUMES = [((13, 11, 9), (5, 4, 3)), ((12, 11, 9), (3, 3, 3)),
           ((21, 17, 12), (5, 5, 5))]


def _phi(grid, seed=0, c=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(tuple(grid) + (c,)).astype(np.float32)


@pytest.mark.parametrize("grid,tile", GRIDS)
def test_ttli_plain_matches_reference_kernel_and_gather(grid, tile):
    phi = _phi(grid)
    out = ops.bsi_ttli(torch.from_numpy(phi), tile).numpy()
    pallas = np.asarray(rops.bsi_pallas(jnp.asarray(phi), tile, mode="ttli"))
    gather = np.asarray(rint.bsi_gather(jnp.asarray(phi), tile))
    assert out.shape == pallas.shape
    np.testing.assert_allclose(out, pallas, atol=1e-5)
    np.testing.assert_allclose(out, gather, atol=1e-5)


@pytest.mark.parametrize("mode", ["gather", "ttli", "separable"])
@pytest.mark.parametrize("grid,tile", GRIDS[:2])
def test_plain_forms_match_reference_gather(mode, grid, tile):
    phi = _phi(grid, 1)
    out = tint.MODES[mode](torch.from_numpy(phi), tile).numpy()
    ref = np.asarray(rint.bsi_gather(jnp.asarray(phi), tile))
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("vol,tile", VOLUMES)
def test_ttli_crop_matches_reference_dense_field(vol, tile):
    phi = _phi(rffd.grid_shape_for_volume(vol, tile), 2)
    out = ops.bsi_ttli(torch.from_numpy(phi), tile, vol).numpy()
    ref = np.asarray(rffd.dense_field(jnp.asarray(phi), tile, vol, mode="ttli",
                                      impl="pallas"))
    assert out.shape == vol + (3,)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("grid,tile", GRIDS)
@pytest.mark.parametrize("c", [1, 3])
def test_adjoint_plain_matches_reference_kernel(grid, tile, c):
    full = tuple((n - 3) * d for n, d in zip(grid, tile))
    g = _phi(full, 3, c)
    out = ops.bsi_adjoint(torch.from_numpy(g), tile, grid).numpy()
    ref = np.asarray(rops.bsi_adjoint_pallas(jnp.asarray(g), tile, form="separable"))
    assert out.shape == ref.shape == tuple(grid) + (c,)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("vol,tile", VOLUMES)
def test_adjoint_of_cropped_field_masks_the_outside(vol, tile):
    grid = rffd.grid_shape_for_volume(vol, tile)
    g = _phi(vol, 4)
    full = tuple((n - 3) * d for n, d in zip(grid, tile))
    padded = np.zeros(full + (3,), np.float32)
    padded[: vol[0], : vol[1], : vol[2]] = g
    out = ops.bsi_adjoint(torch.from_numpy(g), tile, grid).numpy()
    ref = np.asarray(rops.bsi_adjoint_pallas(jnp.asarray(padded), tile))
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("vol,tile", VOLUMES)
def test_transpose_identity(vol, tile):
    grid = rffd.grid_shape_for_volume(vol, tile)
    phi = torch.from_numpy(_phi(grid, 5))
    g = torch.from_numpy(_phi(vol, 6))
    lhs = torch.sum(ops.bsi_ttli(phi, tile, vol).double() * g.double())
    rhs = torch.sum(phi.double() * ops.bsi_adjoint(g, tile, grid).double())
    assert abs(lhs - rhs).item() <= 1e-5 * abs(lhs).item()


@pytest.mark.parametrize("vol,tile", VOLUMES)
def test_fused_plain_matches_reference_fused_ssd(vol, tile):
    rng = np.random.default_rng(7)
    grid = rffd.grid_shape_for_volume(vol, tile)
    phi = (rng.standard_normal(grid + (3,)) * 1.5).astype(np.float32)
    mov, fix = (rng.uniform(0, 1, vol).astype(np.float32) for _ in range(2))
    ref = float(rops.fused_similarity_loss(jnp.asarray(phi), jnp.asarray(mov),
                                           jnp.asarray(fix), tile, sim_spec=("ssd",)))
    out = ops.fused_ssd_loss(torch.from_numpy(phi), torch.from_numpy(mov),
                             torch.from_numpy(fix), tile)
    assert out.dtype == torch.float32 and out.dim() == 0
    assert abs(out.item() - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("mode,impl,grad_impl", [
    ("ttli", "cuda", "cuda"),
    ("ttli", "torch", "torch"),
    ("separable", "torch", "cuda"),
    ("gather", "torch", "autograd"),
])
def test_interpolate_gradient_matches_autograd_of_gather(mode, impl, grad_impl):
    tile = (5, 4, 3)
    phi = torch.from_numpy(_phi((7, 6, 8), 8)).requires_grad_(True)
    w = torch.from_numpy(_phi((20, 12, 15), 9))
    out = tint.interpolate(phi, tile, mode=mode, impl=impl, grad_impl=grad_impl)
    (g,) = torch.autograd.grad((out * w).sum(), phi)
    (ref,) = torch.autograd.grad((tint.bsi_gather(phi, tile) * w).sum(), phi)
    assert g.dtype == phi.dtype
    assert (g - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    ops.reset_launch_counts()
    phi = torch.from_numpy(_phi((7, 6, 5)))
    vol = (10, 8, 6)
    g = ops.bsi_ttli(phi, (5, 4, 3), vol)
    ops.bsi_adjoint(g, (5, 4, 3), (7, 6, 5))
    ops.fused_ssd_loss(phi, g[..., 0].contiguous(), g[..., 1].contiguous(), (5, 4, 3))
    assert ops.launch_counts() == {"bsi_ttli": 0, "bsi_adjoint": 0, "bsi_fused": 0}


def test_dispatchers_check_coverage():
    phi = torch.from_numpy(_phi((7, 6, 5)))
    with pytest.raises(ValueError, match="does not cover"):
        ops.bsi_ttli(phi, (5, 4, 3), (21, 12, 6))
    with pytest.raises(ValueError, match="does not cover"):
        ops.bsi_adjoint(torch.zeros(21, 12, 6, 3), (5, 4, 3), (7, 6, 5))
