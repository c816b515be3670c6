"""The port's FFD layer against the JAX package, at 1e-6.

Includes the clamp-tie gradient: at ``phi = 0`` every border voxel sits
exactly on a clamp bound, where ``jnp.clip`` gives gradient 0.5 and
``torch.clamp`` gives 1; the port's ``minimum(maximum(...))`` must give 0.5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ffd as rffd  # noqa: E402
from repro.engine.batch import ffd_level_loss as ref_level_loss  # noqa: E402
from repro_torch.core import ffd  # noqa: E402
from repro_torch.engine.batch import ffd_level_objective  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
VOL = (13, 11, 9)
TILE = (5, 4, 3)


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _vol(seed, shape=VOL):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_trilinear_sample_matches_reference():
    vol = _vol(0)
    # coordinates inside, on and past every border
    coords = (np.random.default_rng(1).uniform(-3, 16, (7, 5, 6, 3))
              .astype(np.float32))
    coords[0, 0, 0] = (0.0, 10.0, 8.0)
    ref = np.asarray(rffd.trilinear_sample(jnp.asarray(vol), jnp.asarray(coords)))
    out = ffd.trilinear_sample(torch.from_numpy(vol), torch.from_numpy(coords))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def test_warp_volume_matches_reference():
    vol, disp = _vol(2), _rand(VOL + (3,), 3, 2.0)
    ref = np.asarray(rffd.warp_volume(jnp.asarray(vol), jnp.asarray(disp)))
    out = ffd.warp_volume(torch.from_numpy(vol), torch.from_numpy(disp))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("disp_scale", [0.0, 1.5])
def test_warp_gradient_matches_jax_including_clamp_ties(disp_scale):
    mov, fix = _vol(4), _vol(5)
    disp = _rand(VOL + (3,), 6, disp_scale)

    def ref_loss(d):
        return jnp.mean((rffd.warp_volume(jnp.asarray(mov), d) - fix) ** 2)

    ref = np.asarray(jax.grad(ref_loss)(jnp.asarray(disp)))
    d = torch.from_numpy(disp).requires_grad_(True)
    loss = torch.mean((ffd.warp_volume(torch.from_numpy(mov), d)
                       - torch.from_numpy(fix)) ** 2)
    (out,) = torch.autograd.grad(loss, d)
    if disp_scale == 0.0:  # the tie at the lower bound carries a gradient
        assert np.abs(ref[0, :, :, 0]).max() > 0
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("shape", [(12, 10, 8), (13, 11, 9)])
def test_downsample2_matches_reference(shape):
    vol = _vol(7, shape)
    ref = np.asarray(rffd.downsample2(jnp.asarray(vol)))
    out = ffd.downsample2(torch.from_numpy(vol)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_upsample_grid_matches_reference():
    phi = _rand((7, 6, 6, 3), 8)
    new = (11, 9, 10)
    ref = np.asarray(rffd.upsample_grid(jnp.asarray(phi), new))
    out = ffd.upsample_grid(torch.from_numpy(phi), new).numpy()
    assert out.shape == new + (3,)
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("mode,impl", [("ttli", "cuda"), ("ttli", "torch"),
                                       ("separable", "torch"), ("gather", "torch")])
def test_dense_field_matches_reference(mode, impl):
    phi = _rand(rffd.grid_shape_for_volume(VOL, TILE) + (3,), 9)
    ref = np.asarray(rffd.dense_field(jnp.asarray(phi), TILE, VOL, mode=mode))
    grad_impl = "cuda" if impl == "cuda" else "autograd"
    out = ffd.dense_field(torch.from_numpy(phi), TILE, VOL, mode=mode, impl=impl,
                          grad_impl=grad_impl)
    assert tuple(out.shape) == VOL + (3,)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def test_bending_energy_and_grid_shape_match_reference():
    phi = _rand((8, 7, 6, 3), 10)
    ref = float(rffd.bending_energy(jnp.asarray(phi)))
    out = ffd.bending_energy(torch.from_numpy(phi))
    assert out.dtype == torch.float32
    assert abs(out.item() - ref) <= 1e-6 * abs(ref)
    assert ffd.grid_shape_for_volume(VOL, TILE) == rffd.grid_shape_for_volume(VOL, TILE)


@pytest.mark.parametrize("tile", [TILE, (3, 3, 3)])
def test_fused_level_loss_and_gradient_equal_unfused(tile):
    mov, fix = _vol(11), _vol(12)
    phi = torch.from_numpy(_rand(ffd.grid_shape_for_volume(VOL, tile) + (3,), 13, 1.5))
    kw = dict(tile=tile, bending_weight=5e-3, mode="ttli", impl="cuda",
              grad_impl="cuda")
    f, m = torch.from_numpy(fix), torch.from_numpy(mov)
    lf, gf = ffd_level_objective(f, m, fused="on", **kw).vg(phi)
    lu, gu = ffd_level_objective(f, m, fused="off", **kw).vg(phi)
    assert abs(lf.item() - lu.item()) <= 1e-6 * abs(lu.item())
    assert (gf - gu).abs().max().item() <= 1e-6 * gu.abs().max().item()
    # and both equal the JAX package's unfused level loss
    ref = float(ref_level_loss(jnp.asarray(fix), jnp.asarray(mov), tile=tile,
                               bending_weight=5e-3, mode="ttli", impl="jnp")(
                                   jnp.asarray(phi.numpy())))
    assert abs(lu.item() - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("similarity", ["ncc", "nmi"])
@pytest.mark.parametrize("tile", [TILE, (3, 3, 3)])
def test_fused_multimodal_loss_and_gradient_equal_unfused(similarity, tile):
    mov = np.clip(_vol(15) * 1.3 - 0.1, 0.0, 1.0)  # min/max ties, as a phantom
    fix = _vol(16)
    phi = torch.from_numpy(_rand(ffd.grid_shape_for_volume(VOL, tile) + (3,), 17, 1.5))
    kw = dict(tile=tile, bending_weight=5e-3, mode="ttli", impl="cuda",
              grad_impl="cuda", similarity=similarity)
    f, m = torch.from_numpy(fix), torch.from_numpy(mov)
    lf, gf = ffd_level_objective(f, m, fused="on", **kw).vg(phi)
    lu, gu = ffd_level_objective(f, m, fused="off", **kw).vg(phi)
    assert abs(lf.item() - lu.item()) <= 1e-6 * abs(lu.item())
    assert (gf - gu).abs().max().item() <= 1e-6 * gu.abs().max().item()
    ref = float(ref_level_loss(jnp.asarray(fix), jnp.asarray(mov), tile=tile,
                               bending_weight=5e-3, mode="ttli", impl="jnp",
                               similarity=similarity)(jnp.asarray(phi.numpy())))
    assert abs(lu.item() - ref) <= 1e-5 * abs(ref)


def test_fused_lncc_is_not_ported_and_unfused_lncc_runs():
    """Fused LNCC now runs: fused and unfused agree in loss and gradient, and
    both equal the JAX package's unfused level loss."""
    phi = torch.zeros(ffd.grid_shape_for_volume(VOL, TILE) + (3,))
    vol = torch.from_numpy(_vol(18))
    fix = _vol(19)
    kw = dict(tile=TILE, bending_weight=5e-3, mode="ttli", impl="cuda",
              grad_impl="cuda", similarity="lncc")
    lf, gf = ffd_level_objective(torch.from_numpy(fix), vol, fused="on", **kw).vg(phi)
    lu, gu = ffd_level_objective(torch.from_numpy(fix), vol, fused="off", **kw).vg(phi)
    ref = float(ref_level_loss(jnp.asarray(fix), jnp.asarray(vol.numpy()), tile=TILE,
                               bending_weight=5e-3, mode="ttli", impl="jnp",
                               similarity="lncc")(jnp.asarray(phi.numpy())))
    assert abs(lu.item() - ref) <= 1e-5 * abs(ref) and torch.isfinite(gu).all()
    assert abs(lf.item() - lu.item()) <= 1e-6 * abs(lu.item())
    assert (gf - gu).abs().max().item() <= 1e-6 * gu.abs().max().item()


@pytest.mark.parametrize("similarity", ["ssd", "ncc", "nmi", "lncc"])
def test_fused_matmul_level_loss_and_gradient_equal_unfused(similarity):
    """``mode="matmul", grad_impl="matmul"``: the fused step (matrix-form
    displacement) equals the unfused one in loss and gradient, and both the
    JAX package's unfused level loss in the matrix form."""
    mov = np.clip(_vol(20) * 1.3 - 0.1, 0.0, 1.0)
    fix = _vol(21)
    phi = torch.from_numpy(_rand(ffd.grid_shape_for_volume(VOL, TILE) + (3,), 22, 1.5))
    kw = dict(tile=TILE, bending_weight=5e-3, mode="matmul", impl="cuda",
              grad_impl="matmul", similarity=similarity)
    f, m = torch.from_numpy(fix), torch.from_numpy(mov)
    lf, gf = ffd_level_objective(f, m, fused="on", **kw).vg(phi)
    lu, gu = ffd_level_objective(f, m, fused="off", **kw).vg(phi)
    assert abs(lf.item() - lu.item()) <= 1e-6 * abs(lu.item())
    assert (gf - gu).abs().max().item() <= 1e-6 * gu.abs().max().item()
    ref = float(ref_level_loss(jnp.asarray(fix), jnp.asarray(mov), tile=TILE,
                               bending_weight=5e-3, mode="matmul", impl="jnp",
                               similarity=similarity)(jnp.asarray(phi.numpy())))
    assert abs(lu.item() - ref) <= 1e-5 * abs(ref)


def test_fused_warp_loss_needs_a_fused_similarity():
    phi = torch.zeros(ffd.grid_shape_for_volume(VOL, TILE) + (3,))
    vol = torch.from_numpy(_vol(14))
    with pytest.raises(ValueError, match="no fused kernel"):
        ffd.fused_warp_loss(phi, vol, vol, TILE, similarity=lambda w, f: (w - f).sum())
