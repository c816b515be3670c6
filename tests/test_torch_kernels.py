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
from repro_torch.kernels import bsi_fused, bsi_separable, bsi_tt, ops  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
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


@pytest.mark.parametrize("mode", ["gather", "ttli", "separable", "tt", "matmul"])
@pytest.mark.parametrize("grid,tile", GRIDS[:2])
def test_plain_forms_match_reference_gather(mode, grid, tile):
    phi = _phi(grid, 1)
    out = tint.MODES[mode](torch.from_numpy(phi), tile).numpy()
    ref = np.asarray(rint.bsi_gather(jnp.asarray(phi), tile))
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("form", ["kernel", "plain", "tt"])
@pytest.mark.parametrize("grid,tile", GRIDS)
def test_matmul_and_tt_plain_match_reference_kernel_and_gather(grid, tile, form):
    """The matmul kernel's plain version (64 terms in order), the plain
    matrix form and the plain TT form against the reference's matmul kernel
    in interpret mode and its gather oracle."""
    phi = _phi(grid, 11)
    t = torch.from_numpy(phi)
    out = {"kernel": lambda: ops.bsi_matmul(t, tile), "plain": lambda: tint.bsi_matmul(
        t, tile), "tt": lambda: tint.bsi_tt(t, tile)}[form]().numpy()
    pallas = np.asarray(rops.bsi_pallas(jnp.asarray(phi), tile, mode="matmul"))
    gather = np.asarray(rint.bsi_gather(jnp.asarray(phi), tile))
    assert out.shape == pallas.shape
    np.testing.assert_allclose(out, pallas, atol=1e-5)
    np.testing.assert_allclose(out, gather, atol=1e-5)


@pytest.mark.parametrize("vol,tile", VOLUMES)
def test_matmul_crop_matches_reference_dense_field(vol, tile):
    phi = _phi(rffd.grid_shape_for_volume(vol, tile), 12)
    out = ops.bsi_matmul(torch.from_numpy(phi), tile, vol).numpy()
    ref = np.asarray(rffd.dense_field(jnp.asarray(phi), tile, vol, mode="matmul",
                                      impl="pallas"))
    assert out.shape == vol + (3,)
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


@pytest.mark.parametrize("grid,tile", GRIDS)
@pytest.mark.parametrize("c", [1, 3])
def test_adjoint_matmul_plain_matches_reference_kernel_and_separable(grid, tile, c):
    full = tuple((n - 3) * d for n, d in zip(grid, tile))
    g = torch.from_numpy(_phi(full, 13, c))
    out = ops.bsi_adjoint_matmul(g, tile, grid).numpy()
    ref = np.asarray(rops.bsi_adjoint_pallas(jnp.asarray(g.numpy()), tile,
                                             form="matmul"))
    sep = ops.bsi_adjoint(g, tile, grid).numpy()
    assert out.shape == ref.shape == tuple(grid) + (c,)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(out - sep).max() <= 1e-5 * np.abs(sep).max()


@pytest.mark.parametrize("vol,tile", VOLUMES)
def test_adjoint_matmul_of_cropped_field_masks_the_outside(vol, tile):
    grid = rffd.grid_shape_for_volume(vol, tile)
    g = _phi(vol, 14)
    full = tuple((n - 3) * d for n, d in zip(grid, tile))
    padded = np.zeros(full + (3,), np.float32)
    padded[: vol[0], : vol[1], : vol[2]] = g
    out = ops.bsi_adjoint_matmul(torch.from_numpy(g), tile, grid).numpy()
    ref = np.asarray(rops.bsi_adjoint_pallas(jnp.asarray(padded), tile, form="matmul"))
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("grid,tile", GRIDS)
@pytest.mark.parametrize("c", [1, 3])
def test_blocked_matmul_adjoint_twin_matches_reference_kernel_and_plain(grid, tile, c):
    """The matmul adjoint kernel's reduction in tensor ops (box partials, then
    the seam sum) against the reference's Pallas kernel and ``plain_matmul``."""
    from repro_torch.kernels import bsi_adjoint

    full = tuple((n - 3) * d for n, d in zip(grid, tile))
    g = torch.from_numpy(_phi(full, 17, c))
    out = bsi_adjoint.plain_matmul_blocked(g, tile, grid).numpy()
    ref = np.asarray(rops.bsi_adjoint_pallas(jnp.asarray(g.numpy()), tile,
                                             form="matmul"))
    plain = bsi_adjoint.plain_matmul(g, tile, grid).numpy()
    assert out.shape == ref.shape == tuple(grid) + (c,)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(out - plain).max() <= 1e-5 * np.abs(plain).max()


@pytest.mark.parametrize("vol,tile", VOLUMES + [((40, 33, 47), (5, 5, 5))])
def test_blocked_matmul_adjoint_twin_masks_the_outside(vol, tile):
    """Cropped volumes, the last spanning several boxes along y."""
    from repro_torch.kernels import bsi_adjoint

    grid = rffd.grid_shape_for_volume(vol, tile)
    g = _phi(vol, 18)
    full = tuple((n - 3) * d for n, d in zip(grid, tile))
    padded = np.zeros(full + (3,), np.float32)
    padded[: vol[0], : vol[1], : vol[2]] = g
    out = bsi_adjoint.plain_matmul_blocked(torch.from_numpy(g), tile, grid).numpy()
    ref = np.asarray(rops.bsi_adjoint_pallas(jnp.asarray(padded), tile, form="matmul"))
    plain = bsi_adjoint.plain_matmul(torch.from_numpy(g), tile, grid).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(out - plain).max() <= 1e-5 * np.abs(plain).max()


@pytest.mark.parametrize("vol,tile", VOLUMES)
def test_transpose_identity_of_the_matmul_pair(vol, tile):
    grid = rffd.grid_shape_for_volume(vol, tile)
    phi = torch.from_numpy(_phi(grid, 15))
    g = torch.from_numpy(_phi(vol, 16))
    lhs = torch.sum(ops.bsi_matmul(phi, tile, vol).double() * g.double())
    rhs = torch.sum(phi.double() * ops.bsi_adjoint_matmul(g, tile, grid).double())
    assert abs(lhs - rhs).item() <= 1e-5 * abs(lhs).item()


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


FUSED_SPECS = [("ncc",), ("nmi", 32, 0.5, 1e-8), ("nmi", 16, 0.5, 1e-8)]


@pytest.mark.parametrize("spec", FUSED_SPECS, ids=lambda s: "-".join(map(str, s[:2])))
@pytest.mark.parametrize("vol,tile", VOLUMES)
def test_fused_plain_matches_reference_fused_similarity(vol, tile, spec):
    rng = np.random.default_rng(8)
    grid = rffd.grid_shape_for_volume(vol, tile)
    phi = (rng.standard_normal(grid + (3,)) * 1.5).astype(np.float32)
    mov, fix = (rng.uniform(0, 1, vol).astype(np.float32) for _ in range(2))
    ref = float(rops.fused_similarity_loss(jnp.asarray(phi), jnp.asarray(mov),
                                           jnp.asarray(fix), tile, sim_spec=spec,
                                           interpret=True))
    out = ops.fused_similarity_loss(torch.from_numpy(phi), torch.from_numpy(mov),
                                    torch.from_numpy(fix), tile, sim_spec=spec)
    assert out.dtype == torch.float32 and out.dim() == 0
    assert abs(out.item() - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("vol,tile", VOLUMES)
def test_fused_plain_passes_match_the_reference_warp(vol, tile):
    """stats, ncc and nmi of the plain versions against the same sums of the
    JAX package's unfused warp."""
    rng = np.random.default_rng(9)
    grid = rffd.grid_shape_for_volume(vol, tile)
    phi = (rng.standard_normal(grid + (3,)) * 1.5).astype(np.float32)
    mov = np.clip(rng.uniform(-0.2, 1, vol), 0, 1).astype(np.float32)  # ties
    fix = rng.uniform(0, 1, vol).astype(np.float32)
    w = np.asarray(rffd.warp_volume(jnp.asarray(mov), rffd.dense_field(
        jnp.asarray(phi), tile, vol, mode="ttli")), np.float64)
    p, m, f = (torch.from_numpy(a) for a in (phi, mov, fix))
    st = bsi_fused.plain_stats(p, m, tile).double().numpy()
    assert st[3] == w.size  # exact; min and max of two warps that round apart
    assert np.abs(st[1:3] - [w.min(), w.max()]).max() <= 1e-6
    assert abs(st[0] - w.sum()) <= 1e-5 * abs(w.sum())
    scal = torch.tensor([0.4, 0.5])
    acc = bsi_fused.plain_ncc(p, m, f, scal, tile).double().numpy()
    a, b = w - 0.4, fix.astype(np.float64) - 0.5
    ref = np.array([(a * b).sum(), (a * a).sum(), (b * b).sum()])
    assert np.abs(acc - ref).max() <= 1e-5 * np.abs(ref).max()
    scal = torch.tensor([w.min(), w.max(), fix.min(), fix.max()], dtype=torch.float32)
    hist = bsi_fused.plain_nmi(p, m, f, scal, tile, bins=16, sigma=0.5 / 15, eps=1e-8)
    assert hist.shape == (16, 16)
    assert abs(hist.sum().item() - w.size) <= 1e-4 * w.size  # rows sum to 1


MATMUL_SPECS = [("ssd",), ("ncc",), ("nmi", 32, 0.5, 1e-8), ("lncc", 9, 1e-5),
                ("lncc", 5, 1e-5)]


@pytest.mark.parametrize("spec", MATMUL_SPECS, ids=lambda s: "-".join(map(str, s[:2])))
@pytest.mark.parametrize("vol,tile", VOLUMES)
def test_fused_matmul_form_matches_reference_fused(vol, tile, spec):
    """Every fused variant with the matrix-form displacement against the
    reference's fused kernel with ``disp_form="matmul"``, 1e-5 relative."""
    rng = np.random.default_rng(17)
    grid = rffd.grid_shape_for_volume(vol, tile)
    phi = (rng.standard_normal(grid + (3,)) * 1.5).astype(np.float32)
    mov, fix = (rng.uniform(0, 1, vol).astype(np.float32) for _ in range(2))
    ref = float(rops.fused_similarity_loss(jnp.asarray(phi), jnp.asarray(mov),
                                           jnp.asarray(fix), tile, sim_spec=spec,
                                           interpret=True, disp_form="matmul"))
    out = ops.fused_similarity_loss(torch.from_numpy(phi), torch.from_numpy(mov),
                                    torch.from_numpy(fix), tile, sim_spec=spec,
                                    disp_form="matmul")
    assert out.dtype == torch.float32 and out.dim() == 0
    assert abs(out.item() - ref) <= 1e-5 * abs(ref)


# the last volume is smaller than a 9-voxel window: the window clamps to 7
LNCC_VOLUMES = VOLUMES + [((7, 10, 12), (3, 4, 5))]


@pytest.mark.parametrize("window", [9, 5])
@pytest.mark.parametrize("vol,tile", LNCC_VOLUMES)
def test_fused_plain_lncc_matches_reference_fused_lncc(vol, tile, window):
    """The lncc kernel's plain version (lerp form) against the reference's
    fused LNCC (separable form), 1e-5 relative; its count is the number of
    VALID positions of the clamped window."""
    rng = np.random.default_rng(18)
    grid = rffd.grid_shape_for_volume(vol, tile)
    phi = (rng.standard_normal(grid + (3,)) * 1.5).astype(np.float32)
    mov, fix = (rng.uniform(0, 1, vol).astype(np.float32) for _ in range(2))
    spec = ("lncc", window, 1e-5)
    ref = float(rops.fused_similarity_loss(jnp.asarray(phi), jnp.asarray(mov),
                                           jnp.asarray(fix), tile, sim_spec=spec,
                                           interpret=True, disp_form="separable"))
    p, m, f = (torch.from_numpy(a) for a in (phi, mov, fix))
    out = ops.fused_similarity_loss(p, m, f, tile, sim_spec=spec)
    assert abs(out.item() - ref) <= 1e-5 * abs(ref)
    w = ops.lncc_window(window, vol)
    acc = bsi_fused.plain_lncc(p, m, f, tile, window=w, eps=1e-5)
    assert acc[1].item() == np.prod([s - w + 1 for s in vol])
    assert abs(1.0 - acc[0].item() / acc[1].item() - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("vol,tile", VOLUMES)
def test_fused_matmul_warp_matches_the_reference_warp(vol, tile):
    """The matrix-form warp of the fused plain versions against the JAX
    package's unfused warp with ``mode="matmul"``: min, max and count of the
    stats pass, and the warped values themselves."""
    rng = np.random.default_rng(19)
    grid = rffd.grid_shape_for_volume(vol, tile)
    phi = (rng.standard_normal(grid + (3,)) * 1.5).astype(np.float32)
    mov = np.clip(rng.uniform(-0.2, 1, vol), 0, 1).astype(np.float32)
    w = np.asarray(rffd.warp_volume(jnp.asarray(mov), rffd.dense_field(
        jnp.asarray(phi), tile, vol, mode="matmul")), np.float64)
    p, m = torch.from_numpy(phi), torch.from_numpy(mov)
    out = bsi_fused.warped(p, m, tile, "matmul").double().numpy()
    assert np.abs(out - w).max() <= 1e-5
    st = bsi_fused.plain_stats(p, m, tile, disp_form="matmul").double().numpy()
    assert st[3] == w.size
    assert np.abs(st[1:3] - [w.min(), w.max()]).max() <= 1e-6
    assert abs(st[0] - w.sum()) <= 1e-5 * abs(w.sum())


def test_fused_dispatcher_names_what_is_not_ported():
    vol, tile = (13, 11, 9), (5, 4, 3)
    phi = torch.from_numpy(_phi(rffd.grid_shape_for_volume(vol, tile)))
    v = torch.zeros(vol)
    for spec in (("lncc", 9, 1e-5), ("ncc",)):  # ported: both forms run
        for form in bsi_fused.DISP_FORMS:
            out = ops.fused_similarity_loss(phi, v + 0.5, v + 0.25, tile, sim_spec=spec,
                                            disp_form=form)
            assert torch.isfinite(out)
    with pytest.raises(ValueError, match="disp_form"):
        ops.fused_similarity_loss(phi, v, v, tile, sim_spec=("ncc",),
                                  disp_form="separable")
    with pytest.raises(ValueError, match="2 to 64 bins"):
        ops.fused_similarity_loss(phi, v, v, tile, sim_spec=("nmi", 65, 0.5, 1e-8))
    with pytest.raises(ValueError, match="no fused kernel"):
        ops.fused_similarity_loss(phi, v, v, tile, sim_spec=("mae",))


@pytest.mark.parametrize("mode,impl,grad_impl", [
    ("ttli", "cuda", "cuda"),
    ("ttli", "torch", "torch"),
    ("separable", "torch", "cuda"),
    ("gather", "torch", "autograd"),
    ("matmul", "cuda", "matmul"),
    ("matmul", "torch", "matmul"),
    ("tt", "torch", "autograd"),
    ("matmul", "torch", "autograd"),
    ("separable", "cuda", "cuda"),
    ("tt", "cuda", "matmul"),
    ("tt", "cuda", "torch"),
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
    ops.bsi_separable(phi, (5, 4, 3), vol)
    ops.bsi_tt(phi, (5, 4, 3), vol)
    ops.bsi_matmul(phi, (5, 4, 3), vol)
    ops.bsi_adjoint(g, (5, 4, 3), (7, 6, 5))
    ops.bsi_adjoint_matmul(g, (5, 4, 3), (7, 6, 5))
    m, f = g[..., 0].contiguous(), g[..., 1].contiguous()
    for form in bsi_fused.DISP_FORMS:
        ops.fused_ssd_loss(phi, m, f, (5, 4, 3), disp_form=form)
        for spec in (("ncc",), ("nmi", 32, 0.5, 1e-8), ("lncc", 5, 1e-5)):
            ops.fused_similarity_loss(phi, m, f, (5, 4, 3), sim_spec=spec,
                                      disp_form=form)
    # bf16 and fp16 inputs: the reduced kernels' plain versions, every form
    for dt in (torch.bfloat16, torch.float16):
        phi16, m16, g16 = phi.to(dt), m.to(dt), g.to(dt)
        for form in ops.FORWARD_KERNELS.values():
            form(phi16, (5, 4, 3), vol)
        ops.bsi_adjoint(g16, (5, 4, 3), (7, 6, 5))
        ops.bsi_adjoint_matmul(g16, (5, 4, 3), (7, 6, 5))
        for form in bsi_fused.DISP_FORMS:
            for spec in (("ssd",), ("ncc",), ("nmi", 32, 0.5, 1e-8), ("lncc", 5, 1e-5)):
                ops.fused_similarity_loss(phi16, m16, f, (5, 4, 3), sim_spec=spec,
                                          disp_form=form)
    q = torch.ones((1, 8, 2, 16))
    ops.flash_attention(q, q[:, :, :1], q[:, :, :1], window=4, softcap=30.0)
    fused = [f"bsi_fused{k}{s}" for s in ("", "_matmul", "_bf16", "_matmul_bf16", "_f16",
                                          "_matmul_f16")
             for k in ("", "_stats", "_ncc", "_nmi", "_lncc")]
    forms = [f"bsi_{k}{s}" for s in ("", "_bf16", "_f16") for k in (
        "ttli", "separable", "tt", "matmul", "adjoint", "adjoint_matmul")]
    assert ops.launch_counts() == dict.fromkeys(forms + fused + ["flash_attention"], 0)


def test_dispatchers_check_coverage():
    phi = torch.from_numpy(_phi((7, 6, 5)))
    with pytest.raises(ValueError, match="does not cover"):
        ops.bsi_ttli(phi, (5, 4, 3), (21, 12, 6))
    with pytest.raises(ValueError, match="does not cover"):
        ops.bsi_adjoint(torch.zeros(21, 12, 6, 3), (5, 4, 3), (7, 6, 5))
    with pytest.raises(ValueError, match="does not cover"):
        ops.bsi_matmul(phi, (5, 4, 3), (21, 12, 6))
    with pytest.raises(ValueError, match="does not cover"):
        ops.bsi_adjoint_matmul(torch.zeros(21, 12, 6, 3), (5, 4, 3), (7, 6, 5))


def test_block_checks_raise_where_shared_memory_runs_out():
    """A 10^3 tile's basis (256 KB) fits no block: the matrix-form adjoint
    and fused kernels refuse it before launching; the forward matrix-form
    kernel keeps the basis in registers and refuses where one z tile's runs
    of 40 channels exceed a block; the lncc kernel sizes its column to what
    fits (a 1^3 tile's halo of 8 voxels a side) and refuses only where a
    column of one tile does not."""
    from repro_torch.kernels import bsi_adjoint, bsi_matmul

    big = (10, 10, 10)
    with pytest.raises(ValueError, match="shared memory"):
        bsi_matmul.matmul_blocks(big, 40, (40, 40, 40))
    assert bsi_matmul.matmul_blocks(big, 3, (40, 40, 40)).smem <= 232_448
    with pytest.raises(ValueError, match="shared memory"):
        bsi_adjoint.matmul_blocks(big, 3, (40, 40, 40))
    with pytest.raises(ValueError, match="shared memory"):
        bsi_fused.block_tiles(big, "matmul")
    with pytest.raises(ValueError, match="shared memory"):
        bsi_fused.lncc_blocks(big, 9, "matmul", (40, 40, 40))
    phantom1 = (512, 228, 385)
    assert bsi_fused.lncc_blocks((5, 5, 5), 9, "matmul", phantom1) == ((25, 2, 4),
                                                                       (2, 2, 2))
    own, extra = bsi_fused.lncc_blocks((1, 1, 1), 9, "lerp", (40, 33, 47))
    assert extra == (8, 8, 8) and 1 <= min(own) and max(own) <= 128
    bsi_fused.block_tiles((5, 5, 5), "matmul", bsi_fused.nmi_smem_bytes(64))


# --- the separable and TT forward kernels' plain versions

# (tiles per axis, tile): grids of 2 to 6 tiles per axis; the paper's 5^3, a
# non-cubic tile and a tile of one voxel
FORM_GRIDS = [((2, 5, 3), (5, 5, 5)), ((6, 2, 4), (5, 5, 5)),
              ((2, 5, 3), (3, 4, 2)), ((6, 2, 4), (3, 4, 2)),
              ((2, 5, 3), (1, 1, 1)), ((6, 2, 4), (1, 1, 1))]
FORM_MODULES = {"separable": bsi_separable, "tt": bsi_tt}


@pytest.mark.parametrize("mode", ["separable", "tt"])
@pytest.mark.parametrize("tiles,tile", FORM_GRIDS)
@pytest.mark.parametrize("c", [1, 3])
def test_separable_and_tt_plain_match_reference_kernel(mode, tiles, tile, c):
    """Each kernel's plain version against the reference's Pallas kernel of
    the same mode in interpret mode, 1e-5 of the largest value."""
    phi = _phi(tuple(t + 3 for t in tiles), 30, c)
    full = tuple(t * d for t, d in zip(tiles, tile))
    out = FORM_MODULES[mode].plain(torch.from_numpy(phi), tile, full).numpy()
    ref = np.asarray(rops.bsi_pallas(jnp.asarray(phi), tile, mode=mode, interpret=True))
    assert out.shape == ref.shape == full + (c,)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["separable", "tt"])
@pytest.mark.parametrize("vol,tile", VOLUMES + [((9, 4, 13), (1, 1, 1))])
def test_separable_and_tt_crop_matches_reference_dense_field(mode, vol, tile):
    """The dispatchers on CPU tensors, cropped to volumes off the tile grid,
    against the reference's kernel path of ``dense_field``."""
    phi = _phi(rffd.grid_shape_for_volume(vol, tile), 31)
    out = ops.FORWARD_KERNELS[mode](torch.from_numpy(phi), tile, vol).numpy()
    ref = np.asarray(rffd.dense_field(jnp.asarray(phi), tile, vol, mode=mode,
                                      impl="pallas"))
    assert out.shape == vol + (3,)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["separable", "tt"])
def test_separable_and_tt_dispatchers_check_coverage_and_count_no_launch(mode):
    ops.reset_launch_counts()
    phi = torch.from_numpy(_phi((7, 6, 5)))
    with pytest.raises(ValueError, match="does not cover"):
        ops.FORWARD_KERNELS[mode](phi, (5, 4, 3), (21, 12, 6))
    out = ops.FORWARD_KERNELS[mode](phi, (5, 4, 3))
    assert out.shape == (20, 12, 6, 3)
    assert not any(ops.launch_counts().values())


def test_tt_plain_rounds_as_the_kernel():
    """The TT kernel (built without FMA contraction) adds ``acc + p * w`` with
    ``w = (wx * wy) * wz``, one term at a time in ``l, m, n`` order; its plain
    version must round the same way, so the two agree bit for bit on the
    card.  A float32 loop of the kernel's arithmetic over one tile checks it."""
    from repro_torch.core.bspline import weight_lut

    tile = (3, 4, 2)
    phi = torch.from_numpy(_phi((4, 4, 4), 32, 1))
    out = bsi_tt.plain(phi, tile, (3, 4, 2))
    wx, wy, wz = (weight_lut(d, torch.float32, "cpu") for d in tile)
    for a in range(3):
        for b in range(4):
            for c in range(2):
                acc = torch.zeros((), dtype=torch.float32)
                for k in range(64):
                    l, m, n = k >> 4, (k >> 2) & 3, k & 3
                    w = (wx[a, l] * wy[b, m]) * wz[c, n]
                    acc = acc + phi[l, m, n, 0] * w
                assert torch.equal(acc, out[a, b, c, 0])


def test_separable_staging_fits_the_blocks_of_the_ttli_kernel():
    """The separable kernel runs the TTLI kernel's device code in the TTLI
    kernel's blocks (``bsi_ttli.forward_blocks``), with 4 weights per voxel
    offset and axis where the TTLI kernel has 3 lerp values: ``sum(tile)``
    floats more of LUTs, read from device memory, and the same shared
    memory, within its budget at every tile the tests use."""
    from repro_torch.kernels import bsi_ttli

    for tile in ((5, 5, 5), (3, 4, 2), (1, 1, 1), (7, 7, 7)):
        geo = bsi_ttli.forward_blocks(tile, 3, (40, 33, 47))
        assert geo.smem <= bsi_ttli.FORWARD_SMEM_BYTES
        assert (bsi_separable.weight_luts(tile, "cpu").numel()
                - bsi_ttli.stage_luts(tile, "cpu").numel()) == sum(tile)
        tt = bsi_tt.tt_blocks(tile, 3, (40, 33, 47))
        assert tt.smem <= bsi_tt.TT_SMEM_BYTES and tt.slots == 63
