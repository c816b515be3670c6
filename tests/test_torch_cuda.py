"""The CUDA kernels on the card against their plain PyTorch versions.

Card-only: every test is marked ``gpu`` and skips where no CUDA device is
present (decided inside the ``cuda`` fixture, never at import).  On a machine
with an H100 and ``nvcc``:

    python -m pytest -q -m gpu tests/test_torch_cuda.py

This file imports no JAX: the card's machine runs the port alone.  The plain
versions are held against the JAX package by the other ``test_torch_*``
files on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import RegistrationOptions, ffd_register, make_pair  # noqa: E402
from repro_torch.core import ffd  # noqa: E402
from repro_torch.core.interpolate import bsi_gather, interpolate  # noqa: E402
from repro_torch.kernels import (bsi_adjoint, bsi_fused, bsi_matmul,  # noqa: E402
                                  bsi_separable, bsi_tt, bsi_ttli, flash_attention,
                                  ops)

pytestmark = pytest.mark.gpu

# (volume, tile): non-cubic tiles, volumes off the tile grid, a tile of 1
# (more than 48 KB of shared memory per block) and the paper's 5^3
CASES = [
    ((13, 11, 9), (5, 4, 3)),
    ((40, 33, 47), (5, 5, 5)),
    ((12, 11, 9), (3, 3, 3)),
    ((22, 15, 30), (7, 7, 7)),
    ((11, 12, 45), (1, 1, 1)),
]


def _launches(name):
    return ops.launch_counts()[name]


def _no_launches_but(**counts):
    """Every kernel's count 0 except ``counts``."""
    return {k: counts.get(k, 0) for k in ops.launch_counts()}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _grid(vol, tile, c, seed, device):
    rng = np.random.default_rng(seed)
    shape = ffd.grid_shape_for_volume(vol, tile) + (c,)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("vol,tile", CASES)
@pytest.mark.parametrize("c", [1, 3])
def test_ttli_kernel_matches_plain(cuda, vol, tile, c):
    phi = _grid(vol, tile, c, 0, cuda)
    before = _launches("bsi_ttli")
    out = ops.bsi_ttli(phi, tile, vol)
    torch.cuda.synchronize()
    assert _launches("bsi_ttli") == before + 1
    ref = bsi_ttli.plain(phi, tile, vol)
    assert out.shape == ref.shape == vol + (c,)
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("vol,tile", CASES)
@pytest.mark.parametrize("c", [1, 3, 4])
def test_adjoint_kernel_matches_plain(cuda, vol, tile, c):
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.standard_normal(vol + (c,)).astype(np.float32)).to(cuda)
    gshape = ffd.grid_shape_for_volume(vol, tile)
    before = _launches("bsi_adjoint")
    out = ops.bsi_adjoint(g, tile, gshape)
    torch.cuda.synchronize()
    assert _launches("bsi_adjoint") == before + 1
    ref = bsi_adjoint.plain(g, tile, gshape)
    assert out.shape == ref.shape == gshape + (c,)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# rows of Z*C floats and x planes of Y*Z*C floats that are not whole 16-byte
# chunks (39 and 273 floats at 3 channels), on the paper's tile (the
# kernel's build for it) and on another; and a volume whose z outputs, Nz*C,
# outnumber a block's threads (603 * 3 at tile (5, 5, 2))
UNALIGNED = [((21, 7, 13), (5, 5, 5)), ((21, 7, 13), (3, 4, 2))]
LONG_Z = ((6, 40, 1200), (5, 5, 2))


@pytest.mark.parametrize("vol,tile", UNALIGNED + [LONG_Z])
def test_adjoint_kernel_streams_unaligned_rows_and_long_z(cuda, vol, tile):
    c = 3
    geo = bsi_adjoint.stream_blocks(tile, c, vol, bsi_adjoint.card_sms(cuda))
    if (vol, tile) == LONG_Z:
        assert geo.zparts > 1 and geo.threads == 32 * bsi_adjoint.STREAM_MAX_WARPS
    else:
        assert vol[2] * c % 4 and vol[1] * vol[2] * c % 4
    g = _adjoint_input(vol, c, 34, cuda)
    gshape = ffd.grid_shape_for_volume(vol, tile)
    out = ops.bsi_adjoint(g, tile, gshape)
    torch.cuda.synchronize()
    ref = bsi_adjoint.plain(g, tile, gshape)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert torch.equal(out, ops.bsi_adjoint(g, tile, gshape))


@pytest.mark.parametrize("vol,tile", UNALIGNED)
def test_adjoint_kernel_reads_an_unaligned_view(cuda, vol, tile):
    """A contiguous view that starts off a 16-byte boundary and ends where
    its allocation ends: the row copies may begin before it, never after."""
    c = 3
    big = _adjoint_input((vol[0] + 1,) + vol[1:], c, 35, cuda)
    g = big[1:]
    assert g.is_contiguous() and g.data_ptr() % 16
    gshape = ffd.grid_shape_for_volume(vol, tile)
    out = ops.bsi_adjoint(g, tile, gshape)
    ref = bsi_adjoint.plain(g, tile, gshape)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("vol,tile", [CASES[1], LONG_Z])
def test_adjoint_kernel_allocates_only_the_partials(cuda, vol, tile):
    """Beyond its output a call allocates the runs' partials of hy, and no
    (X, Y, Nz, C) intermediate."""
    c = 3
    g = _adjoint_input(vol, c, 36, cuda)
    gshape = ffd.grid_shape_for_volume(vol, tile)
    ops.bsi_adjoint(g, tile, gshape)  # the LUTs, cached on the card
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ops.bsi_adjoint(g, tile, gshape)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before - 4 * out.numel()
    geo = bsi_adjoint.stream_blocks(tile, c, vol, bsi_adjoint.card_sms(cuda))
    partials = 4 * geo.partial_floats
    assert partials <= extra < partials + 1024
    assert extra < 4 * vol[0] * vol[1] * gshape[2] * c


@pytest.mark.parametrize("vol,tile", CASES)
def test_fused_kernel_matches_plain(cuda, vol, tile):
    rng = np.random.default_rng(2)
    phi = _grid(vol, tile, 3, 3, cuda) * 2.0
    mov, fix = (torch.from_numpy(rng.uniform(0, 1, vol).astype(np.float32)).to(cuda)
                for _ in range(2))
    before = _launches("bsi_fused")
    out = ops.fused_ssd_loss(phi, mov, fix, tile)
    assert _launches("bsi_fused") == before + 1
    ref = bsi_fused.plain(phi, mov, fix, tile) / mov.numel()
    assert abs(out.item() - ref.item()) <= 1e-5 * abs(ref.item())


def _fused_inputs(vol, tile, seed, device):
    rng = np.random.default_rng(seed)
    phi = _grid(vol, tile, 3, seed, device) * 2.0
    mov, fix = (torch.from_numpy(rng.uniform(0, 1, vol).astype(np.float32)).to(device)
                for _ in range(2))
    mov = torch.clamp(mov - 0.3, min=0.0)  # ties at the minimum, as in a phantom
    return phi, mov, fix


@pytest.mark.parametrize("vol,tile", CASES)
def test_stats_kernel_matches_plain(cuda, vol, tile):
    phi, mov, _ = _fused_inputs(vol, tile, 10, cuda)
    before = _launches("bsi_fused_stats")
    out = ops.fused_stats(phi, mov, tile)
    assert _launches("bsi_fused_stats") == before + 1
    ref = bsi_fused.plain_stats(phi, mov, tile)
    assert out.shape == (4,)
    assert torch.equal(out[1:], ref[1:])  # min, max, count: exact
    assert out[3].item() == mov.numel()
    assert abs(out[0].item() - ref[0].item()) <= 1e-5 * abs(ref[0].item())


@pytest.mark.parametrize("vol,tile", CASES)
def test_ncc_kernel_matches_plain(cuda, vol, tile):
    phi, mov, fix = _fused_inputs(vol, tile, 11, cuda)
    st = bsi_fused.plain_stats(phi, mov, tile)
    scal = torch.stack([st[0] / mov.numel(), fix.mean()])
    before = _launches("bsi_fused_ncc")
    out = ops.fused_ncc_moments(phi, mov, fix, scal, tile)
    assert _launches("bsi_fused_ncc") == before + 1
    ref = bsi_fused.plain_ncc(phi, mov, fix, scal, tile)
    assert out.shape == (3,)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# the nmi kernel stages 128 voxels a round: (21, 17, 13) holds 4641 voxels,
# its blocks of 2 x 2 x 8 tiles 4000 or fewer, none a multiple of 128
NMI_CASES = CASES + [((21, 17, 13), (5, 5, 5))]


@pytest.mark.parametrize("vol,tile", NMI_CASES)
@pytest.mark.parametrize("bins", [32, 16, 10, 2, 64])
@pytest.mark.parametrize("sigma_ratio", [0.5, 2.0])
@pytest.mark.parametrize("form", bsi_fused.DISP_FORMS)
def test_nmi_kernel_matches_plain(cuda, vol, tile, bins, sigma_ratio, form):
    """The histogram within 1e-5 of its largest cell: at sigma_ratio 0.5 the
    kernel evaluates 17 of 32 bins a voxel, at 2.0 all but the farthest."""
    phi, mov, fix = _fused_inputs(vol, tile, 12, cuda)
    st = bsi_fused.plain_stats(phi, mov, tile, disp_form=form)
    scal = torch.stack([st[1], st[2], fix.min(), fix.max()])
    kw = dict(bins=bins, sigma=sigma_ratio / (bins - 1), eps=1e-8, disp_form=form)
    name = "bsi_fused_nmi" + ("_matmul" if form == "matmul" else "")
    before = _launches(name)
    out = ops.fused_nmi_histogram(phi, mov, fix, scal, tile, **kw)
    assert _launches(name) == before + 1
    ref = bsi_fused.plain_nmi(phi, mov, fix, scal, tile, **kw)
    assert out.shape == (bins, bins)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert abs(out.sum().item() - mov.numel()) <= 1e-4 * mov.numel()


@pytest.mark.parametrize("spec", [("ncc",), ("nmi", 32, 0.5, 1e-8),
                                  ("nmi", 16, 0.5, 1e-8)])
def test_fused_similarity_loss_matches_cpu(cuda, spec):
    vol, tile = (40, 33, 47), (5, 5, 5)
    phi, mov, fix = _fused_inputs(vol, tile, 13, cuda)
    out = ops.fused_similarity_loss(phi, mov, fix, tile, sim_spec=spec)
    ref = ops.fused_similarity_loss(phi.cpu(), mov.cpu(), fix.cpu(), tile, sim_spec=spec)
    assert out.device.type == "cuda" and out.dim() == 0
    assert abs(out.item() - ref.item()) <= 1e-5 * abs(ref.item())


def test_stats_and_nmi_are_deterministic(cuda):
    vol, tile = (40, 33, 47), (5, 5, 5)
    phi, mov, fix = _fused_inputs(vol, tile, 14, cuda)
    st = [ops.fused_stats(phi, mov, tile) for _ in range(3)]
    scal = torch.stack([st[0][1], st[0][2], fix.min(), fix.max()])
    h = [ops.fused_nmi_histogram(phi, mov, fix, scal, tile, bins=32, sigma=0.5 / 31,
                                 eps=1e-8) for _ in range(3)]
    assert torch.equal(st[0], st[1]) and torch.equal(st[0], st[2])
    assert torch.equal(h[0], h[1]) and torch.equal(h[0], h[2])


# the ssd, stats and ncc kernels walk the forward kernels' blocks in both
# forms (tests/test_torch_fused_geometry.py): z off the tile, one-tile
# volumes, tall z over several blocks along z, fewer lines than warps
WALK_CASES = [((13, 11, 9), (5, 5, 5)), ((12, 11, 9), (5, 4, 3)), ((22, 15, 30), (3, 3, 3)),
              ((11, 12, 45), (7, 6, 5)), ((5, 4, 3), (5, 4, 3)), ((1, 1, 1), (5, 5, 5)),
              ((7, 6, 700), (5, 5, 5)), ((6, 7, 1500), (3, 3, 3))]


@pytest.mark.parametrize("form", bsi_fused.DISP_FORMS)
@pytest.mark.parametrize("vol,tile", WALK_CASES)
def test_walk_kernels_at_odd_volumes(cuda, vol, tile, form):
    """ssd, stats and ncc in ``form``: two calls bit-equal, min, max and count
    equal to the plain version's, the sums within 1e-5 relative; nmi on the
    same inputs still within its limit of its plain version."""
    phi, mov, fix = _fused_inputs(vol, tile, 16, cuda)
    kw = dict(disp_form=form)
    name = "" if form == "lerp" else "_matmul"
    before = {k: _launches(k + name) for k in ("bsi_fused", "bsi_fused_stats",
                                                "bsi_fused_ncc")}
    ssd = [ops.fused_ssd_loss(phi, mov, fix, tile, **kw) for _ in range(2)]
    st = [ops.fused_stats(phi, mov, tile, **kw) for _ in range(2)]
    assert torch.equal(ssd[0], ssd[1]) and torch.equal(st[0], st[1])
    ref = bsi_fused.plain(phi, mov, fix, tile, **kw) / mov.numel()
    assert abs(ssd[0].item() - ref.item()) <= 1e-5 * abs(ref.item())
    ref = bsi_fused.plain_stats(phi, mov, tile, **kw)
    assert torch.equal(st[0][1:], ref[1:]) and st[0][3].item() == mov.numel()
    assert abs(st[0][0].item() - ref[0].item()) <= 1e-5 * abs(ref[0].item())
    scal = torch.stack([ref[0] / mov.numel(), fix.mean()])
    ncc = [ops.fused_ncc_moments(phi, mov, fix, scal, tile, **kw) for _ in range(2)]
    assert torch.equal(ncc[0], ncc[1])
    want = bsi_fused.plain_ncc(phi, mov, fix, scal, tile, **kw)
    assert (ncc[0] - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert {k: _launches(k + name) - n for k, n in before.items()} == dict.fromkeys(before, 2)
    scal = torch.stack([ref[1], ref[2], fix.min(), fix.max()])
    nmi = dict(bins=32, sigma=0.5 / 31, eps=1e-8, **kw)
    out = ops.fused_nmi_histogram(phi, mov, fix, scal, tile, **nmi)
    want = bsi_fused.plain_nmi(phi, mov, fix, scal, tile, **nmi)
    assert (out - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("form", bsi_fused.DISP_FORMS)
def test_walk_layout_is_moment_blocks(cuda, form):
    """The library's walk lays a block out (its chunk and shared memory) as
    ``moment_blocks`` does, at the walk's odd volumes, phantom1 and its
    coarse level, at every tile the matrix form fits."""
    from repro_torch.kernels.build import load_library

    lib = load_library()
    cases = WALK_CASES + [((512, 228, 385), t) for t in ((5, 5, 5), (3, 3, 3), (7, 6, 5))]
    cases += [((256, 114, 193), (5, 5, 5))]
    for vol, tile in cases:
        grid = ffd.grid_shape_for_volume(vol, tile)
        blocks = bsi_fused.moment_blocks(tile, vol, form).tiles
        bsi_fused.check_walk_layout(
            lib, (*grid, *tile, *vol, *blocks, bsi_fused.DISP_FORMS.index(form)))


def test_nmi_dispatcher_refuses_more_bins_than_the_kernel_takes(cuda):
    vol, tile = (13, 11, 9), (5, 4, 3)
    phi, mov, fix = _fused_inputs(vol, tile, 15, cuda)
    scal = torch.stack([mov.min(), mov.max(), fix.min(), fix.max()])
    with pytest.raises(ValueError, match="bins"):
        ops.fused_nmi_histogram(phi, mov, fix, scal, tile, bins=bsi_fused.MAX_BINS + 1,
                                sigma=0.01, eps=1e-8)


def test_kernel_gradient_matches_autograd_of_gather(cuda):
    tile = (5, 4, 3)
    phi = _grid((20, 12, 15), tile, 3, 4, cuda).requires_grad_(True)
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((20, 12, 15, 3)).astype(np.float32))
    w = w.to(cuda)
    (g_kernel,) = torch.autograd.grad(
        (interpolate(phi, tile, mode="ttli", impl="cuda", grad_impl="cuda") * w).sum(),
        phi)
    (g_ref,) = torch.autograd.grad((bsi_gather(phi, tile) * w).sum(), phi)
    assert (g_kernel - g_ref).abs().max().item() <= 1e-5 * g_ref.abs().max().item()


def test_fused_sums_are_deterministic(cuda):
    vol, tile = (40, 33, 47), (5, 5, 5)
    phi = _grid(vol, tile, 3, 6, cuda)
    rng = np.random.default_rng(7)
    mov, fix = (torch.from_numpy(rng.uniform(0, 1, vol).astype(np.float32)).to(cuda)
                for _ in range(2))
    g = torch.from_numpy(rng.standard_normal(vol + (3,)).astype(np.float32)).to(cuda)
    gshape = ffd.grid_shape_for_volume(vol, tile)
    a = [ops.fused_ssd_loss(phi, mov, fix, tile).item() for _ in range(3)]
    b = [ops.bsi_adjoint(g, tile, gshape) for _ in range(2)]
    assert a[0] == a[1] == a[2]
    assert torch.equal(b[0], b[1])


def test_dispatchers_refuse_what_the_kernels_do_not_take(cuda):
    tile = (5, 5, 5)
    phi = _grid((10, 10, 10), tile, 3, 8, cuda)
    with pytest.raises(TypeError):
        ops.bsi_ttli(phi.double(), tile)
    with pytest.raises(ValueError):
        ops.bsi_ttli(phi.transpose(0, 1), tile)
    with pytest.raises(ValueError):
        ops.bsi_ttli(phi, tile, (11, 10, 10))  # grid covers only 10 voxels


def test_registration_on_card_matches_cpu(cuda):
    fixed, moving, _ = make_pair((28, 24, 20), seed=0, device="cpu")
    opts = RegistrationOptions(levels=2, iters=5, fused="on")
    ops.reset_launch_counts()
    card = ffd_register(fixed, moving, options=opts, device=cuda)
    counts = ops.launch_counts()
    host = ffd_register(fixed, moving, options=opts, device="cpu")
    steps = opts.levels * (opts.iters + 1)
    assert counts == _no_launches_but(bsi_ttli=steps + 1, bsi_adjoint=steps,
                                      bsi_fused=steps)
    np.testing.assert_allclose(card.losses, host.losses, rtol=1e-4)
    np.testing.assert_allclose(card.params.cpu().numpy(), host.params.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(card.warped.cpu().numpy(), host.warped.numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("similarity", ["nmi", "ncc"])
def test_multimodal_registration_on_card_matches_cpu(cuda, similarity):
    fixed, moving, _ = make_pair((28, 24, 20), seed=0, device="cpu")
    remapped = (1.0 - moving) ** 1.5
    opts = RegistrationOptions(levels=2, iters=5, similarity=similarity, fused="on")
    ops.reset_launch_counts()
    card = ffd_register(fixed, remapped, options=opts, device=cuda)
    counts = ops.launch_counts()
    host = ffd_register(fixed, remapped, options=opts, device="cpu")
    steps = opts.levels * (opts.iters + 1)
    assert counts == _no_launches_but(bsi_ttli=steps + 1, bsi_adjoint=steps,
                                      bsi_fused_stats=steps,
                                      **{f"bsi_fused_{similarity}": steps})
    np.testing.assert_allclose(card.losses, host.losses, rtol=1e-4)


# --- the matrix form and the fused LNCC


@pytest.mark.parametrize("vol,tile", CASES)
@pytest.mark.parametrize("c", [1, 3])
def test_matmul_kernel_matches_plain(cuda, vol, tile, c):
    phi = _grid(vol, tile, c, 20, cuda)
    before = _launches("bsi_matmul")
    out = ops.bsi_matmul(phi, tile, vol)
    torch.cuda.synchronize()
    assert _launches("bsi_matmul") == before + 1
    ref = bsi_matmul.plain(phi, tile, vol)
    assert out.shape == ref.shape == vol + (c,)
    assert (out - ref).abs().max().item() <= 1e-5
    assert (out - bsi_ttli.plain(phi, tile, vol)).abs().max().item() <= 1e-5
    assert torch.equal(out, ops.bsi_matmul(phi, tile, vol))  # two calls bit-equal


# the matrix-form kernel's other geometries: phantom1's coarse level (3
# chunks of z tiles a row), 5 and 40 channels (9 and 1 z tiles a unit, the
# any-channel build), a 10^3 tile (63 m tiles: A reloaded per unit) and a
# 1^3 tile at 7 channels (8 warps share its one m tile)
MATMUL_GEOMETRIES = [((256, 114, 192), (5, 5, 5), 3), ((40, 33, 47), (5, 5, 5), 5),
                     ((13, 11, 9), (5, 4, 3), 40), ((23, 20, 31), (10, 10, 10), 3),
                     ((11, 12, 45), (1, 1, 1), 7)]


@pytest.mark.parametrize("vol,tile,c", MATMUL_GEOMETRIES)
def test_matmul_kernel_geometries_match_plain(cuda, vol, tile, c):
    geo = bsi_matmul.matmul_blocks(tile, c, vol)
    if c == 5:
        assert geo.z_tiles == 9 < 16
    phi = _grid(vol, tile, c, 30, cuda) * 2.5
    out = ops.bsi_matmul(phi, tile, vol)
    ref = bsi_matmul.plain(phi, tile, vol)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == vol + (c,)
    assert (out - ref).abs().max().item() <= 1e-5
    assert torch.equal(out, ops.bsi_matmul(phi, tile, vol))


@pytest.mark.parametrize("vol,tile", [((40, 33, 47), (5, 5, 5)), ((256, 114, 192), (5, 5, 5))])
def test_matmul_kernel_error_against_float64(cuda, vol, tile, record_property):
    """The kernel's largest error against the float64 function beside
    plain's own (3xTF32 on the tensor cores against 64 rounded float32
    products and adds), each within the 1e-5 the kernel is held to."""
    phi = _grid(vol, tile, 3, 31, cuda) * 2.5
    exact = bsi_matmul.exact(phi, tile, vol)
    k_err = (ops.bsi_matmul(phi, tile, vol).double() - exact).abs().max().item()
    p_err = (bsi_matmul.plain(phi, tile, vol).double() - exact).abs().max().item()
    record_property("kernel_f64_err", k_err)
    record_property("plain_f64_err", p_err)
    print(f"{vol}: max |kernel - f64| {k_err:.3e}, max |plain - f64| {p_err:.3e}")
    assert k_err <= 1e-5 and p_err <= 1e-5


@pytest.mark.parametrize("vol,tile", CASES)
@pytest.mark.parametrize("c", [1, 3])
def test_adjoint_matmul_kernel_matches_plain(cuda, vol, tile, c):
    rng = np.random.default_rng(21)
    g = torch.from_numpy(rng.standard_normal(vol + (c,)).astype(np.float32)).to(cuda)
    gshape = ffd.grid_shape_for_volume(vol, tile)
    before = _launches("bsi_adjoint_matmul")
    out = ops.bsi_adjoint_matmul(g, tile, gshape)
    torch.cuda.synchronize()
    assert _launches("bsi_adjoint_matmul") == before + 1
    ref = bsi_adjoint.plain_matmul(g, tile, gshape)
    assert out.shape == ref.shape == gshape + (c,)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# a grid of several boxes in every axis, ragged at the volume's edge
SPANNING = ((83, 61, 97), (5, 4, 3))


def _adjoint_input(vol, c, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(vol + (c,)).astype(np.float32)).to(device)


def test_adjoint_matmul_kernel_spans_boxes(cuda):
    (vol, tile), c = SPANNING, 3
    geo = bsi_adjoint.matmul_blocks(tile, c, vol)
    tiles = [-(-s // d) for s, d in zip(vol, tile)]
    assert min(geo.boxes) >= 2 and any(n * b > t for n, b, t in
                                       zip(geo.boxes, geo.box, tiles)), geo
    g = _adjoint_input(vol, c, 30, cuda)
    gshape = ffd.grid_shape_for_volume(vol, tile)
    out = ops.bsi_adjoint_matmul(g, tile, gshape)
    torch.cuda.synchronize()
    for ref in (bsi_adjoint.plain_matmul(g, tile, gshape),
                bsi_adjoint.plain_matmul_blocked(g, tile, gshape)):
        assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_adjoint_matmul_kernel_reads_an_unaligned_view(cuda):
    """The kernel stages the cotangent in 16-byte chunks: a contiguous view
    that starts off a 16-byte boundary, and whose last row ends off one."""
    (vol, tile), c = SPANNING, 3
    big = _adjoint_input((vol[0] + 2,) + vol[1:], c, 33, cuda)
    g = big[2:]  # ends where its allocation ends
    assert g.is_contiguous() and g.data_ptr() % 16 and (g.data_ptr() + 4 * g.numel()) % 16
    gshape = ffd.grid_shape_for_volume(vol, tile)
    out = ops.bsi_adjoint_matmul(g, tile, gshape)
    ref = bsi_adjoint.plain_matmul(g, tile, gshape)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("vol,tile", [SPANNING, CASES[1]])
def test_adjoint_matmul_kernel_is_deterministic(cuda, vol, tile):
    g = _adjoint_input(vol, 3, 31, cuda)
    gshape = ffd.grid_shape_for_volume(vol, tile)
    a, b = (ops.bsi_adjoint_matmul(g, tile, gshape) for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("vol,tile", [SPANNING, CASES[1]])
def test_adjoint_matmul_kernel_allocates_less_than_the_bands(cuda, vol, tile):
    """Beyond its output a call allocates its partials, less than the
    ``tiles x C x 64`` band sums an earlier design kept in device memory."""
    c = 3
    g = _adjoint_input(vol, c, 32, cuda)
    gshape = ffd.grid_shape_for_volume(vol, tile)
    ops.bsi_adjoint_matmul(g, tile, gshape)  # the basis, cached on the card
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ops.bsi_adjoint_matmul(g, tile, gshape)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before - 4 * out.numel()
    tiles = np.prod([-(-s // d) for s, d in zip(vol, tile)])
    assert extra < tiles * c * 64 * 4
    assert extra >= 4 * bsi_adjoint.matmul_blocks(tile, c, vol).partial_floats


@pytest.mark.parametrize("vol,tile", CASES)
def test_fused_matmul_form_matches_plain(cuda, vol, tile):
    """The four earlier variants with the matrix-form displacement; the warp
    equals the plain version bit for bit, so stats' min, max and count are
    exact."""
    phi, mov, fix = _fused_inputs(vol, tile, 22, cuda)
    kw = dict(disp_form="matmul")
    out = ops.fused_stats(phi, mov, tile, **kw)
    ref = bsi_fused.plain_stats(phi, mov, tile, **kw)
    assert torch.equal(out[1:], ref[1:])
    assert abs(out[0].item() - ref[0].item()) <= 1e-5 * abs(ref[0].item())
    out = ops.fused_ssd_loss(phi, mov, fix, tile, **kw)
    ref = bsi_fused.plain(phi, mov, fix, tile, **kw) / mov.numel()
    assert abs(out.item() - ref.item()) <= 1e-5 * abs(ref.item())
    scal = torch.tensor([0.3, 0.5], device=cuda)
    out = ops.fused_ncc_moments(phi, mov, fix, scal, tile, **kw)
    ref = bsi_fused.plain_ncc(phi, mov, fix, scal, tile, **kw)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    st = bsi_fused.plain_stats(phi, mov, tile, **kw)
    scal = torch.stack([st[1], st[2], fix.min(), fix.max()])
    nmi = dict(bins=32, sigma=0.5 / 31, eps=1e-8, **kw)
    out = ops.fused_nmi_histogram(phi, mov, fix, scal, tile, **nmi)
    ref = bsi_fused.plain_nmi(phi, mov, fix, scal, tile, **nmi)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# the lncc kernel marches along x in chunks of at most 128 voxels: volumes
# whose x spans 2 to 5 chunks (the CASES are shorter than one)
LNCC_MARCH_CASES = [((300, 20, 24), (5, 5, 5)), ((260, 13, 21), (5, 4, 3))]


@pytest.mark.parametrize("form", ["lerp", "matmul"])
@pytest.mark.parametrize("window", [9, 5, 1])
@pytest.mark.parametrize("vol,tile", CASES + LNCC_MARCH_CASES)
def test_lncc_kernel_matches_plain(cuda, vol, tile, window, form):
    phi, mov, fix = _fused_inputs(vol, tile, 23, cuda)
    w = ops.lncc_window(window, vol)
    name = "bsi_fused_lncc" + ("_matmul" if form == "matmul" else "")
    before = _launches(name)
    out = ops.fused_lncc(phi, mov, fix, tile, window=window, eps=1e-5, disp_form=form)
    assert _launches(name) == before + 1
    ref = bsi_fused.plain_lncc(phi, mov, fix, tile, window=w, eps=1e-5, disp_form=form)
    assert out.shape == (2,)
    assert out[1].item() == ref[1].item() == np.prod([s - w + 1 for s in vol])
    assert abs(out[0].item() - ref[0].item()) <= 1e-5 * abs(ref[0].item())


def test_matmul_kernels_and_lncc_are_deterministic(cuda):
    vol, tile = (40, 33, 47), (5, 5, 5)
    phi, mov, fix = _fused_inputs(vol, tile, 24, cuda)
    rng = np.random.default_rng(25)
    g = torch.from_numpy(rng.standard_normal(vol + (3,)).astype(np.float32)).to(cuda)
    gshape = ffd.grid_shape_for_volume(vol, tile)
    runs = [(ops.bsi_matmul(phi, tile, vol), ops.bsi_adjoint_matmul(g, tile, gshape),
             ops.fused_lncc(phi, mov, fix, tile, window=9, eps=1e-5),
             ops.fused_lncc(phi, mov, fix, tile, window=9, eps=1e-5, disp_form="matmul"),
             ops.fused_stats(phi, mov, tile, disp_form="matmul")) for _ in range(3)]
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0], runs[2]):
        assert torch.equal(a, b)


def test_matmul_kernel_gradient_matches_autograd_of_gather(cuda):
    tile = (5, 4, 3)
    phi = _grid((20, 12, 15), tile, 3, 26, cuda).requires_grad_(True)
    rng = np.random.default_rng(27)
    w = torch.from_numpy(rng.standard_normal((20, 12, 15, 3)).astype(np.float32))
    w = w.to(cuda)
    (g_kernel,) = torch.autograd.grad((interpolate(
        phi, tile, mode="matmul", impl="cuda", grad_impl="matmul") * w).sum(), phi)
    (g_ref,) = torch.autograd.grad((bsi_gather(phi, tile) * w).sum(), phi)
    assert (g_kernel - g_ref).abs().max().item() <= 1e-5 * g_ref.abs().max().item()


def test_matmul_dispatchers_refuse_what_the_kernels_do_not_take(cuda):
    tile = (5, 5, 5)
    phi = _grid((10, 10, 10), tile, 3, 28, cuda)
    with pytest.raises(TypeError):
        ops.bsi_matmul(phi.double(), tile)
    with pytest.raises(ValueError):
        ops.bsi_adjoint_matmul(phi.transpose(0, 1), tile, (6, 6, 6))
    big = (10, 10, 10)  # 40 channels: one z tile's runs exceed a block's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        ops.bsi_matmul(_grid((20, 20, 20), big, 40, 29, cuda), big)
    # the fused kernel's 256 KB basis: more than a block's shared memory
    phi = _grid((20, 20, 20), big, 3, 29, cuda)
    v = torch.zeros((20, 20, 20), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.fused_lncc(phi, v, v, big, window=9, eps=1e-5, disp_form="matmul")


def test_lncc_matmul_registration_on_card_matches_cpu(cuda):
    fixed, moving, _ = make_pair((28, 24, 20), seed=0, device="cpu")
    opts = RegistrationOptions(levels=2, iters=5, similarity="lncc", mode="matmul",
                               grad_impl="matmul", fused="on")
    ops.reset_launch_counts()
    card = ffd_register(fixed, moving, options=opts, device=cuda)
    counts = ops.launch_counts()
    host = ffd_register(fixed, moving, options=opts, device="cpu")
    steps = opts.levels * (opts.iters + 1)
    assert counts == _no_launches_but(bsi_matmul=steps + 1, bsi_adjoint_matmul=steps,
                                      bsi_fused_lncc_matmul=steps)
    np.testing.assert_allclose(card.losses, host.losses, rtol=1e-4)
    np.testing.assert_allclose(card.warped.cpu().numpy(), host.warped.numpy(),
                               atol=1e-4)


# --- the separable and TT forward kernels


@pytest.mark.parametrize("mode", ["separable", "tt"])
@pytest.mark.parametrize("vol,tile", CASES)
@pytest.mark.parametrize("c", [1, 3])
def test_separable_and_tt_kernels_match_plain(cuda, vol, tile, c, mode):
    """Within 1e-5 of the largest value; the TT kernel, built without FMA
    contraction, equals its plain version bit for bit."""
    module = {"separable": bsi_separable, "tt": bsi_tt}[mode]
    phi = _grid(vol, tile, c, 40, cuda)
    before = _launches(f"bsi_{mode}")
    out = ops.FORWARD_KERNELS[mode](phi, tile, vol)
    torch.cuda.synchronize()
    assert _launches(f"bsi_{mode}") == before + 1
    ref = module.plain(phi, tile, vol)
    assert out.shape == ref.shape == vol + (c,)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    if mode == "tt":
        assert torch.equal(out, ref)


@pytest.mark.parametrize("mode", ["separable", "tt"])
def test_separable_and_tt_kernels_at_phantom1(cuda, mode):
    """At the grid of the paper's phantom1 volume, cropped to it."""
    module = {"separable": bsi_separable, "tt": bsi_tt}[mode]
    vol, tile = (512, 228, 385), (5, 5, 5)
    phi = _grid(vol, tile, 3, 41, cuda) * 2.5
    out = ops.FORWARD_KERNELS[mode](phi, tile, vol)
    ref = module.plain(phi, tile, vol)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    if mode == "tt":
        assert torch.equal(out, ref)


@pytest.mark.parametrize("mode", ["separable", "tt"])
def test_separable_and_tt_kernel_gradients_match_autograd_of_gather(cuda, mode):
    tile = (5, 4, 3)
    phi = _grid((20, 12, 15), tile, 3, 42, cuda).requires_grad_(True)
    rng = np.random.default_rng(43)
    w = torch.from_numpy(rng.standard_normal((20, 12, 15, 3)).astype(np.float32))
    w = w.to(cuda)
    (g_kernel,) = torch.autograd.grad((interpolate(
        phi, tile, mode=mode, impl="cuda", grad_impl="cuda") * w).sum(), phi)
    (g_ref,) = torch.autograd.grad((bsi_gather(phi, tile) * w).sum(), phi)
    assert (g_kernel - g_ref).abs().max().item() <= 1e-5 * g_ref.abs().max().item()


def test_separable_and_tt_kernels_are_deterministic(cuda):
    vol, tile = (40, 33, 47), (5, 5, 5)
    phi = _grid(vol, tile, 3, 44, cuda)
    for mode in ("separable", "tt"):
        a, b = (ops.FORWARD_KERNELS[mode](phi, tile, vol) for _ in range(2))
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["separable", "tt"])
def test_separable_and_tt_registration_on_card_matches_cpu(cuda, mode):
    fixed, moving, _ = make_pair((28, 24, 20), seed=0, device="cpu")
    opts = RegistrationOptions(levels=2, iters=5, mode=mode, fused="on")
    ops.reset_launch_counts()
    card = ffd_register(fixed, moving, options=opts, device=cuda)
    counts = ops.launch_counts()
    host = ffd_register(fixed, moving, options=opts, device="cpu")
    steps = opts.levels * (opts.iters + 1)
    assert counts == _no_launches_but(bsi_adjoint=steps, bsi_fused=steps,
                                      **{f"bsi_{mode}": steps + 1})
    np.testing.assert_allclose(card.losses, host.losses, rtol=1e-4)
    np.testing.assert_allclose(card.warped.cpu().numpy(), host.warped.numpy(),
                               atol=1e-4)


# --- the TT kernel's blocks (kernels.bsi_tt.tt_blocks): slots of several
# rows a block, column parts at the coarse level, many slots a row, and past
# 256 channels each thread's own stores


@pytest.mark.parametrize("vol,tile,c", [
    ((256, 114, 192), (5, 5, 5), 3),  # the main path's coarse level: 4 column parts
    ((13, 11, 9), (5, 4, 3), 3),
    ((22, 15, 30), (5, 4, 3), 2),
    ((7, 6, 700), (5, 5, 5), 4),  # 560 slots a row, more than a block's threads
    ((6, 7, 1500), (3, 3, 3), 1),
    ((11, 12, 45), (7, 6, 5), 1),
    ((1, 1, 1), (3, 3, 3), 3),
    ((12, 11, 9), (2, 2, 10), 3),  # z offsets summed in chunks of 8
    ((13, 11, 9), (5, 4, 3), 300),  # more channels than threads: direct stores
])
def test_tt_kernel_equals_plain_at_odd_shapes(cuda, vol, tile, c):
    """Bit for bit equal to the plain version, every value written (the
    output starts as NaN), one launch counted, two calls bit-equal."""
    phi = _grid(vol, tile, c, 48, cuda) * 2.5
    out = torch.full(vol + (c,), float("nan"), device=cuda)
    before = _launches("bsi_tt")
    bsi_tt.launch(phi, out, tile)
    again = ops.bsi_tt(phi, tile, vol)
    torch.cuda.synchronize()
    assert _launches("bsi_tt") == before + 1
    assert torch.equal(out, bsi_tt.plain(phi, tile, vol))
    assert torch.equal(out, again)


# --- the staged forward kernels' blocks (kernels.bsi_ttli.forward_blocks)

# odd volumes at the tiles of tests/test_torch_forward_geometry.py: z off the
# block, one-tile volumes, several blocks along z, threads split into groups
FORWARD_CASES = [
    ((13, 11, 9), (5, 5, 5)),
    ((22, 15, 30), (5, 4, 3)),
    ((12, 11, 9), (3, 3, 3)),
    ((11, 12, 45), (7, 6, 5)),
    ((5, 4, 3), (5, 4, 3)),
    ((1, 1, 1), (3, 3, 3)),
    ((7, 6, 700), (5, 5, 5)),
    ((6, 7, 1500), (3, 3, 3)),
]


@pytest.mark.parametrize("name", ["bsi_ttli", "bsi_separable"])
@pytest.mark.parametrize("vol,tile", FORWARD_CASES)
@pytest.mark.parametrize("c", [1, 3, 2])
def test_forward_kernels_match_plain_at_odd_shapes(cuda, name, vol, tile, c):
    """Within 1e-5 of the largest value, one launch, every voxel written
    (the output starts as NaN), two calls bit-equal; 3 channels run the
    kernels' fixed-channel instantiation, 1 and 2 the general one."""
    module = {"bsi_ttli": bsi_ttli, "bsi_separable": bsi_separable}[name]
    phi = _grid(vol, tile, c, 45, cuda)
    out = torch.full(vol + (c,), float("nan"), device=cuda)
    before = _launches(name)
    module.launch(phi, out, tile)
    again = getattr(ops, name)(phi, tile, vol)
    torch.cuda.synchronize()
    assert _launches(name) == before + 1
    ref = module.plain(phi, tile, vol)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert torch.equal(out, again)


@pytest.mark.parametrize("name", ["bsi_ttli", "bsi_separable"])
def test_forward_kernels_at_phantom1_are_deterministic(cuda, name):
    """At phantom1's grid, cropped to it: within 1e-5 of the largest plain
    value, two calls bit-equal."""
    module = {"bsi_ttli": bsi_ttli, "bsi_separable": bsi_separable}[name]
    vol, tile = (512, 228, 385), (5, 5, 5)
    phi = _grid(vol, tile, 3, 46, cuda) * 2.5
    a, b = (getattr(ops, name)(phi, tile, vol) for _ in range(2))
    ref = module.plain(phi, tile, vol)
    assert (a - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert torch.equal(a, b)


def test_forward_kernels_refuse_a_tile_that_does_not_fit(cuda):
    """A 70 x 70 tile's y-stage values exceed a block's shared memory: both
    dispatchers raise before launching."""
    tile, vol = (70, 70, 5), (140, 140, 40)
    phi = _grid(vol, tile, 3, 47, cuda)
    counts = ops.launch_counts()
    for name in ("bsi_ttli", "bsi_separable"):
        with pytest.raises(ValueError, match="shared memory"):
            getattr(ops, name)(phi, tile, vol)
    assert ops.launch_counts() == counts


def test_auto_options_on_card_race_the_kernels(cuda, tmp_path, monkeypatch):
    """All-"auto" options on a small pair: the race times all 12 kernel
    triples, the call runs the winner's kernels only, and a fresh resolve
    reads the disk cache without a race."""
    from repro_torch.engine import autotune

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "cache.json"))
    fixed, moving, _ = make_pair((28, 24, 20), seed=0, device="cpu")
    opts = RegistrationOptions(levels=2, iters=5, mode="auto", impl="auto",
                               grad_impl="auto", fused="auto")
    autotune.RACES.clear()
    resolved = autotune.resolve_options(opts, (28, 24, 20), cuda)
    (bsi_race, *_) = autotune.RACES
    # the card's pool is the kernel triples: no plain form is timed
    assert len(bsi_race.timings) == 12
    assert all(name.split("/")[1] == "cuda" and us is not None and us > 0
               for name, us in bsi_race.timings)
    assert resolved.impl == "cuda"
    assert resolved.fused in ("on", "off") and "race" in resolved.fused_reason
    ops.reset_launch_counts()
    ffd_register(fixed, moving, options=opts, device=cuda)
    steps = opts.levels * (opts.iters + 1)
    # each step's forward, and the final warp's
    expected = {f"bsi_{resolved.mode}": steps + 1}
    if resolved.grad_impl in ("cuda", "matmul"):
        expected[{"cuda": "bsi_adjoint", "matmul": "bsi_adjoint_matmul"}[
            resolved.grad_impl]] = steps
    if resolved.fused == "on":
        fused = "bsi_fused_matmul" if resolved.mode == "matmul" else "bsi_fused"
        expected[fused] = steps
    assert ops.launch_counts() == _no_launches_but(**expected)
    n_races = len(autotune.RACES)
    autotune._MEM_CACHE.clear()
    autotune.resolve_options.cache_clear()
    assert autotune.resolve_options(opts, (28, 24, 20), cuda) == resolved
    assert len(autotune.RACES) == n_races


# ------------------------------------------------------------ flash attention

# (B, S, H, KV, hd): MHA, GQA 4:1 and 2:1, MQA; ragged S (not a multiple of 64)
FLASH_SHAPES = [
    (2, 128, 4, 4, 16),
    (1, 200, 8, 2, 64),
    (2, 96, 4, 1, 128),
    (1, 330, 8, 4, 256),
]
FLASH_MASKS = [dict(causal=True), dict(causal=False), dict(causal=True, window=40),
               dict(causal=False, window=40), dict(causal=True, softcap=50.0),
               dict(causal=True, window=64, softcap=30.0)]


def _flash_inputs(shape, dtype, device, seed=0, exact_scores=False):
    """Normal q, k, v; with ``exact_scores``, q and k on the quarter-integers
    of [-4, 4] (exact in bf16), where every partial sum of ``q . k`` is exact
    in float32, so the kernel's tensor cores and the twin's einsum, which sum
    in other orders, give the same scores bit for bit."""
    B, S, H, KV, hd = shape
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g, device=device)
               for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    if exact_scores:
        q, k = ((4 * t).round().clamp(-16, 16) / 4 for t in (q, k))
    return tuple(t.to(dtype) for t in (q, k, v))


def _flash_close(out, ref, kind, v):
    """float32: 2e-5 (the reference's own flash tolerance), whatever ``kind``.
    bf16 against the rounding twin (``kind="twin"``, ``plain(...,
    block=KEY_BLOCK, p_dtype=torch.bfloat16)``, which rounds as the kernel
    does): on inputs whose scores are exact (``_flash_inputs(...,
    exact_scores=True)``) the float32 results differ by the order of the
    sums of ``l`` and ``P V`` only, so each value is at most one bf16 step
    from the twin's.  bf16 against ``plain`` (``kind="plain"``, float32 ``p``
    as the TPU kernel): one step and ``2^-8 max|v|``, the most that rounding
    ``p`` to bf16 can move an output (``|sum p_i d_i v_i| / l`` with
    ``|d_i| <= 2^-8``)."""
    assert out.shape == ref.shape and out.dtype == ref.dtype
    o, r = out.float(), ref.float()
    if out.dtype == torch.float32:
        assert (o - r).abs().max().item() <= 2e-5
        return
    bound = 2.0**-7 * torch.maximum(o.abs(), r.abs()) + 1e-5
    if kind == "plain":
        bound = bound + 2.0**-8 * v.float().abs().max()
    else:
        assert kind == "twin", kind
    assert ((o - r).abs() <= bound).all(), (kind, (o - r).abs().max().item())


def _flash_check(shape, dtype, device, seed=0, **mask):
    """The kernel on normal inputs against ``plain``, counted; in bf16 also
    on exact-score inputs against the rounding twin and ``plain``."""
    q, k, v = _flash_inputs(shape, dtype, device, seed)
    before = _launches("flash_attention")
    out = ops.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert _launches("flash_attention") == before + 1
    _flash_close(out, flash_attention.plain(q, k, v, **mask), "plain", v)
    if dtype == torch.bfloat16:
        q, k, v = _flash_inputs(shape, dtype, device, seed, exact_scores=True)
        out = ops.flash_attention(q, k, v, **mask)
        _flash_close(out, flash_attention.plain(
            q, k, v, block=flash_attention.KEY_BLOCK, p_dtype=torch.bfloat16, **mask),
            "twin", v)
        _flash_close(out, flash_attention.plain(q, k, v, **mask), "plain", v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", FLASH_MASKS, ids=lambda m: "-".join(
    f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_kernel_matches_plain(cuda, shape, mask, dtype):
    _flash_check(shape, dtype, cuda, **mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_ragged_second_query_block(cuda, dtype):
    """200 rows at head dim 256: the bf16 kernel's second 128-row block holds
    72 rows, so its second consumer warpgroup has 8 rows and the TMA store
    clips 56."""
    _flash_check((1, 200, 8, 2, 256), dtype, cuda, seed=2, causal=True, window=40,
                 softcap=30.0)


@pytest.mark.parametrize("S", [130, 257])
def test_flash_bf16_kernel_idle_consumer_and_head_dim_32(cuda, S):
    """A last 128-row block of 2 or 1 rows: its second consumer warpgroup has
    no rows and only releases the key blocks; head dim 32 (the 64-byte
    swizzle)."""
    _flash_check((2, S, 4, 2, 32), torch.bfloat16, cuda, seed=3, causal=True)
    _flash_check((2, S, 4, 2, 32), torch.bfloat16, cuda, seed=4, causal=False, window=70)


@pytest.fixture(scope="module")
def fresh_build(tmp_path_factory):
    """The kernels built anew into a temporary library: ptxas's lines are
    kept only by the build that ran in this process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import build

    return build._build(tmp_path_factory.mktemp("kernels") / "librepro_torch_kernels.so")


def test_walk_kernels_do_not_spill(fresh_build):
    """ptxas's line for each (form, moment) instantiation of the walk, named
    by ``bsi_fused.occupancy_key``: no spill stores or loads."""
    for form in bsi_fused.DISP_FORMS:
        for kind in ("ssd", "stats", "ncc"):
            symbol, _, _ = bsi_fused.occupancy_key(kind, form, (5, 5, 5), (512, 228, 385))
            lines = [ln for ln in fresh_build.ptxas if symbol in ln and "registers" in ln]
            assert len(lines) == 1, (symbol, fresh_build.ptxas)
            assert "0/0 B spill stores/loads" in lines[0], lines


def test_flash_bf16_kernel_does_not_spill(fresh_build):
    """ptxas's line for each head dim of the bf16 entry: no spill stores or
    loads (the consumers hold the 64 x hd float32 accumulator in registers)."""
    lines = [ln for ln in fresh_build.ptxas if "flash_sm90_kernel" in ln
             and "registers" in ln]
    assert len(lines) == len(flash_attention.HEAD_DIMS), fresh_build.ptxas
    assert all("0/0 B spill stores/loads" in ln for ln in lines), lines
    assert not [ln for ln in fresh_build.ptxas if "Performance Loss" in ln
                and "flash_sm90_kernel" in ln]  # no wgmma serialised


def test_flash_f32_kernel_does_not_spill(fresh_build):
    """ptxas's line for each head dim of the float32 entry: no spill stores
    or loads (the warps hold the 16 x hd float32 accumulator in registers)."""
    lines = [ln for ln in fresh_build.ptxas if "flash_tf32_kernel" in ln
             and "registers" in ln]
    assert len(lines) == len(flash_attention.HEAD_DIMS), fresh_build.ptxas
    assert all("0/0 B spill stores/loads" in ln for ln in lines), lines


def test_flash_bf16_kernel_runs_on_the_tensor_cores(fresh_build):
    """``cuobjdump -sass``: each head dim of the bf16 entry holds HGMMA
    (wgmma) instructions, and each head dim of the float32 entry HMMA
    (mma.sync TF32) instructions: both kernels compute on the tensor cores."""
    from repro_torch.kernels.build import sass_counts

    hgmma = sass_counts(fresh_build.path, "flash_sm90_kernel", "HGMMA")
    assert len(hgmma) == len(flash_attention.HEAD_DIMS) and all(hgmma.values()), hgmma
    hmma = sass_counts(fresh_build.path, "flash_tf32_kernel", "HMMA")
    assert len(hmma) == len(flash_attention.HEAD_DIMS) and all(hmma.values()), hmma


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_is_deterministic(cuda, dtype):
    q, k, v = _flash_inputs((2, 300, 8, 4, 256), dtype, cuda, seed=1)
    a, b = (ops.flash_attention(q, k, v, window=64, softcap=50.0) for _ in range(2))
    assert torch.equal(a, b)


def test_flash_dispatcher_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _flash_inputs((1, 64, 4, 2, 48), torch.float32, cuda)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q, k, v)
    q, k, v = _flash_inputs((1, 64, 4, 2, 64), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half())


def test_generate_on_card_matches_cpu(cuda):
    """gemma2-2b's smoke config in float32 with a float32 cache: the card
    (flash kernel in prefill) against the CPU (its plain version), 48-token
    prompts."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.training.steps import make_prefill_step

    cfg = dataclasses.replace(get_config("gemma2-2b", smoke=True), dtype="float32",
                              kv_cache_dtype="float32")
    host = M.init_model(cfg, seed=0, device="cpu")
    card = M.DecoderLM(cfg, M.map_tree(lambda t: t.to(cuda), host.tree()))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 48))
    ops.reset_launch_counts()
    toks, cache = serve.generate(cfg, card, prompts, 60, 8)
    assert ops.launch_counts() == _no_launches_but(flash_attention=cfg.num_layers)
    ref_toks, ref_cache = serve.generate(cfg, host, prompts, 60, 8)
    np.testing.assert_array_equal(toks.cpu().numpy(), ref_toks.numpy())
    np.testing.assert_allclose(cache["k"].cpu().numpy(), ref_cache["k"].numpy(),
                               atol=1e-4)
    batch = {"tokens": torch.as_tensor(prompts)}
    logits, _ = make_prefill_step(cfg, card)({"tokens": batch["tokens"].to(cuda)})
    ref, _ = make_prefill_step(cfg, host)(batch)
    np.testing.assert_allclose(logits.cpu().numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)
