"""The bf16 matrix and TT forms against the JAX package's, on the CPU.

Under ``compute_dtype="bfloat16"`` the card runs ``bsi_tt_bf16``,
``bsi_matmul_bf16``, ``bsi_adjoint_matmul_bf16`` and the fused kernels'
matrix form on bf16 ``phi`` and ``moving``.  Here their plain versions,
which the card holds the kernels to, follow the contract of
``core.interpolate`` (the grid widened, the LUTs or basis rounded to bf16
and widened, float32 sums, one rounding to bf16), and run against the JAX
package's Pallas kernels in interpret mode on seeded numpy inputs handed to
both packages; the kernels' store geometry at 2 bytes a value is written out
in pure arithmetic (the twins of ``test_torch_tt_geometry.py`` and
``test_torch_matmul_geometry.py``).

Two bases.  ``bsi_matmul`` is the JAX kernel's product with
``basis_matrix(tile, bfloat16)``, the float64 Kronecker product rounded once;
the JAX fused kernel's matrix form builds its basis in the kernel from its
bf16 LUTs, each product rounded to bf16 (``kron_basis``), which puts some
entries a bf16 step from the other (3350 of 8000 at a 5^3 tile).  The port
takes each kernel's own: ``bsi_matmul.basis(tile, dev, bfloat16)`` and
``bsi_fused.basis_table(tile, dev, bfloat16)`` (``core.bspline.fused_basis``).
The same holds under ``compute_dtype="float16"`` (2781 of 8000 entries
apart at 5^3), and the tests whose body holds for any reduced dtype run on
fp16 too (``REDUCED``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ffd as rffd
from repro.core.bspline import weight_lut as rweight
from repro.core.options import RegistrationOptions as RefOptions
from repro.core.registration import ffd_register as ref_ffd_register
from repro.data.volumes import make_pair as ref_make_pair
from repro.kernels import ops as rops
from repro.kernels.bsi_matmul import kron_basis
from repro_torch import ffd_register
from repro_torch.convert import options_from_reference
from repro_torch.core import bspline, ffd, interpolate
from repro_torch.core.bspline import reduced_step, weight_lut
from repro_torch.kernels import bsi_adjoint, bsi_fused, bsi_matmul, bsi_tt, ops

import test_torch_matmul_geometry as mmgeo
import test_torch_tt_geometry as ttgeo
from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401

BF16 = torch.bfloat16
REDUCED = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                                  ids=["bf16", "f16"])
FORWARD = [((13, 11, 9), (5, 4, 3)), ((10, 10, 10), (5, 5, 5)), ((12, 11, 9), (3, 3, 3))]


def _grid(vol, tile, seed, scale=2.5):
    rng = np.random.default_rng(seed)
    g = ffd.grid_shape_for_volume(vol, tile)
    return (scale * rng.standard_normal(g + (3,))).astype(np.float32)


def _name(dtype):
    """A torch dtype's name, the compute dtype's: ``"bfloat16"``, ``"float16"``."""
    return str(dtype).removeprefix("torch.")


def _jnp(dtype):
    return getattr(jnp, _name(dtype))


def _steps(a, b):
    """``|a - b|`` of two bf16 (fp16) tensors in steps of their dtype at the
    larger magnitude (``2^(floor(log2 m) - 7)``; fp16 ``- 10``, its
    subnormals' step at least)."""
    step = reduced_step(torch.maximum(a.float().abs(), b.float().abs()), a.dtype)
    return (a.float() - b.float()).abs() / step


@REDUCED
@pytest.mark.parametrize("vol,tile", FORWARD)
def test_matmul_plain_follows_the_bf16_contract(vol, tile, dtype):
    """On a bf16 (fp16) grid ``ops.bsi_matmul`` (the CPU runs its plain
    version) returns a field of its dtype, bit for bit the float32 sums in
    ``k`` order of the widened grid and the basis rounded to the dtype,
    rounded once, and equal to the contract form ``interpolate.bsi_matmul``
    of the dtype (the same terms summed by ``einsum``: at these inputs no
    sum lands across a rounding boundary).  (It used to sum with the float32
    basis and return float32: 1.27e-2 from the contract form in bf16.)"""
    phi = torch.from_numpy(_grid(vol, tile, 3)).to(dtype)
    out = ops.bsi_matmul(phi, tile, vol)
    assert out.dtype == dtype and out.shape == vol + (3,)
    b = bspline.basis_matrix(tile, dtype).float()
    want = bsi_matmul.basis_sum(phi.float(), b, tile, vol).to(dtype)
    assert torch.equal(out, want)
    X, Y, Z = vol
    form = interpolate.bsi_matmul(phi.float(), tile, dtype)[:X, :Y, :Z]
    assert form.dtype == dtype and torch.equal(out, form)


@REDUCED
@pytest.mark.parametrize("tile", [(d, d, d) for d in range(1, 9)]
                         + [(5, 4, 3), (8, 1, 6), (2, 7, 5)])
def test_fused_basis_is_the_reference_kernels_basis(tile, dtype):
    """``core.bspline.fused_basis`` in bf16 (fp16) is bit for bit the JAX
    fused kernel's in-kernel basis, ``kron_basis`` of its LUTs of the
    dtype; the port's LUTs are the JAX package's."""
    ref = kron_basis(*(rweight(d, _jnp(dtype)) for d in tile))
    assert ref.dtype == _jnp(dtype)
    got = bspline.fused_basis(tile, dtype)
    assert got.dtype == dtype
    assert np.array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    held = bsi_fused.basis_table(tile, "cpu", dtype)
    assert held.dtype == torch.float32 and torch.equal(held, got.float())
    # float32 keeps the float64 product cast once (bsi_matmul's basis)
    assert torch.equal(bsi_fused.basis_table(tile, "cpu"), bsi_matmul.basis(tile, "cpu"))


@REDUCED
@pytest.mark.parametrize("mode", ["tt", "matmul"])
@pytest.mark.parametrize("vol,tile", FORWARD)
def test_plain_forms_against_reference_kernels(mode, vol, tile, dtype):
    """The TT and matrix forms' plain versions on a bf16 (fp16) grid against
    the JAX package's Pallas kernels of the dtype (interpreted): the matrix
    form within one step (the same operands, float32 sums in another
    order); TT at 5e-2 (the JAX kernel accumulates in the dtype,
    ``tests/test_kernels_bsi.py``'s tolerance)."""
    phi = _grid(vol, tile, 4)
    full = tuple((n - 3) * d for n, d in zip(phi.shape[:3], tile))
    out = ops.FORWARD_KERNELS[mode](torch.from_numpy(phi).to(dtype), tile, full)
    ref = rops.bsi_pallas(jnp.asarray(phi, _jnp(dtype)), tile, mode=mode)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    if mode == "matmul":
        assert _steps(out, ref.to(dtype)).max().item() <= 1.0
    else:
        assert (out.float() - ref).abs().max().item() <= 5e-2


@REDUCED
@pytest.mark.parametrize("tiles,tile", ttgeo.FORM_GRIDS)
def test_tt_weights_summed_in_order_are_plain_bit_for_bit(tiles, tile, dtype):
    """The bf16 (fp16) kernel's weight table (``weight_table(..., dtype)``:
    the float32 products of the LUTs of the dtype), its 64 terms added in
    ``l, m, n`` order to the widened grid and each value rounded once, give
    ``bsi_tt.plain`` of the grid of the dtype bit for bit."""
    dx, dy, dz = tile
    tx, ty, tz = tiles
    rng = np.random.default_rng(34)
    phi = torch.from_numpy(
        rng.standard_normal((tx + 3, ty + 3, tz + 3, 3)).astype(np.float32) * 2.5).to(dtype)
    rows = bsi_tt.tt_blocks(tile, 3, tile).weight_rows
    W = bsi_tt.weight_table(tile, "cpu", dtype).reshape(dx, dy, rows, 64)
    wx, wy, wz = (weight_lut(d, dtype, "cpu").float() for d in tile)
    ref_w = ((wx[:, None, None, :, None, None] * wy[None, :, None, None, :, None])
             * wz[None, None, :, None, None, :]).reshape(dx, dy, dz, 64)
    assert torch.equal(W[:, :, :dz], ref_w) and not W[:, :, dz:].any()
    p32 = phi.float()
    acc = torch.zeros((tx, dx, ty, dy, tz, dz, 3))
    for q in range(64):
        l, m, n = q >> 4, (q >> 2) & 3, q & 3
        p = p32[l:l + tx, m:m + ty, n:n + tz][:, None, :, None, :, None, :]
        acc = acc + p * W[:, :, :dz, q][None, :, None, :, None, :, None]
    full = tuple(t * d for t, d in zip(tiles, tile))
    out = bsi_tt.plain(phi, tile, full)
    assert out.dtype == dtype and torch.equal(acc.reshape(full + (3,)).to(dtype), out)


@pytest.mark.parametrize("tile", ttgeo.TILES)
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("vol", ttgeo.SMALL)
def test_bf16_tt_stores_write_every_value_once(tile, c, vol):
    """The TT kernel's stores at 2 bytes a value: each column's staging
    offset modulo 8 values, each row's bulk-copy body 16-byte aligned at
    both ends in whole 16 bytes, the head and tail (under 8 values each) by
    lanes, a piece not aligned alike by the group's lanes, each warp one
    aligned half of a 128-byte line; every value of the field written
    exactly once, from the staged value of its own place."""
    geo = ttgeo._geometry(tile, c, vol)
    ttgeo._written_once(geo, tile, c, vol, range(geo.grid[1]), itemsize=2)


@pytest.mark.parametrize("tile", ttgeo.TILES)
@pytest.mark.parametrize("vol", [ttgeo.PHANTOM1, ttgeo.COARSE])
def test_bf16_tt_stores_phantom1(tile, vol):
    """The same at phantom1 and its coarse level, 3 channels, the first and
    last x tiles (which stand for the rest, as in the float32 twin)."""
    geo = ttgeo._geometry(tile, 3, vol)
    ttgeo._written_once(geo, tile, 3, vol, sorted({0, geo.grid[1] - 1}), itemsize=2)


@pytest.mark.parametrize("tile", mmgeo.TILES)
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("vol", mmgeo.SMALL)
def test_bf16_matmul_copies_and_stores_every_value_once(tile, c, vol):
    """The matrix-form kernel at 2 bytes a value: each window row copied
    in 16-byte chunks of 8 values from its start rounded down (the shift
    0..7 values, within the float32 kernel's raw row), W^T's operands the
    column matrix of ``repro``'s ``contract_window``; each staged run
    placed modulo 8 values, its bulk-copy body 16-byte aligned at both
    ends, its head and tail under 8 values; every value written once."""
    geo = mmgeo._geometry(tile, c, vol)
    counts = mmgeo._written_once(geo, tile, c, vol, range(geo.units), itemsize=2)
    assert (counts == 1).all()
    mmgeo._check_windows(geo, tile, c, vol, sorted({0, geo.units - 1}), itemsize=2)


@pytest.mark.parametrize("obase", [1, 3, 5, 7])
def test_bf16_matmul_unaligned_field_base(obase):
    """A bf16 field whose base is 2..14 bytes past a 16-byte boundary: the
    runs still leave by aligned bulk copies, each value once."""
    tile, c, vol = (5, 4, 3), 3, (22, 15, 30)
    geo = mmgeo._geometry(tile, c, vol)
    counts = mmgeo._written_once(geo, tile, c, vol, range(geo.units), obase, itemsize=2)
    assert (counts == 1).all()


def test_bf16_matmul_phantom1_rows():
    """phantom1 at tile 5^3, 3 channels, bf16: the units of the first and
    last x tiles' first two and last two y tiles (all their chunks), each
    value of those rows once; the windows of the first and last units."""
    tile, c, vol = (5, 5, 5), 3, mmgeo.PHANTOM1
    geo = mmgeo._geometry(tile, c, vol)
    X, Y, Z = vol
    tx, ty = (-(-v // d) for v, d in zip(vol[:2], tile[:2]))
    for ti in (0, tx - 1):
        for tj in (0, 1, ty - 2, ty - 1):
            units = [(ti * ty + tj) * geo.chunks + h for h in range(geo.chunks)]
            addr = np.concatenate([mmgeo._unit(geo, tile, c, vol, u, itemsize=2)
                                   for u in units])
            rest, zc = addr // (Z * c), addr % (Z * c)
            x, y = rest // Y, rest % Y
            assert ((x // 5 == ti) & (y // 5 == tj)).all()
            n = (min(X, 5 * ti + 5) - 5 * ti) * (min(Y, 5 * tj + 5) - 5 * tj) * Z * c
            local = ((x - 5 * ti) * 5 + y - 5 * tj) * Z * c + zc
            assert len(addr) == n and len(np.unique(local)) == n
    mmgeo._check_windows(geo, tile, c, vol, [0, geo.units - 1], itemsize=2)


FUSED_VOLUMES = [((12, 11, 9), (3, 3, 3)), ((13, 10, 9), (4, 4, 4)), ((7, 6, 5), (2, 3, 4))]
FUSED_SPECS = [("ssd",), ("ncc",), ("nmi", 32, 0.5, 1e-8), ("lncc", 9, 1e-5),
               ("lncc", 5, 1e-5)]


def _fused_inputs(vol, tile, seed=2):
    rng = np.random.default_rng(seed)
    grid = rffd.grid_shape_for_volume(vol, tile)
    phi = (rng.standard_normal(grid + (3,)) * 1.5).astype(np.float32)
    mov, fix = (rng.uniform(0, 1, vol).astype(np.float32) for _ in range(2))
    return phi, mov, fix


@REDUCED
@pytest.mark.parametrize("spec", FUSED_SPECS, ids=lambda s: "-".join(map(str, s[:2])))
@pytest.mark.parametrize("vol,tile", FUSED_VOLUMES)
def test_bf16_fused_matmul_plain_against_reference_kernel(vol, tile, spec, dtype):
    """Each fused variant's plain version in the matrix form on bf16 (fp16)
    ``phi`` and ``moving`` against the JAX package's fused kernel,
    interpreted, with ``disp_form="matmul"`` under the same dtype: 1e-5
    relative (measured at most 3.3e-7 in bf16).  Both take the basis of the
    LUTs of the dtype with each product rounded to it and round the
    displacement once to it; only their float32 sums' order differs."""
    phi, mov, fix = _fused_inputs(vol, tile)
    ref = float(rops.fused_similarity_loss(
        jnp.asarray(phi), jnp.asarray(mov), jnp.asarray(fix), tile, sim_spec=spec,
        interpret=True, disp_form="matmul", compute_dtype=_name(dtype)))
    out = ops.fused_similarity_loss(torch.from_numpy(phi).to(dtype),
                                    torch.from_numpy(mov).to(dtype), torch.from_numpy(fix),
                                    tile, sim_spec=spec, disp_form="matmul")
    assert out.dtype == torch.float32 and out.dim() == 0
    assert abs(out.item() - ref) <= 1e-5 * abs(ref)


@REDUCED
@pytest.mark.parametrize("vol,tile", FUSED_VOLUMES)
def test_bf16_fused_matmul_displacement_is_rounded_once(vol, tile, dtype):
    """The matrix form's plain warp on bf16 (fp16) inputs: its displacement
    is the float32 sums of the widened grid with the fused basis, rounded
    once to the dtype and widened (where it used to stay float32), and the
    warp the float32 warp of the widened volume there."""
    phi, mov, _ = _fused_inputs(vol, tile, seed=5)
    p, m = torch.from_numpy(phi).to(dtype), torch.from_numpy(mov).to(dtype)
    disp = bsi_fused.displacement(p, tile, vol, "matmul")
    b = bsi_fused.basis_table(tile, "cpu", dtype)
    assert disp.dtype == dtype
    assert torch.equal(disp, bsi_matmul.basis_sum(p.float(), b, tile, vol).to(dtype))
    out = bsi_fused.warped(p, m, tile, "matmul")
    assert out.dtype == torch.float32
    assert torch.equal(out, ffd.warp_volume(m.float(), disp.float()))


@REDUCED
@pytest.mark.parametrize("full,tile,c", [((12, 9, 15), (3, 3, 3), 3),
                                          ((8, 12, 12), (4, 4, 4), 1),
                                          ((10, 9, 8), (5, 3, 2), 3)])
def test_bf16_matmul_adjoint_reads_the_cotangent_as_float32(full, tile, c, dtype):
    """``bsi_adjoint_matmul`` on a bf16 (fp16) cotangent (its plain version
    here) is float32, bit for bit itself on the widened cotangent, and
    within 1e-5 of the JAX package's Pallas matmul adjoint on the same
    cotangent (both float32 sums with the float32 basis)."""
    rng = np.random.default_rng(12)
    g = torch.from_numpy(rng.standard_normal(full + (c,)).astype(np.float32)).to(dtype)
    grid = tuple(n // d + 3 for n, d in zip(full, tile))
    out = ops.bsi_adjoint_matmul(g, tile, grid)
    assert out.dtype == torch.float32 and out.shape == grid + (c,)
    assert torch.equal(out, ops.bsi_adjoint_matmul(g.float(), tile, grid))
    assert torch.equal(out, bsi_adjoint.plain_matmul(g.float(), tile, grid))
    ref = np.asarray(rops.bsi_adjoint_pallas(jnp.asarray(g.float().numpy(), _jnp(dtype)),
                                             tile, form="matmul", interpret=True))
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.fixture(scope="module")
def pair():
    """``tests/test_adjoint.py:165-180``'s registration inputs, one level."""
    fixed, moving, _ = ref_make_pair(shape=(24, 20, 18), tile=(6, 6, 6), magnitude=1.5,
                                     seed=3)
    return np.asarray(fixed), np.asarray(moving)


@pytest.mark.parametrize("mode,grad_impl,fused", [("tt", "cuda", "off"),
                                                  ("matmul", "matmul", "off"),
                                                  ("matmul", "matmul", "on")],
                         ids=["tt", "matmul", "matmul-fused"])
@REDUCED
def test_bf16_registration_matches_reference(pair, mode, grad_impl, fused, dtype):
    """``ffd_register`` under bf16 (fp16) in the TT form and in the matrix form
    (unfused, and fused: the matrix-form fused forward, its backward's
    field recomputed by ``bsi_matmul``), on the card's path (``impl="cuda"``
    and the adjoint kernel of ``grad_impl``, their plain versions here),
    against the JAX package's same call in the dtype (its ``jnp`` forms; fused,
    its fused kernel interpreted) at the JAX package's bf16 bounds (final
    loss within 1.1x + 1e-4 both ways, warp MAE < 5e-3,
    ``tests/test_adjoint.py``)."""
    fixed, moving = pair
    kw = dict(tile=(6, 6, 6), levels=1, iters=8, mode=mode, impl="jnp", grad_impl="jnp",
              fused=fused, compute_dtype=_name(dtype))
    ref = ref_ffd_register(fixed, moving, options=RefOptions(**kw))
    opts = options_from_reference(kw).replace(impl="cuda", grad_impl=grad_impl)
    res = ffd_register(fixed, moving, options=opts, device="cpu")
    assert res.warped.dtype == res.params.dtype == torch.float32
    assert res.losses[-1] < 1.1 * ref.losses[-1] + 1e-4
    assert ref.losses[-1] < 1.1 * res.losses[-1] + 1e-4
    assert np.abs(res.warped.numpy() - np.asarray(ref.warped)).mean() < 5e-3
