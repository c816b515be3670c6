"""The bf16 fused level step against the JAX package's, on the CPU.

Under ``compute_dtype="bfloat16"`` the fused kernels take a bf16 ``phi`` and
``moving`` (``fixed`` and the sums float32) and the backward hands the
separable adjoint a bf16 cotangent.  Here their plain versions, which the
card holds the kernels to, run against the JAX package's fused kernel and
adjoint kernel (Pallas in interpret mode), on seeded numpy inputs handed to
both packages.

The port's fused kernels form the displacement in the TTLI lerp form, the
JAX kernel in its separable form: in float32 the same function, but under
bf16 each rounds its own LUTs to bf16 (the lerp ``t0, t1, s`` against the
``(d, 4)`` weights), so the two displacements differ by a few bf16 ulps of
the weights before their one rounding, and where a value lands on the other
side of a rounding boundary it is a bf16 step apart (2^-7 voxel for
``|u|`` in [1, 2)).  So the lerp form is held to the JAX kernel at 1e-3
relative (measured at most 3.3e-4 over these inputs; the JAX package's own
bf16 fused bound is 3e-3), and the same plain versions with the separable
displacement put in at 1e-5 (measured at most 7e-7): given the JAX kernel's
displacement, the warp, the casts and the sums are its.  The tests whose
body holds for any reduced dtype run under ``compute_dtype="float16"`` too
(``REDUCED``), at the same tolerances: fp16's steps are 8 times finer.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ffd as rffd
from repro.core.options import RegistrationOptions as RefOptions
from repro.core.registration import ffd_register as ref_ffd_register
from repro.data.volumes import make_pair as ref_make_pair
from repro.kernels import ops as rops
from repro_torch import ffd_register
from repro_torch.convert import options_from_reference
from repro_torch.core import ffd
from repro_torch.kernels import bsi_fused, bsi_separable, ops

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
BF16 = torch.bfloat16
REDUCED = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                                  ids=["bf16", "f16"])
# non-cubic and non-divisible tiles, a grid overhanging the volume, a volume
# smaller than the 9-voxel LNCC window (which clamps)
VOLUMES = [((12, 11, 9), (3, 3, 3)), ((13, 10, 9), (4, 4, 4)), ((7, 6, 5), (2, 3, 4))]
SPECS = [("ssd",), ("ncc",), ("nmi", 32, 0.5, 1e-8), ("lncc", 9, 1e-5), ("lncc", 5, 1e-5)]


def _spec_id(spec):
    return "-".join(map(str, spec[:2]))


def _inputs(vol, tile, seed=2):
    rng = np.random.default_rng(seed)
    grid = rffd.grid_shape_for_volume(vol, tile)
    phi = (rng.standard_normal(grid + (3,)) * 1.5).astype(np.float32)
    mov, fix = (rng.uniform(0, 1, vol).astype(np.float32) for _ in range(2))
    return phi, mov, fix


def _name(dtype):
    return str(dtype).removeprefix("torch.")


@functools.lru_cache(maxsize=None)
def _reference(vol, tile, spec, cd="bfloat16"):
    """The JAX package's fused loss under compute dtype ``cd`` (its kernel,
    interpreted), once per case for both tests."""
    phi, mov, fix = _inputs(vol, tile)
    return float(rops.fused_similarity_loss(
        jnp.asarray(phi), jnp.asarray(mov), jnp.asarray(fix), tile, sim_spec=spec,
        interpret=True, disp_form="separable", compute_dtype=cd))


def _port(vol, tile, spec, dtype=BF16):
    phi, mov, fix = _inputs(vol, tile)
    out = ops.fused_similarity_loss(torch.from_numpy(phi).to(dtype),
                                    torch.from_numpy(mov).to(dtype), torch.from_numpy(fix),
                                    tile, sim_spec=spec)
    assert out.dtype == torch.float32 and out.dim() == 0
    return out.item()


@REDUCED
@pytest.mark.parametrize("spec", SPECS, ids=_spec_id)
@pytest.mark.parametrize("vol,tile", VOLUMES)
def test_bf16_fused_plain_within_the_lut_gap_of_the_reference_kernel(vol, tile, spec,
                                                                     dtype):
    """Each variant's plain version on bf16 (fp16) ``phi`` and ``moving``,
    lerp form, against the JAX package's fused kernel under the same dtype:
    1e-3 relative (the LUTs' gap, module docstring)."""
    ref = _reference(vol, tile, spec, _name(dtype))
    assert abs(_port(vol, tile, spec, dtype) - ref) <= 1e-3 * abs(ref)


@REDUCED
@pytest.mark.parametrize("spec", SPECS, ids=_spec_id)
@pytest.mark.parametrize("vol,tile", VOLUMES)
def test_bf16_fused_plain_is_the_reference_kernel_given_its_displacement(
        monkeypatch, vol, tile, spec, dtype):
    """The same with the separable form's displacement (the weight LUTs
    rounded to the dtype, float32 sums, one rounding) in place of the lerp
    form's: the JAX kernel's loss at 1e-5 relative."""
    monkeypatch.setattr(bsi_fused, "bsi_ttli", bsi_separable)
    ref = _reference(vol, tile, spec, _name(dtype))
    assert abs(_port(vol, tile, spec, dtype) - ref) <= 1e-5 * abs(ref)


@REDUCED
@pytest.mark.parametrize("vol,tile", VOLUMES)
def test_bf16_warp_takes_bf16_taps_and_the_rounded_displacement(vol, tile, dtype):
    """``bsi_fused.warped`` on bf16 (fp16) inputs is the float32 warp of the
    widened volume at the rounded displacement widened: the unfused
    ``warp_volume`` of ``dense_field(compute_dtype=...)``, bit for bit, and
    float32."""
    phi, mov, _ = _inputs(vol, tile, seed=5)
    p, m = torch.from_numpy(phi).to(dtype), torch.from_numpy(mov).to(dtype)
    out = bsi_fused.warped(p, m, tile)
    disp = ffd.dense_field(torch.from_numpy(phi), tile, vol, mode="ttli",
                           compute_dtype=_name(dtype))
    assert disp.dtype == dtype and out.dtype == torch.float32
    ref = ffd.warp_volume(m.float(), disp.float())
    assert torch.equal(out, ref)


ADJOINT_CASES = [((12, 9, 15), (3, 3, 3), 3), ((8, 12, 12), (4, 4, 4), 1),
                 ((10, 9, 8), (5, 3, 2), 3)]


@REDUCED
@pytest.mark.parametrize("full,tile,c", ADJOINT_CASES)
def test_bf16_cotangent_adjoint_matches_reference_kernel(full, tile, c, dtype):
    """The separable adjoint's plain version on a bf16 (fp16) cotangent
    against the JAX package's Pallas adjoint (interpreted) on the same
    cotangent: both accumulate in float32, 1e-5 of the largest value; and
    bit for bit the plain adjoint of the widened cotangent (which the kernel
    on the card is held to)."""
    rng = np.random.default_rng(11)
    g = torch.from_numpy(rng.standard_normal(full + (c,)).astype(np.float32)).to(dtype)
    grid = tuple(n // d + 3 for n, d in zip(full, tile))
    out = ops.bsi_adjoint(g, tile, grid)
    ref = np.asarray(rops.bsi_adjoint_pallas(jnp.asarray(g.float().numpy(),
                                                         getattr(jnp, _name(dtype))),
                                             tile, form="separable", interpret=True))
    assert out.dtype == torch.float32 and out.shape == grid + (c,)
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert torch.equal(out, ops.bsi_adjoint(g.float(), tile, grid))


@REDUCED
@pytest.mark.parametrize("grad_impl", ["cuda", "torch", "matmul"])
def test_bf16_backward_hands_the_adjoint_its_cotangent(monkeypatch, grad_impl, dtype):
    """Every ``grad_impl`` passes the bf16 (fp16) cotangent to its adjoint
    as it is (``"cuda"`` and ``"torch"`` the separable one, ``"matmul"`` the
    transposed matrix form, each widening it as it reads it); the
    gradients are the adjoint's float32 values on the widened cotangent."""
    from repro_torch.core import interpolate

    phi_np, _, _ = _inputs((12, 11, 9), (3, 3, 3))
    seen = []
    real = interpolate.bsi_adjoint

    def spy(g, *args, **kw):
        seen.append(g.dtype)
        return real(g, *args, **kw)

    monkeypatch.setattr(interpolate, "bsi_adjoint", spy)
    phi = torch.from_numpy(phi_np).requires_grad_(True)
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((12, 11, 9, 3))
                         .astype(np.float32))
    field = interpolate.crop_interpolate(phi, (3, 3, 3), (12, 11, 9), mode="ttli",
                                         impl="cuda", grad_impl=grad_impl, dtype=dtype)
    (grad,) = torch.autograd.grad((field.float() * w).sum(), phi)
    assert seen == [dtype]
    assert grad.dtype == torch.float32
    g16 = w.to(dtype)  # the cotangent of field: w, rounded to the field's dtype
    want = real(g16.float(), (3, 3, 3), phi.shape[:3],
                impl="matmul" if grad_impl == "matmul" else "torch")
    assert torch.equal(grad, want)


@pytest.fixture(scope="module")
def fused_pair():
    """``tests/test_fused_level.py``'s registration inputs as the bf16
    registration test takes them (``tests/test_adjoint.py:165-180``, one
    level), and the JAX package's bf16 fused run."""
    fixed, moving, _ = ref_make_pair(shape=(24, 20, 18), tile=(6, 6, 6), magnitude=1.5,
                                     seed=3)
    fixed, moving = np.asarray(fixed), np.asarray(moving)
    kw = dict(tile=(6, 6, 6), levels=1, iters=8, mode="separable", impl="jnp",
              grad_impl="jnp", fused="on")
    ref16 = ref_ffd_register(fixed, moving, options=RefOptions(compute_dtype="bfloat16",
                                                              **kw))
    return fixed, moving, kw, ref16


def test_bf16_fused_registration_against_reference(fused_pair):
    """``ffd_register(compute_dtype="bfloat16", fused="on")`` on the card's
    path (``ttli / cuda / cuda``, the plain versions here) against the JAX
    package's bf16 fused run at its bf16 bounds (final loss < 1.1x + 1e-4
    both ways, warp MAE < 5e-3), against the port's float32 fused run at the
    same bounds, and against the port's bf16 unfused run: each step's loss
    within 1e-4 relative (the fused forward is the unfused one's function,
    ``tests/test_fused_level.py:94-95``; the gradients are the unfused
    path's)."""
    fixed, moving, kw, ref16 = fused_pair
    opts = options_from_reference(kw).replace(mode="ttli", impl="cuda", grad_impl="cuda")
    r16 = ffd_register(fixed, moving, options=opts.replace(compute_dtype="bfloat16"),
                       device="cpu")
    r32 = ffd_register(fixed, moving, options=opts, device="cpu")
    off = ffd_register(fixed, moving, options=opts.replace(compute_dtype="bfloat16",
                                                           fused="off"), device="cpu")
    assert r16.warped.dtype == r16.params.dtype == torch.float32
    assert r16.losses[-1] < 1.1 * r32.losses[-1] + 1e-4
    assert (r16.warped - r32.warped).abs().mean().item() < 5e-3
    theirs = np.asarray(ref16.warped)
    assert r16.losses[-1] < 1.1 * ref16.losses[-1] + 1e-4
    assert ref16.losses[-1] < 1.1 * r16.losses[-1] + 1e-4
    assert np.abs(r16.warped.numpy() - theirs).mean() < 5e-3
    np.testing.assert_allclose(r16.losses, off.losses, rtol=1e-4)
