"""``compute_dtype="bfloat16"``: the port's mixed precision against the JAX
package's, on the CPU (the kernels' plain versions).  The tests whose body
holds for any reduced dtype run on ``float16`` too (``REDUCED``); the
fp16-only cases are ``tests/test_torch_f16.py``'s.

The contract (``core.interpolate``): bf16 ``phi`` and LUTs rounded to bf16
as the JAX package rounds them, float32 arithmetic, one rounding at the
store; the analytic adjoints widen a bf16 cotangent to float32 and return
float32 gradients; the warp samples bf16 intensities at float32 coordinates
and comes back float32; parameters, optimiser state and the objective stay
float32.  The JAX package rounds elsewhere (its TTLI and ``jnp`` forms
compute in bf16), so the port is held to that package's own bf16 bounds:
5e-2 against the float32 oracle (``tests/test_kernels_bsi.py``), a final
loss within 1.1x and a warp within 5e-3 (``tests/test_adjoint.py``), a fused
loss within 3e-3 of float32 and 1e-4 of unfused bf16
(``tests/test_fused_level.py``).  Inputs are seeded numpy arrays handed to
both packages.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ffd as rffd
from repro.core import interpolate as rinterp
from repro.core.bspline import basis_matrix as rbasis
from repro.core.bspline import lerp_luts as rlerp
from repro.core.bspline import weight_lut as rweight
from repro.core.options import RegistrationOptions as RefOptions
from repro.core.registration import ffd_register as ref_ffd_register
from repro.data.volumes import make_pair as ref_make_pair
from repro.kernels import ops as rops
from repro.kernels.ref import bsi_ref
from repro_torch import RegistrationOptions, RegistrationScheduler, ffd_register
from repro_torch.convert import options_from_reference
from repro_torch.core import bspline, ffd, interpolate
from repro_torch.core.similarity import resolve_similarity
from repro_torch.engine import autotune
from repro_torch.engine.batch import register_batch
from repro_torch.kernels import bsi_matmul, bsi_separable, bsi_tt, bsi_ttli, ops

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
# the reduced compute dtypes, each with the JAX package's spelling
REDUCED = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                                  ids=["bf16", "f16"])
MODES = ("gather", "matmul", "separable", "tt", "ttli")


def _jnp(dtype):
    """The JAX package's dtype of a torch dtype."""
    return getattr(jnp, _name(dtype))


def _name(dtype):
    """A torch dtype's name: ``"bfloat16"``, ``"float16"``."""
    return str(dtype).removeprefix("torch.")
SIMS = ("ssd", "ncc", "lncc", "nmi")


def _bits(t):
    """A tensor's values as float32 bit patterns (bf16 and fp16 widen
    exactly)."""
    return t.float().numpy().view(np.uint32)


def _ref_bits(a):
    return np.asarray(a).astype(np.float32).view(np.uint32)


@pytest.mark.parametrize("spelling,name", [
    (torch.bfloat16, "bfloat16"), ("bfloat16", "bfloat16"), ("float32", "float32"),
    (torch.float32, "float32"), (torch.float16, "float16"), ("float16", "float16")])
def test_compute_dtype_canonicalised(spelling, name):
    """As the JAX package canonicalises (``tests/test_options.py:93-95``):
    a dtype or its name becomes the name, which hashes alike."""
    opts = RegistrationOptions(compute_dtype=spelling)
    assert opts.compute_dtype == name == RefOptions(compute_dtype=getattr(
        jnp, name)).compute_dtype
    assert opts == RegistrationOptions(compute_dtype=name)
    assert hash(opts) == hash(RegistrationOptions(compute_dtype=name))


def test_compute_dtype_refuses_what_is_not_a_float_type():
    """``int8`` (and any type that is not a float) is refused by the options
    and by ``interpolate``; ``float16``, the JAX package's third compute
    dtype, is accepted by both and writes an fp16 field."""
    with pytest.raises(ValueError, match="compute_dtype"):
        RegistrationOptions(compute_dtype="int8")
    with pytest.raises(ValueError, match="compute_dtype"):
        interpolate.interpolate(torch.zeros((4, 4, 4, 1)), (2, 2, 2), dtype=torch.int8)
    out = interpolate.interpolate(torch.zeros((4, 4, 4, 1)), (2, 2, 2), dtype=torch.float16)
    assert out.dtype == torch.float16 and out.shape == (2, 2, 2, 1)
    assert RegistrationOptions(compute_dtype=torch.float16).compute_dtype == "float16"


@REDUCED
@pytest.mark.parametrize("delta", range(1, 13))
def test_bf16_luts_bit_equal_to_reference(delta, dtype):
    """``weight_lut``, ``lerp_luts`` and ``basis_matrix`` in bf16: float64,
    rounded once through float32, as the JAX package's numpy cast rounds
    (no ``ml_dtypes`` on the card's machine); in fp16 rounded once by
    numpy's own cast, subnormals kept."""
    assert np.array_equal(_bits(bspline.weight_lut(delta, dtype)),
                          _ref_bits(rweight(delta, _jnp(dtype))))
    for ours, theirs in zip(bspline.lerp_luts(delta, dtype), rlerp(delta, _jnp(dtype))):
        assert ours.dtype == dtype
        assert np.array_equal(_bits(ours), _ref_bits(theirs))
    tile = (delta, max(1, 7 - delta), 3)
    assert np.array_equal(_bits(bspline.basis_matrix(tile, dtype)),
                          _ref_bits(rbasis(tile, _jnp(dtype))))


@REDUCED
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grid,tile", [((7, 7, 7), (5, 5, 5)), ((7, 6, 5), (5, 4, 3))])
def test_plain_bf16_forms_against_reference(mode, grid, tile, dtype):
    """Each plain form in bf16 (fp16) writes a field of its dtype within
    5e-2 of the JAX package's float32 oracle and of its Pallas kernel of
    the dtype in interpret mode (``tests/test_kernels_bsi.py:35-44``'s
    tolerance)."""
    rng = np.random.default_rng(3)
    phi = rng.standard_normal(grid + (3,)).astype(np.float32)
    out = interpolate.MODES[mode](torch.from_numpy(phi), tile, dtype)
    assert out.dtype == dtype
    got = out.float().numpy()
    np.testing.assert_allclose(got, np.asarray(bsi_ref(jnp.asarray(phi), tile)), atol=5e-2)
    if mode != "gather":  # the oracle has no kernel
        pallas = rops.bsi_pallas(jnp.asarray(phi, _jnp(dtype)), tile, mode=mode)
        np.testing.assert_allclose(got, np.asarray(pallas, np.float32), atol=5e-2)
    # the dispatcher's compute dtype and the grid's own give the same field
    same = interpolate.interpolate(torch.from_numpy(phi).to(dtype), tile, mode=mode)
    assert torch.equal(same, out)


FORM_MODULES = {"ttli": bsi_ttli, "separable": bsi_separable, "tt": bsi_tt,
                "matmul": bsi_matmul}


@REDUCED
@pytest.mark.parametrize("mode", list(FORM_MODULES))
@pytest.mark.parametrize("vol,tile", [((13, 11, 9), (5, 4, 3)), ((10, 10, 10), (5, 5, 5))])
def test_kernel_plain_is_the_float32_form_rounded_once(monkeypatch, mode, vol, tile, dtype):
    """A bf16 (fp16) ``plain`` equals the float32 plain on the same widened
    inputs, rounded to its dtype, bit for bit: the grid widened, the LUTs
    (the matrix form: its basis) rounded to the dtype and widened, float32
    arithmetic, one rounding.  On a CPU tensor the dispatcher runs it."""
    module = FORM_MODULES[mode]
    rng = np.random.default_rng(7)
    g = ffd.grid_shape_for_volume(vol, tile)
    phi = torch.from_numpy(2.5 * rng.standard_normal(g + (3,)).astype(np.float32)).to(dtype)
    out = module.plain(phi, tile, vol)
    assert out.dtype == dtype and out.shape == vol + (3,)
    assert torch.equal(ops.FORWARD_KERNELS[mode](phi, tile, vol), out)
    # the float32 form, handed LUTs (basis) rounded to bf16 in place of its own
    luts, weights, basis = interpolate.lerp_luts, interpolate.weight_lut, bsi_matmul.basis
    monkeypatch.setattr(interpolate, "lerp_luts", lambda d, dt, dev: tuple(
        t.to(dt) for t in luts(d, dtype, dev)))
    monkeypatch.setattr(interpolate, "weight_lut",
                        lambda d, dt, dev: weights(d, dtype, dev).to(dt))
    monkeypatch.setattr(bsi_matmul, "basis", lambda t, dev, dt=torch.float32: basis(
        t, dev, dtype))
    widened = module.plain(phi.float(), tile, vol)
    assert widened.dtype == torch.float32
    assert torch.equal(widened.to(dtype), out)
    # and the kernels' tables hold the same bf16 values as floats; TT's the
    # float32 products of the bf16 LUTs, as plain forms them
    if mode == "tt":
        dx, dy, dz = tile
        wx, wy, wz = (weights(d, dtype, "cpu").float() for d in tile)
        want = ((wx[:, None, None, :, None, None] * wy[None, :, None, None, :, None])
                * wz[None, None, :, None, None, :])
        held = bsi_tt.weight_table(tile, "cpu", dtype).reshape(dx, dy, -1, 4, 4, 4)
        assert held.dtype == torch.float32 and torch.equal(held[:, :, :dz], want)
        return
    held = {"ttli": lambda: bsi_ttli.stage_luts(tile, "cpu", dtype),
            "separable": lambda: bsi_separable.weight_luts(tile, "cpu", dtype),
            "matmul": lambda: basis(tile, "cpu", dtype)}[mode]()
    assert held.dtype == torch.float32 and torch.equal(held, held.to(dtype).float())


@REDUCED
@pytest.mark.parametrize("impl,grad_impl", [("cuda", "cuda"), ("cuda", "matmul"),
                                            ("torch", "torch")])
def test_gradient_is_float32_adjoint_of_widened_cotangent(impl, grad_impl, dtype):
    """The analytic adjoint under bf16 (fp16): a float32 gradient, equal to
    the float32 adjoint of the widened cotangent bit for bit, and within
    1e-5 of the JAX package's custom VJP (its backward also widens:
    ``_adjoint_jit(g, tile, grad_impl, None)``)."""
    rng = np.random.default_rng(11)
    tile, vol = (5, 4, 3), (13, 11, 9)
    g = ffd.grid_shape_for_volume(vol, tile)
    phi_np = rng.standard_normal(g + (3,)).astype(np.float32)
    phi = torch.from_numpy(phi_np).requires_grad_(True)
    out = ffd.dense_field(phi, tile, vol, mode="ttli", impl=impl, grad_impl=grad_impl,
                          compute_dtype=_name(dtype))
    assert out.dtype == dtype
    ct = torch.from_numpy(rng.standard_normal(vol + (3,)).astype(np.float32)).to(dtype)
    out.backward(ct)
    assert phi.grad.dtype == torch.float32
    want = interpolate.bsi_adjoint(ct.float(), tile, g, impl=grad_impl)
    assert torch.equal(phi.grad, want)
    import jax

    ref_grad = {"cuda": "pallas", "matmul": "matmul", "torch": "jnp"}[grad_impl]
    _, vjp = jax.vjp(lambda p: rffd.dense_field(
        p, tile, vol, mode="ttli", impl="jnp", grad_impl=ref_grad,
        compute_dtype=_name(dtype)), jnp.asarray(phi_np))
    (theirs,) = vjp(jnp.asarray(ct.float().numpy(), _jnp(dtype)))
    assert theirs.dtype == jnp.float32
    np.testing.assert_allclose(phi.grad.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)


@REDUCED
def test_autograd_differentiates_the_float32_plain_form(dtype):
    """An explicit ``grad_impl="autograd"`` under bf16 (fp16) differentiates
    the plain form through its casts: a float32 gradient, within 1e-2 of
    the analytic one (the cotangent is rounded to the dtype once on its way
    back)."""
    rng = np.random.default_rng(12)
    tile, vol = (3, 3, 3), (9, 8, 7)
    g = ffd.grid_shape_for_volume(vol, tile)
    phi = torch.from_numpy(rng.standard_normal(g + (3,)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal(vol + (3,)).astype(np.float32))
    grads = []
    for grad_impl in ("autograd", "torch"):
        p = phi.clone().requires_grad_(True)
        ffd.dense_field(p, tile, vol, mode="separable", grad_impl=grad_impl,
                        compute_dtype=_name(dtype)).float().backward(ct)
        assert p.grad.dtype == torch.float32
        grads.append(p.grad)
    scale = grads[1].abs().max().item()
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-2 * scale


@pytest.mark.parametrize("dtype,n", [(torch.bfloat16, 320), (torch.float16, 2052)],
                         ids=["bf16", "f16"])
def test_bf16_warp_coordinates_stay_float32_beyond_256_voxels(dtype, n):
    """``tests/test_adjoint.py:150-162``: alternating 0/1 intensities are
    exact in bf16 and fp16, so any error is a coordinate error; the port's
    warp equals the JAX package's.  bf16 holds no integer past 256 exactly,
    fp16 none past 2048, so each volume is longer than that."""
    x = np.arange(n, dtype=np.float32)
    vol = np.ascontiguousarray(np.broadcast_to((x % 2)[:, None, None], (n, 2, 2)))
    disp = np.zeros(vol.shape + (3,), np.float32)
    disp[..., 0] = 1.0
    warped = ffd.warp_volume(torch.from_numpy(vol), torch.from_numpy(disp),
                             compute_dtype=_name(dtype))
    assert warped.dtype == torch.float32
    err = (warped[:-1] - torch.from_numpy(vol[1:])).abs().max().item()
    assert err < 1e-2, err
    theirs = rffd.warp_volume(jnp.asarray(vol), jnp.asarray(disp), compute_dtype=_name(dtype))
    np.testing.assert_allclose(warped.numpy(), np.asarray(theirs, np.float32), atol=1e-6)


@pytest.fixture(scope="module")
def adjoint_pair():
    """``tests/test_adjoint.py:165-180``'s inputs at one level (its two
    levels cost the JAX package ~5 s more to compile) and the JAX package's
    bf16 run."""
    fixed, moving, _ = ref_make_pair(shape=(24, 20, 18), tile=(6, 6, 6), magnitude=1.5,
                                     seed=3)
    fixed, moving = np.asarray(fixed), np.asarray(moving)
    kw = dict(tile=(6, 6, 6), levels=1, iters=8, mode="separable", impl="jnp",
              grad_impl="jnp")
    ref16 = ref_ffd_register(fixed, moving, options=RefOptions(compute_dtype="bfloat16",
                                                              **kw))
    return fixed, moving, kw, ref16


@pytest.mark.parametrize("mode,impl,grad_impl", [("separable", "torch", "torch"),
                                                 ("ttli", "cuda", "cuda")])
def test_bf16_registration_close_to_float32_and_reference(adjoint_pair, mode, impl,
                                                          grad_impl):
    """bf16 against float32 registration at the JAX package's bounds (final
    loss < 1.1x + 1e-4, warp MAE < 5e-3), float32 warp and grid, and
    against the JAX package's bf16 run at the same bounds."""
    fixed, moving, kw, ref16 = adjoint_pair
    opts = options_from_reference(dict(kw, fused="off")).replace(
        mode=mode, impl=impl, grad_impl=grad_impl)
    r32 = ffd_register(fixed, moving, options=opts, device="cpu")
    r16 = ffd_register(fixed, moving, options=opts.replace(compute_dtype="bfloat16"),
                       device="cpu")
    assert r16.warped.dtype == r32.warped.dtype == torch.float32
    assert r16.params.dtype == torch.float32
    assert r16.losses[-1] < 1.1 * r32.losses[-1] + 1e-4
    assert (r16.warped - r32.warped).abs().mean().item() < 5e-3
    theirs = np.asarray(ref16.warped)
    assert r16.losses[-1] < 1.1 * ref16.losses[-1] + 1e-4
    assert ref16.losses[-1] < 1.1 * r16.losses[-1] + 1e-4
    assert np.abs(r16.warped.numpy() - theirs).mean() < 5e-3


def _fused_data(seed=2, vol=(12, 11, 9), tile=(3, 3, 3)):
    rng = np.random.default_rng(seed)
    g = ffd.grid_shape_for_volume(vol, tile)
    phi = (0.8 * rng.standard_normal(g + (3,))).astype(np.float32)
    return phi, rng.random(vol).astype(np.float32), rng.random(vol).astype(np.float32)


@REDUCED
@pytest.mark.parametrize("sim", SIMS)
def test_fused_bf16_loss(sim, dtype):
    """``tests/test_fused_level.py:78-96``: the plain fused bf16 (fp16) loss
    within 3e-3 of float32's and 1e-4 of the unfused loss of the dtype,
    float32 finite gradients; and within 3e-3 of the JAX package's unfused
    loss of the dtype."""
    tile, vol = (3, 3, 3), (12, 11, 9)
    phi_np, mov_np, fix_np = _fused_data()
    mov, fix = torch.from_numpy(mov_np), torch.from_numpy(fix_np)
    phi = torch.from_numpy(phi_np).requires_grad_(True)
    l16 = ffd.fused_warp_loss(phi, mov, fix, tile, similarity=sim, compute_dtype=_name(dtype))
    (g16,) = torch.autograd.grad(l16, phi)
    l32 = ffd.fused_warp_loss(phi, mov, fix, tile, similarity=sim)
    assert abs(l16.item() - l32.item()) <= 3e-3 * max(1.0, abs(l32.item()))
    assert g16.dtype == torch.float32 and torch.isfinite(g16).all()
    _, sim_fn = resolve_similarity(sim)
    with torch.no_grad():
        disp = ffd.dense_field(phi, tile, vol, compute_dtype=_name(dtype))
        lu16 = sim_fn(ffd.warp_volume(mov, disp, compute_dtype=_name(dtype)), fix).item()
    assert abs(l16.item() - lu16) <= 1e-4 * max(1.0, abs(lu16))
    _, ref_sim = __import__("repro.core.similarity", fromlist=["x"]).resolve_similarity(sim)
    ref_disp = rffd.dense_field(jnp.asarray(phi_np), tile, vol, compute_dtype=_name(dtype))
    theirs = float(ref_sim(rffd.warp_volume(jnp.asarray(mov_np), ref_disp,
                                            compute_dtype=_name(dtype)).astype(jnp.float32),
                           jnp.asarray(fix_np)))
    assert abs(l16.item() - theirs) <= 3e-3 * max(1.0, abs(theirs))


@REDUCED
def test_autotune_keys_the_compute_dtype_and_excludes_autograd(tmp_path, dtype):
    """``tests/test_adjoint.py:241-254``: under a reduced compute dtype
    ``"auto"`` never picks plain autodiff, and the entries are per dtype."""
    cache = str(tmp_path / "c.json")
    _, _, gi = autotune.resolve_bsi("auto", "torch", (7, 7, 7), (2, 2, 2),
                                    grad_impl="auto", device="cpu", reps=1,
                                    cache_path=cache, compute_dtype=_name(dtype))
    assert gi != "autograd"
    autotune.resolve_bsi("auto", "torch", (7, 7, 7), (2, 2, 2), grad_impl="auto",
                         device="cpu", reps=1, cache_path=cache)
    keys = list(json.load(open(cache))["entries"])
    assert any(f"|cd={_name(dtype)}|" in k for k in keys)
    assert any("|cd=" not in k for k in keys)
    # on a card a reduced dtype races the four kernel forms, each with a
    # kernel of the dtype;
    # pure functions of the device's type, no card needed
    cuda = torch.device("cuda")
    kernels = {("separable", "cuda"), ("ttli", "cuda"), ("tt", "cuda"), ("matmul", "cuda")}
    assert set(autotune.default_candidates(cuda)) == kernels
    assert set(autotune._candidate_pool("auto", "cuda", cuda)) == kernels
    assert len(autotune._candidate_pool("auto", "torch", cuda)) == 5


@REDUCED
def test_resolve_options_under_bf16_on_the_cpu(dtype):
    """``"auto"`` under bf16 (fp16) on the CPU: an analytic adjoint,
    ``fused`` off without a race, and the compute dtype kept."""
    opts = autotune.resolve_options(
        RegistrationOptions(mode="separable", impl="torch", grad_impl="auto",
                            compute_dtype=_name(dtype), levels=1, iters=1),
        (12, 10, 9), torch.device("cpu"))
    assert opts.grad_impl != "autograd" and opts.fused == "off"
    assert opts.compute_dtype == _name(dtype)


def _small_pairs(n=2, shape=(16, 14, 12)):
    rng = np.random.default_rng(4)
    x, y, z = np.meshgrid(*[np.linspace(0, np.pi, s) for s in shape], indexing="ij")
    wave = (np.sin(x) * np.sin(y) * np.sin(z)).astype(np.float32)
    fixed = [rng.random(shape).astype(np.float32) for _ in range(n)]
    moving = [np.roll(f, 1, axis=0) + 0.3 * wave for f in fixed]
    return np.stack(fixed), np.stack(moving).astype(np.float32)


BF16_OPTS = RegistrationOptions(tile=(4, 4, 4), levels=2, iters=4, lr=0.1,
                                compute_dtype="bfloat16", fused="off")


@REDUCED
def test_register_batch_bf16_bit_equal_to_solo(dtype):
    """A bf16 (fp16) batch: each pair equals its solo ``ffd_register`` bit
    for bit."""
    fixed, moving = _small_pairs()
    opts = BF16_OPTS.replace(compute_dtype=_name(dtype))
    batch = register_batch(fixed, moving, options=opts, device="cpu")
    for i in range(len(fixed)):
        solo = ffd_register(fixed[i], moving[i], options=opts, device="cpu")
        assert torch.equal(batch.warped[i], solo.warped)
        assert torch.equal(batch.params[i], solo.params)
        assert batch.losses[i].tolist() == solo.losses
    assert batch.warped.dtype == torch.float32


@REDUCED
def test_scheduler_bf16_bit_equal_to_solo(dtype):
    """A bf16 (fp16) stream through the scheduler: each served result equals
    its solo ``ffd_register`` of the dtype bit for bit."""
    fixed, moving = _small_pairs(3)
    opts = BF16_OPTS.replace(compute_dtype=_name(dtype))
    sched = RegistrationScheduler(opts, lanes=2, chunk=2, device="cpu")
    handles = [sched.submit(f, m) for f, m in zip(fixed, moving)]
    sched.run_until_idle()
    for h, f, m in zip(handles, fixed, moving):
        served, solo = h.result(), ffd_register(f, m, options=opts, device="cpu")
        assert served.losses == solo.losses
        assert torch.equal(served.params, solo.params)
        assert torch.equal(served.warped, solo.warped)


@pytest.mark.parametrize("fields", [dict(optimizer="lbfgs"),
                                    dict(optimizer="gauss_newton", regularizer="bending"),
                                    dict(transform="velocity")],
                         ids=["lbfgs", "gauss_newton", "velocity"])
@REDUCED
def test_bf16_beyond_the_defaults(fields, dtype):
    """Every optimiser and the velocity transform under bf16 (fp16): float32 grid
    and warp, finite, the final loss within the JAX package's bf16 bound of
    the float32 run's (1.1x + 1e-4), and the warp nearer the fixed volume
    than the moving one.  (The second-order steps' line searches and trust
    regions amplify bf16's rounding, so their warps are not held to Adam's
    5e-3 of float32.)"""
    fixed, moving = _small_pairs(1)
    opts = BF16_OPTS.replace(compute_dtype=None, **fields)
    r32 = ffd_register(fixed[0], moving[0], options=opts, device="cpu")
    r16 = ffd_register(fixed[0], moving[0], options=opts.replace(compute_dtype=_name(dtype)),
                       device="cpu")
    assert r16.params.dtype == r16.warped.dtype == torch.float32
    assert torch.isfinite(r16.params).all() and torch.isfinite(r16.warped).all()
    assert r16.losses[-1] < 1.1 * r32.losses[-1] + 1e-4
    f = torch.from_numpy(fixed[0])
    assert (r16.warped - f).abs().mean() < (torch.from_numpy(moving[0]) - f).abs().mean()


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs", "gauss_newton"])
@REDUCED
def test_optimizer_state_stays_float32_under_bf16(optimizer, dtype):
    """One step of each optimiser on a bf16 (fp16) level objective: the loss, the
    gradient, the new grid and every tensor of the state are float32."""
    from repro_torch.engine.batch import ffd_level_objective
    from repro_torch.engine.optimizer import init_state, opt_step

    fixed, moving = _small_pairs(1)
    f, m = torch.from_numpy(fixed[0]), torch.from_numpy(moving[0])
    obj = ffd_level_objective(f, m, tile=(4, 4, 4), bending_weight=5e-3, mode="ttli",
                              impl="cuda", grad_impl="cuda", compute_dtype=_name(dtype))
    p = torch.zeros(ffd.grid_shape_for_volume(f.shape, (4, 4, 4)) + (3,))
    loss, g = obj.vg(p)
    state = init_state(optimizer, p)
    p1, state1, g1, loss1, _ = opt_step(optimizer, obj, 0, p, state, g, loss, lr=0.1)
    for t in (loss, g, p1, g1, loss1, *state1.values()):
        assert t.dtype in (torch.float32, torch.int32), (optimizer, t.dtype)
    assert all(t.dtype != dtype for t in state1.values())


@REDUCED
def test_options_from_reference_carries_compute_dtype(dtype):
    ref = RefOptions(compute_dtype=_jnp(dtype))
    opts = options_from_reference({k: getattr(ref, k) for k in ref.__dataclass_fields__})
    assert opts.compute_dtype == _name(dtype)
    assert options_from_reference(dict(compute_dtype=_name(dtype))) == RegistrationOptions(
        compute_dtype=dtype)
