"""``compute_dtype="float16"``: the cases that only fp16 has, against the JAX
package on the CPU (the kernels' plain versions).

The contract is bf16's with fp16 in its place (``core.interpolate``): the
grid and LUTs rounded to fp16 as the JAX package rounds them, float32
arithmetic, one rounding to fp16 at the store (subnormals kept, no clamp
below fp16's 65504), the analytic adjoints reading the fp16 cotangent
widened exactly.  The tests whose body holds for any reduced dtype run on
fp16 in ``test_torch_bf16.py``, ``test_torch_bf16_fused.py`` and
``test_torch_bf16_matrix.py`` (LUTs bit-equal for tiles 1-12, the plain
forms rounded once, the gradient, the fused losses, the autotune key
``|cd=float16|``, batch and scheduler bit-equal to solo, optimiser state
float32, ``options_from_reference``).  Here: the fused matrix form's fp16
basis, each plain form against the JAX package's fp16 form of its name, the
fused loss against ``fused_warp_loss``, a registration at 40 x 32 x 24, and
the reference's fp16 cotangent underflow, which the port copies.  Inputs are
seeded numpy arrays handed to both packages.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ffd as rffd
from repro.core import interpolate as rinterp
from repro.core.bspline import weight_lut as rweight
from repro.core.options import RegistrationOptions as RefOptions
from repro.core.registration import ffd_register as ref_ffd_register
from repro.core.similarity import resolve_similarity as ref_similarity
from repro.data.volumes import make_pair as ref_make_pair
from repro.engine.batch import ffd_level_loss as ref_level_loss
from repro.kernels import ops as rops
from repro.kernels.bsi_matmul import kron_basis
from repro.kernels.ref import bsi_ref
from repro_torch import RegistrationOptions, ffd_register
from repro_torch.convert import options_from_reference
from repro_torch.core import bspline, ffd, interpolate
from repro_torch.core.bspline import reduced_step
from repro_torch.engine.batch import ffd_level_loss
from repro_torch.kernels import bsi_fused, build, ops
from repro_torch.launch.bounds import kernel_bounds

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401

F16 = torch.float16
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
MODES = ("gather", "matmul", "separable", "tt", "ttli")


def _step(m):
    """One fp16 step at magnitude ``m``: ``2^(floor(log2 m) - 10)``, at least
    the subnormals' ``2^-24``."""
    return reduced_step(torch.tensor(float(m), dtype=torch.float64), F16).item()


@pytest.mark.parametrize("d", range(1, 9))
def test_fused_basis_is_the_jitted_reference_basis(d):
    """``fused_basis(tile, float16)`` is bit for bit ``jax.jit(kron_basis)``
    of the JAX package's fp16 LUTs, ``f16(f16(wx wy) wz)`` (an fp16 product
    falling below fp16's normal range rounded to a subnormal), and so not
    ``basis_matrix(tile, float16)``'s one rounding: 2781 of 8000 entries
    apart at 5^3.  The fused kernels hold it as floats."""
    tile = (d, d, d)
    ref = jax.jit(kron_basis)(*(rweight(n, jnp.float16) for n in tile))
    got = bspline.fused_basis(tile, F16)
    assert got.dtype == F16 and ref.dtype == jnp.float16
    assert np.array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    held = bsi_fused.basis_table(tile, "cpu", F16)
    assert held.dtype == torch.float32 and torch.equal(held, got.float())
    apart = int((got != bspline.basis_matrix(tile, F16)).sum())
    assert apart > 0 and (d != 5 or apart == 2781), apart


@pytest.mark.parametrize("mode", MODES)
def test_plain_f16_forms_against_reference(mode):
    """Each plain form in fp16 on a grid of |phi| up to ~13 voxels at tile
    (5, 4, 3), against the JAX package's fp16 form of its name (its Pallas
    kernel in interpret mode where it has one, else its ``jnp`` form) and
    the float64 oracle of the float32 grid.  Where the JAX package also sums
    in float32 and rounds once (its separable and matrix kernels), within
    one fp16 step of the largest value plus 1e-5 of it (measured 0).  Where
    it sums in fp16 (gather, TT, TTLI: measured 3, 3 and 1.5 steps of the
    largest value from the port at this seed), the port is no farther from
    the oracle than the JAX package is (plus 1e-5 of the largest value).
    Either way the port is within two fp16 steps of the largest value of the
    oracle (measured 1 step: the grid's and the LUTs' rounding to fp16, and
    the field's one rounding)."""
    rng = np.random.default_rng(3)
    tile, grid = (5, 4, 3), (9, 8, 7)
    phi = (4.0 * rng.standard_normal(grid + (3,))).astype(np.float32)
    out = interpolate.MODES[mode](torch.from_numpy(phi), tile, F16)
    assert out.dtype == F16
    got = out.float().numpy().astype(np.float64)
    big = np.abs(got).max()
    if mode == "gather":  # the oracle has no kernel
        theirs = rinterp.MODES[mode](jnp.asarray(phi), tile, dtype=jnp.float16)
    else:
        theirs = rops.bsi_pallas(jnp.asarray(phi, jnp.float16), tile, mode=mode)
    assert theirs.dtype == jnp.float16
    theirs = np.asarray(theirs, np.float64)
    exact = np.asarray(bsi_ref(jnp.asarray(phi), tile), np.float64)
    ours_err, their_err = np.abs(got - exact).max(), np.abs(theirs - exact).max()
    assert ours_err <= 2 * _step(big), (mode, ours_err)
    if mode in ("separable", "matmul"):
        assert np.abs(got - theirs).max() <= _step(big) + 1e-5 * big, mode
    else:
        assert ours_err <= their_err + 1e-5 * big, (mode, ours_err, their_err)


def _fused_inputs(vol, tile, seed=2):
    rng = np.random.default_rng(seed)
    grid = rffd.grid_shape_for_volume(vol, tile)
    phi = (rng.standard_normal(grid + (3,)) * 1.5).astype(np.float32)
    mov, fix = (rng.uniform(0, 1, vol).astype(np.float32) for _ in range(2))
    return phi, mov, fix


@pytest.mark.parametrize("mode", ["ttli", "matmul"])
@pytest.mark.parametrize("sim", ["ssd", "ncc", "lncc", "nmi"])
def test_fused_warp_loss_against_reference(sim, mode):
    """``ffd.fused_warp_loss(compute_dtype="float16")`` in both displacement
    forms against the JAX package's ``fused_warp_loss`` in fp16 (its fused
    kernel interpreted; ``mode="ttli"`` runs its separable form there): the
    matrix form at 1e-5 relative (the same fp16 basis and one rounding,
    float32 sums in another order), the lerp form at 1e-3 (the two round
    different LUTs, ``test_torch_bf16_fused.py``'s gap); float32 finite
    gradients."""
    tile, vol = (3, 3, 3), (12, 11, 9)
    phi_np, mov_np, fix_np = _fused_inputs(vol, tile)
    phi = torch.from_numpy(phi_np).requires_grad_(True)
    loss = ffd.fused_warp_loss(phi, torch.from_numpy(mov_np), torch.from_numpy(fix_np), tile,
                               similarity=sim, mode=mode, compute_dtype="float16")
    (grad,) = torch.autograd.grad(loss, phi)
    assert loss.dtype == grad.dtype == torch.float32 and torch.isfinite(grad).all()
    theirs = float(rffd.fused_warp_loss(
        jnp.asarray(phi_np), jnp.asarray(mov_np), jnp.asarray(fix_np), tile, similarity=sim,
        mode="matmul" if mode == "matmul" else "separable", compute_dtype="float16",
        interpret=True))
    tol = 1e-5 if mode == "matmul" else 1e-3
    assert abs(loss.item() - theirs) <= tol * abs(theirs), (loss.item(), theirs)


@pytest.fixture(scope="module")
def pair40():
    """A 40 x 32 x 24 pair of the JAX package's generator and its fp16
    registration (separable, Pallas forward and adjoint, interpreted; two
    levels of 10 steps)."""
    fixed, moving, _ = ref_make_pair(shape=(40, 32, 24), seed=0)
    fixed, moving = np.array(fixed), np.array(moving)
    kw = dict(levels=2, iters=10, mode="separable", impl="pallas", grad_impl="pallas",
              fused="off", lr=0.5)
    ref16 = ref_ffd_register(fixed, moving, options=RefOptions(compute_dtype="float16", **kw))
    return fixed, moving, kw, ref16


def test_f16_registration_against_reference(pair40):
    """``ffd_register(compute_dtype="float16")`` at 40 x 32 x 24: the
    separable path on the kernels' plain versions (``impl="cuda",
    grad_impl="cuda"``) against the JAX package's same call, per-level
    losses within 1e-3 relative (measured 1e-6: the same fp16 field and
    cotangent); the default path (``ttli / cuda / cuda``) against the
    port's float32 run at the JAX package's bf16 bounds (final loss <
    1.1x + 1e-4, warp MAE < 5e-3), float32 grid and warp."""
    fixed, moving, kw, ref16 = pair40
    opts = options_from_reference(kw).replace(impl="cuda", grad_impl="cuda")
    r16 = ffd_register(fixed, moving, options=opts.replace(compute_dtype="float16"),
                       device="cpu")
    np.testing.assert_allclose(r16.losses, ref16.losses, rtol=1e-3)
    assert r16.warped.dtype == r16.params.dtype == torch.float32
    default = RegistrationOptions(levels=2, iters=10, fused="off", lr=0.5)
    d16 = ffd_register(fixed, moving, options=default.replace(compute_dtype="float16"),
                       device="cpu")
    d32 = ffd_register(fixed, moving, options=default, device="cpu")
    assert d16.warped.dtype == d16.params.dtype == torch.float32
    assert torch.isfinite(d16.params).all() and torch.isfinite(d16.warped).all()
    assert d16.losses[-1] < 1.1 * d32.losses[-1] + 1e-4
    assert (d16.warped - d32.warped).abs().mean().item() < 5e-3


@pytest.mark.parametrize("vol,least", [((40, 32, 24), 0.85), ((80, 64, 48), 0.95)])
def test_f16_cotangent_underflows_as_the_reference_does(monkeypatch, vol, least):
    """The reference's fp16 gradient underflows, and the port copies it.
    ``warp_volume`` widens the fp16 displacement to float32; the backward
    of that cast rounds its cotangent back to fp16, whose least subnormal is
    5.96e-8, and an SSD cotangent of a smooth pair shrinks as 1 / voxels.
    The cotangent that reaches the port's adjoint (one level's SSD on the
    JAX package's pair, a seeded grid) is fp16, exactly 0 in the same share
    of entries as the JAX package's within one percentage point (about 88%
    at 40 x 32 x 24, 96% at 80 x 64 x 48; ``least`` the share it must
    reach), bit for bit the JAX package's cotangent of its Pallas forward's
    field, and the grid gradient within 1e-5 of the largest of the JAX
    package's (its analytic Pallas adjoint)."""
    tile = (5, 5, 5)
    fixed, moving, _ = ref_make_pair(shape=vol, seed=0)
    fixed, moving = np.array(fixed), np.array(moving)
    g = rffd.grid_shape_for_volume(vol, tile)
    phi = (0.5 * np.random.default_rng(0).standard_normal(g + (3,))).astype(np.float32)
    kw = dict(tile=tile, bending_weight=0.0, mode="separable", compute_dtype="float16")
    theirs = np.asarray(jax.grad(ref_level_loss(
        jnp.asarray(fixed), jnp.asarray(moving), impl="pallas", grad_impl="pallas",
        **kw))(jnp.asarray(phi)))
    _, ssd = ref_similarity("ssd")
    disp = rffd.dense_field(jnp.asarray(phi), tile, vol, mode="separable", impl="pallas",
                            compute_dtype="float16")
    _, vjp = jax.vjp(lambda d: ssd(rffd.warp_volume(
        jnp.asarray(moving), d, compute_dtype="float16").astype(jnp.float32),
        jnp.asarray(fixed)), disp)
    (ref_ct,) = vjp(jnp.float32(1.0))
    assert ref_ct.dtype == jnp.float16
    ref_ct = np.asarray(ref_ct, np.float32)

    seen = []
    real = interpolate.bsi_adjoint

    def spy(ct, *args, **kwargs):
        seen.append(ct.detach().clone())
        return real(ct, *args, **kwargs)

    monkeypatch.setattr(interpolate, "bsi_adjoint", spy)
    p = torch.from_numpy(phi).requires_grad_(True)
    loss = ffd_level_loss(torch.from_numpy(fixed), torch.from_numpy(moving), impl="cuda",
                          grad_impl="cuda", **kw)(p)
    loss.backward()
    (ct,) = seen
    assert ct.dtype == F16 and p.grad.dtype == torch.float32
    ours, ref_zero = (ct == 0).float().mean().item(), float((ref_ct == 0).mean())
    assert abs(ours - ref_zero) <= 0.01 and ours >= least, (ours, ref_zero)
    assert np.array_equal(ct.float().numpy(), ref_ct)
    assert np.abs(p.grad.numpy() - theirs).max() <= 1e-5 * np.abs(theirs).max()


def test_subnormal_cotangent_widens_exactly():
    """An fp16 cotangent of subnormals (2^-24 .. 2^-15) and zeros: both plain
    adjoints read each value widened exactly, so the gradient is the
    float32 adjoint of the widened cotangent bit for bit and not zero; no
    value is flushed."""
    rng = np.random.default_rng(9)
    tile, full = (3, 3, 3), (9, 9, 6)
    k = rng.integers(0, 512, full + (3,)) * rng.integers(0, 2, full + (3,))
    g = torch.from_numpy(k.astype(np.float32) * 2.0**-24).to(F16)
    assert torch.equal(g.float(), torch.from_numpy(k.astype(np.float32) * 2.0**-24))
    grid = tuple(n // d + 3 for n, d in zip(full, tile))
    for fn in (ops.bsi_adjoint, ops.bsi_adjoint_matmul):
        out = fn(g, tile, grid)
        assert out.dtype == torch.float32 and out.abs().max().item() > 0
        assert torch.equal(out, fn(g.float(), tile, grid))


def test_fp16_range_is_not_clamped():
    """fp16's largest value is 65504: a grid in voxels lies far inside it,
    and a field beyond it is inf in both packages (nothing clamps)."""
    phi = np.zeros((5, 5, 5, 1), np.float32)
    phi[1:4, 1:4, 1:4] = 7e4
    ours = interpolate.interpolate(torch.from_numpy(phi), (2, 2, 2), mode="separable",
                                   dtype=F16)
    theirs = np.asarray(rinterp.interpolate(jnp.asarray(phi), (2, 2, 2), mode="separable",
                                            dtype=jnp.float16), np.float32)
    assert ours.dtype == F16 and torch.isinf(ours).any()
    assert np.array_equal(np.isinf(ours.float().numpy()), np.isinf(theirs))


def test_f16_dispatch_on_the_cpu_runs_the_plain_versions():
    """On a CPU tensor the dispatchers take fp16 as the plain versions'
    (nothing counted); the counts name an ``_f16`` kernel beside every
    float32 and bf16 one; the bounds of the fp16 kernels are the bf16
    ones' (2 bytes a value)."""
    from repro_torch.kernels import bsi_ttli

    tile, vol = (3, 3, 3), (8, 7, 6)
    phi = torch.from_numpy(np.random.default_rng(1).standard_normal(
        ffd.grid_shape_for_volume(vol, tile) + (3,)).astype(np.float32)).to(F16)
    ops.reset_launch_counts()
    for mode, fn in ops.FORWARD_KERNELS.items():
        assert fn(phi, tile, vol).dtype == F16
    g = torch.ones(vol + (3,), dtype=F16)
    assert ops.bsi_adjoint(g, tile, phi.shape[:3]).dtype == torch.float32
    assert not any(ops.launch_counts().values())
    counts = ops.launch_counts()
    bf16 = [k for k in counts if k.endswith("_bf16")]
    assert len(bf16) == 16 and all(k[:-len("bf16")] + "f16" in counts for k in bf16)
    assert bsi_ttli.ENTRY_SUFFIX[F16] == "f16" and ops._kernel_dtype(phi) == F16
    assert ops._kernel_dtype(phi.double()) == torch.float32  # refused by _check
    bounds = kernel_bounds((512, 228, 385), (5, 5, 5), 3)
    f16 = {k: v for k, v in bounds.items() if k.endswith("_f16")}
    assert len(f16) == 16 and all(bounds[k[:-3] + "bf16"] == v for k, v in f16.items())


def test_the_sources_key_each_branch_on_the_type():
    """No branch of the kernels picks a conversion by the element's size
    (fp16 and bf16 are both 2 bytes: a size-keyed branch would hand an fp16
    value the bf16 conversion); every entry point the loader binds is
    defined in the sources, the fp16 ones included; no build flag flushes
    denormals."""
    text = "\n".join(p.read_text() for p in sorted(CSRC.glob("*.cu*")))
    assert not re.search(r"sizeof\(\w+\)\s*[!=]=\s*sizeof\(float\)", text)
    assert "__half2float" in text and "__floats2half2_rn" in text
    entries = set(re.findall(r'extern "C" int (\w+)\(', text))
    fused = set()
    for suffix in re.findall(r"REPRO_FUSED_ENTRIES\((\w+), [\w ]+\)\n", text):
        fused |= {f"bsi_fused_{k}_{suffix}" for k in ("ssd", "stats", "ncc", "nmi", "lncc")}
    assert set(build._SIGNATURES) <= entries | fused, set(build._SIGNATURES) - entries - fused
    assert all(f"{k}_f16" in build._SIGNATURES for k in (
        "bsi_ttli", "bsi_separable", "bsi_tt", "bsi_matmul", "bsi_adjoint",
        "bsi_adjoint_matmul", "bsi_fused_ssd", "bsi_fused_stats", "bsi_fused_ncc",
        "bsi_fused_nmi", "bsi_fused_lncc"))
    flags = " ".join(build.FLAGS) + repr(build.SOURCE_FLAGS)
    assert "fast_math" not in flags and "ftz=true" not in flags
