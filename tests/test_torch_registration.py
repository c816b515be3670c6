"""The whole slice: the port's ``ffd_register`` against the JAX package's.

The reference is pinned to ``mode="ttli", impl="jnp", grad_impl="jnp",
fused="off"``; the port runs its defaults with ``fused="on"`` (fused level
step, the TTLI and adjoint kernels) on the CPU, where the kernels' plain
versions run.
Registration outputs are held at 1e-4, as the reference holds its own paths.

The multi-modal paths (NCC, NMI) hold per-level losses and the result's MAE
at 1e-4.  Their control grids drift further apart: Adam divides each entry
of the gradient by its own magnitude, so entries near its ``eps`` of 1e-8
carry each package's float32 rounding into the step.  The level gradient of
the JAX package is 1e-5 (NMI) and 3e-6 (NCC) of its largest entry from a
float64 evaluation, this package's under 1e-6; a test pins that.

LNCC in the matrix form (``mode="matmul", grad_impl="matmul"``) is held
against the reference's ``mode="matmul", impl="jnp", grad_impl="jnp",
fused="off"``: per-level losses and MAE at 1e-4.  Both packages' level
gradients are within 2e-6 of float64 (a test pins it), yet after Adam's ten
steps the control grids differ by up to 3.0e-4 of entries of magnitude 3.3,
for the same reason; they are held at 1e-3.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import metrics as rmetrics  # noqa: E402
from repro.core import similarity as rsim  # noqa: E402
from repro.core.options import RegistrationOptions as RefOptions  # noqa: E402
from repro.core.registration import ffd_register as ref_register  # noqa: E402
from repro.data.volumes import make_pair as ref_make_pair  # noqa: E402
from repro.core.ffd import downsample2 as rffd_downsample2  # noqa: E402
from repro.core.ffd import grid_shape_for_volume as rffd_grid_shape  # noqa: E402
from repro.engine.batch import ffd_level_loss as ref_level_loss  # noqa: E402
from repro_torch import (ConvergenceConfig, RegistrationOptions,  # noqa: E402
                         ffd_register, make_pair)
from repro_torch.convert import (grid_from_numpy, options_from_reference,  # noqa: E402
                                 reference_fields)
from repro_torch.core import metrics  # noqa: E402
from repro_torch.core import similarity as tsim  # noqa: E402
from repro_torch.core.regularizer import resolve_regularizer  # noqa: E402
from repro_torch.core.transform import resolve_transform  # noqa: E402
from repro_torch.engine.optimizer import resolve_optimizer  # noqa: E402
from repro_torch.engine.batch import ffd_level_loss, ffd_level_objective  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
SHAPE = (28, 24, 20)
REF_FIELDS = dict(mode="ttli", impl="jnp", grad_impl="jnp", fused="off", levels=2,
                  iters=5)


@pytest.fixture(scope="module")
def pair():
    return tuple(np.array(a) for a in ref_make_pair(SHAPE, seed=0))  # writable


@pytest.fixture(scope="module")
def ref_result(pair):
    fixed, moving, _ = pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ref_register(fixed, moving, options=RefOptions(**REF_FIELDS))


def test_make_pair_matches_reference(pair):
    fixed, moving, phi_true = make_pair(SHAPE, seed=0, device="cpu")
    assert np.array_equal(fixed.numpy(), pair[0])
    assert np.array_equal(phi_true.numpy(), pair[2])
    np.testing.assert_allclose(moving.numpy(), pair[1], atol=1e-5)


def test_ffd_register_matches_reference(pair, ref_result):
    fixed, moving, _ = pair
    out = ffd_register(fixed, moving, options=RegistrationOptions(levels=2, iters=5,
                                                                  fused="on"),
                       device="cpu")
    assert out.params.dtype == torch.float32
    np.testing.assert_allclose(out.losses, ref_result.losses, rtol=1e-4)
    np.testing.assert_allclose(out.params.numpy(), np.asarray(ref_result.params),
                               atol=1e-4)
    np.testing.assert_allclose(out.warped.numpy(), np.asarray(ref_result.warped),
                               atol=1e-4)


def test_level_loss_and_gradient_from_a_reference_grid(pair, ref_result):
    fixed, moving, _ = pair
    phi_np = np.asarray(ref_result.params)
    kw = dict(tile=(5, 5, 5), bending_weight=5e-3, mode="ttli")
    ref_loss, ref_grad = jax.value_and_grad(ref_level_loss(
        jnp.asarray(fixed), jnp.asarray(moving), impl="jnp", grad_impl="jnp", **kw))(
            jnp.asarray(phi_np))
    opts = options_from_reference(REF_FIELDS)
    phi = grid_from_numpy(phi_np, "cpu")
    loss, grad = ffd_level_objective(
        torch.from_numpy(fixed), torch.from_numpy(moving), impl="cuda",
        grad_impl="cuda", fused="on", **kw).vg(phi)
    assert opts.impl == "torch" and opts.grad_impl == "torch"
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref_grad = np.asarray(ref_grad)
    assert np.abs(grad.numpy() - ref_grad).max() <= 1e-5 * np.abs(ref_grad).max()


@pytest.fixture(scope="module")
def remapped_pair(pair):
    fixed, moving, _ = pair
    return fixed, ((1.0 - moving) ** 1.5).astype(np.float32)


@pytest.mark.parametrize("similarity,params_atol", [("nmi", 0.05), ("ncc", 2e-3)])
def test_multimodal_ffd_register_matches_reference(remapped_pair, similarity,
                                                    params_atol):
    fixed, remapped = remapped_pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_register(fixed, remapped, options=RefOptions(
            similarity=similarity, **REF_FIELDS))
    out = ffd_register(fixed, remapped, options=RegistrationOptions(
        levels=2, iters=5, similarity=similarity, fused="on"), device="cpu")
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-4)
    ref_mae = float(rmetrics.mae(ref.warped, fixed))
    mae = metrics.mae(out.warped, torch.from_numpy(fixed)).item()
    assert abs(mae - ref_mae) <= 1e-4 * ref_mae
    # the grids: see the module docstring (measured 0.019 and 5.5e-4)
    np.testing.assert_allclose(out.params.numpy(), np.asarray(ref.params),
                               atol=params_atol)


@pytest.mark.parametrize("similarity,ref_bound", [("nmi", 1e-4), ("ncc", 2e-5)])
def test_multimodal_level_gradient_against_float64(remapped_pair, similarity,
                                                   ref_bound):
    """At ``phi = 0`` of the coarse level: this package's fused level gradient
    within 1e-6 of a float64 evaluation of the same objective, the JAX
    package's within ``ref_bound`` of it."""
    fixed, remapped = (np.asarray(rffd_downsample2(v)) for v in remapped_pair)
    phi = np.zeros(rffd_grid_shape(fixed.shape, (5, 5, 5)) + (3,), np.float32)
    kw = dict(tile=(5, 5, 5), bending_weight=5e-3, mode="ttli", similarity=similarity)
    _, ref_g = jax.value_and_grad(ref_level_loss(
        jnp.asarray(fixed), jnp.asarray(remapped), impl="jnp", grad_impl="jnp", **kw))(
            jnp.asarray(phi))
    f, m = torch.from_numpy(fixed), torch.from_numpy(remapped)
    _, g = ffd_level_objective(f, m, impl="cuda", grad_impl="cuda", fused="on",
                               **kw).vg(torch.from_numpy(phi))
    p64 = torch.from_numpy(phi).double().requires_grad_(True)
    loss64 = ffd_level_loss(f.double(), m.double(), impl="torch", grad_impl="autograd",
                            fused="off", **kw)(p64)
    (g64,) = torch.autograd.grad(loss64, p64)
    scale = g64.abs().max().item()
    assert (g.double() - g64).abs().max().item() <= 1e-6 * scale
    assert np.abs(np.asarray(ref_g, np.float64) - g64.numpy()).max() <= ref_bound * scale


def test_measure_bsi_time_reports_seconds(pair):
    fixed, moving, _ = pair
    opts = RegistrationOptions(levels=1, iters=1)
    out = ffd_register(fixed, moving, options=opts, device="cpu",
                       measure_bsi_time=True)
    assert out.bsi_seconds > 0 and len(out.losses) == 1


@pytest.mark.parametrize("fields,error,match", [
    (dict(transform="velocity", fused="on"), ValueError, "transform='velocity'"),
    (dict(optimizer="gauss_newton", similarity="ncc"), ValueError, "similarity='ssd'"),
    (dict(optimizer="gauss_newton", fused="on"), ValueError, "gauss_newton"),
    (dict(compute_dtype="int8"), ValueError, "compute_dtype must be one of"),
    (dict(grad_impl="xla"), ValueError, "grad_impl must be one of"),
    (dict(mode="gather"), ValueError, "no kernel"),
    (dict(grad_impl="autograd"), ValueError, "autograd"),
    (dict(impl="pallas"), ValueError, "impl must be one of"),
    (dict(iters=0), ValueError, "iters"),
    (dict(mode="auto", grad_impl="autograd"), ValueError, "autograd"),
    (dict(fused="sideways"), ValueError, "fused must be one of"),
    (dict(similarity=lambda w, f: (w - f).abs().mean(), fused="on"), ValueError,
     "no fused kernel"),
    (dict(stop=1e-4), TypeError, "ConvergenceConfig"),
])
def test_options_name_what_is_not_ported(fields, error, match):
    with pytest.raises(error, match=match):
        RegistrationOptions(**fields)


@pytest.mark.parametrize("fields", [
    dict(similarity="lncc"),
    dict(mode="matmul"),
    dict(grad_impl="matmul"),
    dict(similarity="lncc", mode="matmul", grad_impl="matmul"),
    dict(impl="torch", mode="tt", grad_impl="matmul"),
    dict(impl="auto"),
    dict(fused="auto"),
    dict(mode="tt"),
    dict(mode="separable"),
    dict(mode="tt", grad_impl="matmul"),
    dict(mode="auto", impl="auto", grad_impl="auto", fused="auto"),
    dict(mode="gather", impl="auto", grad_impl="autograd"),
    dict(similarity=lambda w, f: (w - f).abs().mean(), fused="auto"),
    dict(transform="velocity"),
    dict(regularizer="bending"),
    dict(optimizer="lbfgs"),
    dict(optimizer="gauss_newton"),
    dict(stop=ConvergenceConfig()),
    dict(compute_dtype="float16"),
], ids=lambda f: "-".join(f"{k}={v if isinstance(v, str) else 'fn'}"
                          for k, v in f.items()))
def test_options_accept_what_is_ported(fields):
    opts = RegistrationOptions(**fields)
    # transform, regularizer and optimizer names canonicalise to their specs
    canonical = {"transform": resolve_transform, "regularizer": resolve_regularizer,
                 "optimizer": resolve_optimizer}
    assert all(getattr(opts, k) == canonical.get(k, lambda v: v)(v)
               for k, v in fields.items())
    assert opts.fused == fields.get("fused", "auto") and opts.fused_reason is None


def test_default_fused_is_auto():
    assert RegistrationOptions().fused == "auto"
    assert RegistrationOptions(similarity=lambda w, f: ((w - f) ** 2).mean()).fused == "auto"


def test_callable_similarity_with_default_options_matches_reference(pair):
    """A loss callable with the default options registers on the CPU
    (``fused="auto"`` resolves ``"off"``: the callable has no fused kernel),
    as the JAX package's default call does with the same callable."""
    fixed, moving, _ = pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_register(fixed, moving, options=RefOptions(
            similarity=lambda w, f: jnp.mean(jnp.abs(w - f)), mode="ttli", impl="jnp",
            grad_impl="jnp", levels=2, iters=5))
    out = ffd_register(fixed, moving, options=RegistrationOptions(
        similarity=lambda w, f: (w - f).abs().mean(), levels=2, iters=5), device="cpu")
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-4)
    ref_mae = float(rmetrics.mae(ref.warped, fixed))
    mae = metrics.mae(out.warped, torch.from_numpy(fixed)).item()
    assert abs(mae - ref_mae) <= 1e-4 * ref_mae


def test_options_from_reference_maps_the_renamed_values():
    ref = RefOptions(**REF_FIELDS)
    fields = {k: getattr(ref, k) for k in ref.__dataclass_fields__}
    opts = options_from_reference(fields)
    assert (opts.mode, opts.impl, opts.grad_impl, opts.fused) == (
        "ttli", "torch", "torch", "off")
    assert (opts.levels, opts.iters, opts.tile) == (2, 5, (5, 5, 5))
    pallas = options_from_reference(dict(impl="pallas", grad_impl="pallas",
                                         fused=True))
    assert (pallas.impl, pallas.grad_impl, pallas.fused) == ("cuda", "cuda", "on")
    matmul = options_from_reference(dict(mode="matmul", impl="pallas",
                                         grad_impl="matmul"))
    assert (matmul.mode, matmul.impl, matmul.grad_impl) == ("matmul", "cuda", "matmul")
    # the JAX package's defaults are all "auto", and map through
    default = RefOptions()
    auto = options_from_reference({k: getattr(default, k)
                                   for k in default.__dataclass_fields__})
    assert (auto.mode, auto.impl, auto.grad_impl, auto.fused) == ("auto",) * 4
    assert reference_fields(auto) == dict(mode="auto", impl="auto", grad_impl="auto",
                                          fused="auto")
    assert reference_fields(opts) == {k: REF_FIELDS[k] for k in (
        "mode", "impl", "grad_impl", "fused")}
    # the second-order optimisers, bf16 and float16 are ported; a type that
    # is not a float is refused
    assert options_from_reference(dict(optimizer="lbfgs")).optimizer == resolve_optimizer(
        "lbfgs")
    assert options_from_reference(dict(compute_dtype="bfloat16")).compute_dtype == "bfloat16"
    assert options_from_reference(dict(compute_dtype="float16")).compute_dtype == "float16"
    with pytest.raises(ValueError, match="compute_dtype"):
        options_from_reference(dict(compute_dtype="int8"))


@pytest.mark.parametrize("field", ["transform", "regularizer", "optimizer", "stop"])
def test_options_from_reference_carries_spec_parameters(field):
    """A non-default spec of each kind keeps its fields across (the mapping
    used to keep only the name: ``velocity(squarings=4)`` became 6
    squarings)."""
    from repro.core import regularizer as rreg, transform as rtf
    from repro.engine import convergence as rconv, optimizer as ropt

    ref_value = {"transform": rtf.velocity(squarings=4),
                 "regularizer": rreg.bending(weight=5e-3),
                 "optimizer": ropt.lbfgs(history=5, max_ls=7, c1=1e-3, shrink=0.25),
                 "stop": rconv.ConvergenceConfig(tol=1e-3, patience=3, max_iters=9)}[field]
    value = getattr(options_from_reference({field: ref_value}), field)
    assert type(value).__module__.startswith("repro_torch.")
    assert dataclasses.asdict(value) == dataclasses.asdict(ref_value)
    gn = ropt.gauss_newton(cg_iters=4, damping=1e-2, damp_up=5.0, damp_down=2.0)
    out = options_from_reference(dict(optimizer=gn)).optimizer
    assert dataclasses.asdict(out) == dataclasses.asdict(gn)


def test_options_from_reference_carries_similarity_callables():
    for ref_fn, fn in ((rsim.nmi(bins=16), tsim.nmi(bins=16)),
                       (rsim.lncc(window=5), tsim.lncc(window=5)),
                       (rsim.nmi(), tsim.nmi()), (rsim.ncc_loss, tsim.ncc_loss)):
        opts = options_from_reference(dict(similarity=ref_fn, fused="off"))
        assert opts.similarity is fn
        assert tsim.fused_spec(opts.similarity) == rsim.fused_spec(ref_fn)
    ref = RefOptions(similarity=rsim.nmi(bins=16), **REF_FIELDS)
    fields = {k: getattr(ref, k) for k in ref.__dataclass_fields__}
    assert options_from_reference(fields).similarity is tsim.nmi(bins=16)
    assert options_from_reference(dict(similarity="nmi")).similarity == "nmi"
    fused = options_from_reference(dict(similarity=rsim.lncc(window=5), fused="on"))
    assert fused.similarity is tsim.lncc(window=5) and fused.fused == "on"


@pytest.mark.parametrize("similarity", ["ncc", "lncc", "nmi"])
def test_similarity_reaches_the_level_loss_unchanged(remapped_pair, similarity):
    """The fused level objective of the options' similarity equals the JAX
    package's level loss at ``phi = 0``, on the remapped pair (on the
    mono-modal pair ``1 - NCC`` cancels to 0.078, where the JAX package's
    float32 value is 1.6e-4 from float64 and this package's 4e-8)."""
    fixed, moving = remapped_pair
    opts = RegistrationOptions(similarity=similarity, impl="torch", grad_impl="torch",
                               fused="on")
    kw = dict(tile=opts.tile, bending_weight=opts.bending_weight, mode="ttli")
    phi = np.zeros(rffd_grid_shape(fixed.shape, opts.tile) + (3,), np.float32)
    ref = float(ref_level_loss(jnp.asarray(fixed), jnp.asarray(moving), impl="jnp",
                               similarity=similarity, **kw)(jnp.asarray(phi)))
    loss = ffd_level_objective(torch.from_numpy(fixed), torch.from_numpy(moving),
                               impl=opts.impl, grad_impl=opts.grad_impl,
                               similarity=opts.similarity, fused=opts.fused, **kw)
    assert abs(loss.vg(torch.from_numpy(phi))[0].item() - ref) <= 1e-5 * abs(ref)


LNCC_MATMUL = dict(similarity="lncc", mode="matmul", grad_impl="matmul")


def test_lncc_matmul_ffd_register_matches_reference(pair):
    """The slice: LNCC with the matrix-form forward, fused step and adjoint
    against the reference's plain matrix form, unfused (module docstring)."""
    fixed, moving, _ = pair
    fields = dict(REF_FIELDS, mode="matmul", similarity="lncc")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_register(fixed, moving, options=RefOptions(**fields))
    ops.reset_launch_counts()
    out = ffd_register(fixed, moving, options=RegistrationOptions(
        levels=2, iters=5, fused="on", **LNCC_MATMUL), device="cpu")
    assert not any(ops.launch_counts().values())  # the plain versions ran
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-4)
    ref_mae = float(rmetrics.mae(ref.warped, fixed))
    mae = metrics.mae(out.warped, torch.from_numpy(fixed)).item()
    assert abs(mae - ref_mae) <= 1e-4 * ref_mae
    assert mae < float(rmetrics.mae(moving, fixed))
    np.testing.assert_allclose(out.warped.numpy(), np.asarray(ref.warped), atol=1e-4)
    np.testing.assert_allclose(out.params.numpy(), np.asarray(ref.params), atol=1e-3)


@pytest.mark.parametrize("coarse", [True, False], ids=["coarse", "fine"])
def test_lncc_matmul_level_gradient_against_float64(pair, coarse):
    """At a random grid of each level: this package's fused LNCC gradient in
    the matrix form and the JAX package's unfused one both within 2e-6 of a
    float64 evaluation (of the largest entry), so within 4e-6 of each other."""
    fixed, moving, _ = pair
    if coarse:
        fixed, moving = (np.asarray(rffd_downsample2(v)) for v in (fixed, moving))
    rng = np.random.default_rng(3)
    phi = (rng.standard_normal(rffd_grid_shape(fixed.shape, (5, 5, 5)) + (3,))
           * 0.3).astype(np.float32)
    kw = dict(tile=(5, 5, 5), bending_weight=5e-3, mode="matmul", similarity="lncc")
    _, ref_g = jax.value_and_grad(ref_level_loss(
        jnp.asarray(fixed), jnp.asarray(moving), impl="jnp", grad_impl="jnp", **kw))(
            jnp.asarray(phi))
    f, m = torch.from_numpy(fixed), torch.from_numpy(moving)
    _, g = ffd_level_objective(f, m, impl="cuda", grad_impl="matmul", fused="on",
                               **kw).vg(torch.from_numpy(phi))
    p64 = torch.from_numpy(phi).double().requires_grad_(True)
    loss64 = ffd_level_loss(f.double(), m.double(), impl="torch", grad_impl="autograd",
                            fused="off", **kw)(p64)
    (g64,) = torch.autograd.grad(loss64, p64)
    scale = g64.abs().max().item()
    ref_g = np.asarray(ref_g, np.float64)
    assert (g.double() - g64).abs().max().item() <= 2e-6 * scale
    assert np.abs(ref_g - g64.numpy()).max() <= 2e-6 * scale
    assert np.abs(g.double().numpy() - ref_g).max() <= 4e-6 * scale
