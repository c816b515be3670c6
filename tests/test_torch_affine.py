"""``affine_register`` against the JAX package's, on ``make_pair((28, 24, 20))``.

SSD with Adam (the defaults, ``iters=60, lr=0.02``), NCC with Adam and
Adam under ``stop=`` hold ``theta``, the losses and the warp at 1e-4.

L-BFGS and Gauss-Newton take discrete decisions on loss differences and
solve a 12-unknown system by CG, where a float32 rounding moves the answer
far more than on the grid: the reference's own first Gauss-Newton step
moves by 2.8e-3 of its largest entry when its gradient changes by one ulp,
and its whole runs move ``theta`` by 2.2e-3 (L-BFGS) and 1.6e-2
(Gauss-Newton) when the moving volume changes by one ulp.  So their
linearisation is held against ``jax.linearize`` at 1e-5, and their steps on
the reference's own objective (``test_torch_optimizer.reference_objective``)
from the reference's states: L-BFGS at 1e-5, Gauss-Newton at 1e-3 beside
the reference's own sensitivity.  Whole runs are held beside the
reference's one-ulp spread, which the test measures: the losses at 1e-3,
``theta`` at 1e-2 of its largest entry, the warp at 1e-2.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import registration as rreg  # noqa: E402
from repro.core.options import RegistrationOptions as RefOptions  # noqa: E402
from repro.data.volumes import make_pair as ref_make_pair  # noqa: E402
from repro.engine import optimizer as ropt  # noqa: E402
from repro.engine.convergence import ConvergenceConfig as RefStop  # noqa: E402
from repro_torch import (ConvergenceConfig, RegistrationOptions,  # noqa: E402
                         affine_register)
from repro_torch.convert import options_from_reference, theta_from_numpy  # noqa: E402
from repro_torch.core import registration as treg  # noqa: E402
from repro_torch.engine import optimizer as topt  # noqa: E402
from test_torch_optimizer import reference_objective  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
SHAPE = (28, 24, 20)


@pytest.fixture(scope="module")
def pair():
    return tuple(np.array(a) for a in ref_make_pair(SHAPE, seed=0))


def _ref(fixed, moving, fields):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return rreg.affine_register(fixed, moving, options=RefOptions(**fields))


@pytest.mark.parametrize("fields", [
    dict(iters=60, lr=0.02),
    dict(iters=60, lr=0.02, similarity="ncc"),
    dict(iters=60, lr=0.02, stop=RefStop(tol=1e-3, patience=3)),
], ids=["ssd-adam", "ncc-adam", "ssd-adam-stop"])
def test_affine_register_matches_reference(pair, fields):
    fixed, moving, _ = pair
    ref = _ref(fixed, moving, fields)
    out = affine_register(fixed, moving, options=options_from_reference(fields),
                          device="cpu")
    assert out.params.shape == (3, 4) and out.params.dtype == torch.float32
    assert len(out.losses) == len(ref.losses)
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(out.params.numpy(), np.asarray(ref.params), atol=1e-4)
    np.testing.assert_allclose(out.warped.numpy(), np.asarray(ref.warped), atol=1e-4)
    assert out.steps == ref.steps
    if "stop" in fields:
        assert out.steps[0] < fields["iters"]  # it stopped early


def test_affine_defaults_and_losses_marks(pair):
    """No options: ``AFFINE_DEFAULTS`` (60 steps at lr 0.02), the loss at
    every 10th step and the last; the SSD falls."""
    fixed, moving, _ = pair
    out = affine_register(fixed, moving, device="cpu")
    trace = out.traces[0]
    assert trace.shape == (60,) and out.steps is None
    assert out.losses == [trace[i - 1].item() for i in (10, 20, 30, 40, 50, 60)]
    assert out.losses[-1] < float(np.mean((moving - fixed) ** 2))
    assert treg.AFFINE_DEFAULTS.iters == 60 and treg.AFFINE_DEFAULTS.lr == 0.02


def _ref_objective(fixed, moving):
    shape = fixed.shape
    f, m = jnp.asarray(fixed), jnp.asarray(moving)
    return ropt.make_objective(
        lambda th: jnp.mean((rreg._affine_warp(th, m, shape) - f) ** 2),
        residual_fn=lambda th: (rreg._affine_warp(th, m, shape) - f).ravel())


def _t(a):
    return torch.from_numpy(np.array(a))


def test_affine_linearization_matches_reference(pair):
    """The SSD objective's ``linearize``: the residual, ``J v`` and
    ``J^T w`` against ``jax.linearize`` of the reference's at 1e-5 of the
    largest entry, at 0 and at a random affine."""
    fixed, moving, _ = pair
    robj = _ref_objective(fixed, moving)
    tobj = treg._affine_objective(torch.from_numpy(fixed), torch.from_numpy(moving))
    rng = np.random.default_rng(4)
    v = rng.standard_normal((3, 4)).astype(np.float32)
    w = rng.standard_normal(fixed.size).astype(np.float32)
    for theta in (np.zeros((3, 4), np.float32),
                  (rng.standard_normal((3, 4)) * [0.05, 0.05, 0.05, 1.0]).astype(
                      np.float32)):
        r0, lin = jax.linearize(robj.residual, jnp.asarray(theta))
        refs = (r0, lin(jnp.asarray(v)),
                jax.linear_transpose(lin, jnp.asarray(theta))(jnp.asarray(w))[0])
        r, jvp, vjp = tobj.linearize(torch.from_numpy(theta))
        outs = (r, jvp(torch.from_numpy(v)), vjp(torch.from_numpy(w)))
        for out, ref in zip(outs, refs):
            ref = np.asarray(ref)
            assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("name", ["lbfgs", "gauss_newton"])
def test_affine_second_order_steps_from_identical_state(pair, name):
    """Five states along the reference's trajectory from ``theta = 0``; from
    each, one step of each package on the reference's objective: ``ok``,
    ``hlen`` and the damping equal, ``p1`` within 1e-5 (L-BFGS, measured
    8e-8) or 1e-3 (Gauss-Newton, measured 1.2e-4) of the reference's.  The
    reference's own first Gauss-Newton step moves by more than 1e-3 when its
    gradient changes by one ulp (module docstring)."""
    robj = _ref_objective(*pair[:2])
    shared = reference_objective(robj)
    tol = 1e-5 if name == "lbfgs" else 1e-3
    rp = jnp.zeros((3, 4), jnp.float32)
    ro = ropt.init_state(name, rp)
    rl, rg = robj.vg(rp)
    for k in range(5):
        state = {key: _t(v) for key, v in ro.items()}
        tp1, to1, _, _, tok = topt.opt_step(name, shared, k, _t(rp), state, _t(rg),
                                            torch.tensor(float(rl)), lr=0.02)
        rp1, ro1, rg1, rl1, rok = ropt.opt_step(name, robj, jnp.int32(k), rp, ro, rg, rl,
                                                lr=0.02)
        assert bool(tok) == bool(rok)
        scale = np.abs(np.asarray(rp1)).max()
        assert np.abs(tp1.numpy() - np.asarray(rp1)).max() <= tol * scale, k
        for key in ("hlen", "damping"):
            if key in ro1:
                assert to1[key].item() == np.asarray(ro1[key]).item()
        if name == "gauss_newton" and k == 0:
            nudged = jnp.asarray(np.nextafter(np.asarray(rg), np.float32(np.inf)))
            rn = ropt.opt_step(name, robj, jnp.int32(k), rp, ro, nudged, rl, lr=0.02)[0]
            assert np.abs(np.asarray(rn) - np.asarray(rp1)).max() > 1e-3 * scale
        rp, ro, rg, rl = rp1, ro1, rg1, rl1


@pytest.mark.parametrize("fields", [dict(iters=10, optimizer="lbfgs"),
                                    dict(iters=5, optimizer="gauss_newton")],
                         ids=["lbfgs", "gauss_newton"])
def test_affine_second_order_runs_match_reference(pair, fields):
    """The port's run beside the reference's run on the same pair and on
    the moving volume changed by one ulp.  The reference's own spread:
    ``theta`` over 1e-3 of its largest entry (measured 2.2e-3 and 1.6e-2;
    the losses 1.7e-4 and 4.8e-4, the warp 3.9e-3 and 1.1e-2).  The port's
    from the reference: the losses within 1e-3 (measured 1.6e-4 both),
    ``theta`` within 1e-2 of its largest entry (1.5e-3 and 4.8e-3) and the
    warp within 1e-2 (4.1e-3 and 5.7e-3)."""
    fixed, moving, _ = pair
    ref = _ref(fixed, moving, fields)
    ref_nudged = _ref(fixed, np.nextafter(moving, np.float32(np.inf)), fields)
    out = affine_register(fixed, moving, options=options_from_reference(fields),
                          device="cpu")
    theta = np.asarray(ref.params)
    scale = np.abs(theta).max()
    assert np.abs(np.asarray(ref_nudged.params) - theta).max() > 1e-3 * scale
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-3)
    assert np.abs(out.params.numpy() - theta).max() <= 1e-2 * scale
    np.testing.assert_allclose(out.warped.numpy(), np.asarray(ref.warped), atol=1e-2)
    assert out.losses[-1] < float(np.mean((moving - fixed) ** 2))


def test_affine_warp_is_full_float32_whatever_tf32_says(pair):
    """The 3x3 product is multiply-adds, not a matmul: the warp is the same
    bit for bit with TF32 allowed, and equals the reference's at 1e-5."""
    fixed, moving, _ = pair
    rng = np.random.default_rng(0)
    theta = (rng.standard_normal((3, 4)) * np.array([0.05, 0.05, 0.05, 1.0])).astype(
        np.float32)
    m = torch.from_numpy(moving)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = treg._affine_warp(theta_from_numpy(theta, "cpu"), m, SHAPE)
        torch.backends.cuda.matmul.allow_tf32 = False
        full = treg._affine_warp(theta_from_numpy(theta, "cpu"), m, SHAPE)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert torch.equal(tf32, full)
    ref = np.asarray(rreg._affine_warp(jnp.asarray(theta), jnp.asarray(moving), SHAPE))
    assert np.abs(full.numpy() - ref).max() <= 1e-5


def test_affine_options_pin_the_ffd_fields():
    opts = RegistrationOptions(tile=(4, 4, 4), levels=3, transform="velocity",
                               regularizer="bending", optimizer="lbfgs",
                               stop=ConvergenceConfig()).for_affine()
    base = RegistrationOptions()
    assert (opts.tile, opts.levels, opts.transform, opts.regularizer) == (
        base.tile, base.levels, base.transform, base.regularizer)
    assert opts.fused == "off" and opts.optimizer == topt.lbfgs()
    assert opts.stop.max_iters == opts.iters  # resolved
    with pytest.raises(ValueError, match="similarity='ssd'"):
        RegistrationOptions(optimizer="gauss_newton", similarity="ncc")
    with pytest.raises(ValueError, match="shape"):
        affine_register(np.zeros((4, 4, 4)), np.zeros((4, 4, 5)), device="cpu")
    with pytest.raises(ValueError, match=r"\(3, 4\)"):
        theta_from_numpy(np.zeros((3, 3)), "cpu")
