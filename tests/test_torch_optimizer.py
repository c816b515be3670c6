"""L-BFGS, Gauss-Newton and early stopping against the JAX package's
``repro.engine.optimizer`` and ``repro.engine.convergence``.

Line searches and LM trials take discrete decisions, and rounding moves
them, so single steps are held first: from one state ``(p, g, loss, s, y,
rho, hlen)`` or ``(p, g, loss, damping)``, the reference's own, each package
takes one step on the coarse level of ``make_pair((28, 24, 20))`` (tile 5),
with ``ok``, ``hlen`` and the damping equal.  On the reference's own
objective (its jitted functions, :func:`reference_objective`) the port's
``p1`` agrees with the reference's at 1e-5; on the port's objective at 1e-5
for Gauss-Newton and 1e-4 for L-BFGS, whose quadratic refinement divides by
``f(p + t d) - f(p) - t g.d``, a difference of nearly equal losses, so it
carries each package's loss rounding into the step (the reference's
float32 SSD rounds further from float64 than the port's:
``test_reference_ssd_rounding_at_the_fine_level``).  ``optimize_until`` is
held on the traces and ``steps``, the Gauss-Newton linearisation against
``jax.linearize`` of the reference's residual, and the whole
``ffd_register`` for every new option with the reference pinned to
``mode="ttli", impl="jnp", grad_impl="jnp", fused="off"`` (velocity and
bending with Adam are held in ``tests/test_torch_transform.py`` and
``tests/test_torch_regularizer.py``).

The reference pins float32 itself (its ``ffd_register`` casts the volumes
and the grid to float32, its loss and its steps cast to float32), so
enabling JAX's x64 does not give a float64 oracle.  Where a whole run's
grids split, the split is named and held instead (``SPLITS``).
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.ffd import downsample2 as rdownsample2  # noqa: E402
from repro.core.ffd import grid_shape_for_volume as rgrid_shape  # noqa: E402
from repro.core.options import RegistrationOptions as RefOptions  # noqa: E402
from repro.core.registration import ffd_register as ref_register  # noqa: E402
from repro.data.volumes import make_pair as ref_make_pair  # noqa: E402
from repro.engine import batch as rbatch  # noqa: E402
from repro.engine import convergence as rconv  # noqa: E402
from repro.engine import optimizer as ropt  # noqa: E402
from repro_torch import (ConvergenceConfig, ffd_register,  # noqa: E402
                         gauss_newton, lbfgs)
from repro_torch.convert import options_from_reference  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.engine import batch as tbatch  # noqa: E402
from repro_torch.engine import convergence as tconv  # noqa: E402
from repro_torch.engine import optimizer as topt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
SHAPE, TILE = (28, 24, 20), (5, 5, 5)
REF_FIELDS = dict(mode="ttli", impl="jnp", grad_impl="jnp", fused="off", levels=2,
                  iters=5)


@pytest.fixture(scope="module")
def pair():
    return tuple(np.array(a) for a in ref_make_pair(SHAPE, seed=0))


@pytest.fixture(scope="module")
def coarse(pair):
    return tuple(np.asarray(rdownsample2(v)) for v in pair[:2])


def _objectives(f, m, regularizer="none"):
    kw = dict(tile=TILE, bending_weight=5e-3, mode="ttli", regularizer=regularizer)
    ref = rbatch.ffd_level_objective(jnp.asarray(f), jnp.asarray(m), impl="jnp",
                                     grad_impl="jnp", **kw)
    port = tbatch.ffd_level_objective(torch.from_numpy(f), torch.from_numpy(m),
                                      impl="cuda", grad_impl="cuda", **kw)
    return ref, port


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(t):
    return jnp.asarray(t.detach().numpy())


class _JaxTerm(torch.autograd.Function):
    """A scalar JAX function of the params as a torch function, its
    backward ``jax.vjp``'s."""

    @staticmethod
    def forward(ctx, p, fn):
        out, ctx.vjp = jax.vjp(fn, _j(p))
        return _t(out)

    @staticmethod
    def backward(ctx, g):
        return _t(ctx.vjp(_j(g))[0]), None


def reference_objective(robj):
    """The reference's ``Objective`` as the port's: its loss, value-and-grad
    and linearisation, jitted as its own steps compile them, so both
    packages' steps see the same numbers."""
    loss, vg = jax.jit(robj.loss), jax.jit(robj.vg)

    @jax.jit
    def jvp(p, v):
        return jax.linearize(robj.residual, p)[1](v)

    @jax.jit
    def vjp(p, w):
        _, lin = jax.linearize(robj.residual, p)
        return jax.linear_transpose(lin, p)(w)[0]

    def linearize(p):
        pj = _j(p)
        return (_t(robj.residual(pj)), lambda v: _t(jvp(pj, _j(v))),
                lambda w: _t(vjp(pj, _j(w))))

    def t_vg(p):
        value, grad = vg(_j(p))
        return _t(value), _t(grad)

    reg = None if robj.reg is None else (lambda p: _JaxTerm.apply(p, robj.reg))
    return topt.Objective(loss=lambda p: _t(loss(_j(p))), vg=t_vg, reg=reg,
                          linearize=linearize if robj.residual is not None else None)


# --- the specs


def test_specs_tokens_and_validation_match_reference():
    for name in ("adam", "lbfgs", "gauss_newton"):
        assert topt.optimizer_token(name) == ropt.optimizer_token(name)
    assert topt.optimizer_token(lbfgs(history=5)) == ropt.optimizer_token(
        ropt.lbfgs(history=5))
    assert topt.optimizer_token(gauss_newton(cg_iters=4, damping=1e-2)) == (
        ropt.optimizer_token(ropt.gauss_newton(cg_iters=4, damping=1e-2)))
    assert topt.available_optimizers() == ["adam", "gauss_newton", "lbfgs"]
    assert topt.resolve_optimizer("lbfgs") == lbfgs()
    for bad in (dict(history=0), dict(max_ls=65), dict(c1=1.0), dict(shrink=0.0)):
        with pytest.raises(ValueError):
            lbfgs(**bad)
    for bad in (dict(cg_iters=0), dict(damping=0.0), dict(damp_up=1.0)):
        with pytest.raises(ValueError):
            gauss_newton(**bad)


def test_init_state_matches_reference():
    p = torch.zeros(9, 8, 7, 3)
    for name in ("adam", "lbfgs", "gauss_newton"):
        ref = ropt.init_state(name, jnp.zeros((9, 8, 7, 3)))
        out = topt.init_state(name, p)
        assert sorted(out) == sorted(ref)
        for k, v in ref.items():
            assert tuple(out[k].shape) == tuple(v.shape)
            assert str(out[k].dtype).endswith(str(np.asarray(v).dtype))
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(v))


# --- single steps from identical state


def _reference_states(robj, name, n, vol_shape):
    """``n`` states along the reference's own trajectory from a random grid,
    each with the reference's step from it."""
    rng = np.random.default_rng(1)
    rp = jnp.asarray((rng.standard_normal(rgrid_shape(vol_shape, TILE) + (3,))
                      * 0.3).astype(np.float32))
    ro = ropt.init_state(name, rp)
    rl, rg = robj.vg(rp)
    for k in range(n):
        out = ropt.opt_step(name, robj, jnp.int32(k), rp, ro, rg, rl, lr=0.5)
        yield k, (rp, ro, rg, rl), out
        rp, ro, rg, rl = out[:4]


def _port_step(name, obj, k, state):
    rp, ro, rg, rl = state
    return topt.opt_step(name, obj, k, _t(rp), {key: _t(v) for key, v in ro.items()},
                         _t(rg), torch.tensor(float(rl)), lr=0.5)


# p1's tolerance, relative to its largest entry (module docstring)
STEP_TOL = {("reference", "lbfgs"): 1e-5, ("reference", "gauss_newton"): 1e-5,
            ("port", "lbfgs"): 1e-4, ("port", "gauss_newton"): 1e-5}


@pytest.mark.parametrize("objective", ["reference", "port"])
@pytest.mark.parametrize("regularizer", ["none", "bending"])
@pytest.mark.parametrize("name", ["lbfgs", "gauss_newton"])
def test_one_step_from_identical_state_matches_reference(coarse, name, regularizer,
                                                         objective):
    """Three states along the reference's own trajectory from a random grid;
    from each, one step of the reference and one of the port, on the
    reference's objective or on the port's: ``p1`` within ``STEP_TOL`` of
    the reference's (measured: 2.0e-6 and 7.3e-7 on the reference's
    objective, 1.7e-5 and 2.6e-6 on the port's), ``ok``, ``hlen`` and the
    damping equal, the new loss at 1e-5."""
    robj, tobj = _objectives(*coarse, regularizer)
    obj = reference_objective(robj) if objective == "reference" else tobj
    tol = STEP_TOL[objective, name]
    for k, state, (rp1, ro1, _, rl1, rok) in _reference_states(robj, name, 3,
                                                                     coarse[0].shape):
        tp1, to1, _, tl1, tok = _port_step(name, obj, k, state)
        assert bool(tok) == bool(rok)
        scale = np.abs(np.asarray(rp1)).max()
        assert np.abs(tp1.numpy() - np.asarray(rp1)).max() <= tol * scale, k
        assert abs(tl1.item() - float(rl1)) <= 1e-5 * abs(float(rl1))
        for key in ("hlen", "damping"):
            if key in ro1:
                assert to1[key].item() == np.asarray(ro1[key]).item()


def test_gauss_newton_cg_rounding_at_small_damping(coarse):
    """With the bending energy the damping falls to 1.2e-5 and 4.1e-6 at the
    fourth and fifth states, and the CG system grows ill-conditioned: there
    the port's step on the reference's objective is held at 1e-4 (measured
    1.1e-5 and 3.2e-5), ``ok`` and the damping equal.  The witness is the
    reference's own step: a one-ulp change of its gradient moves its ``p1``
    by more than 1e-6 at the fifth state, where at the first it moves it
    by less than 1e-7."""
    robj, _ = _objectives(*coarse, "bending")
    shared = reference_objective(robj)

    def nudged(state):
        rp, ro, rg, rl = state
        rg = jnp.asarray(np.nextafter(np.asarray(rg), np.float32(np.inf)))
        return np.asarray(ropt.opt_step("gauss_newton", robj, jnp.int32(k), rp, ro, rg,
                                        rl, lr=0.5)[0])

    spread = {}
    for k, state, (rp1, ro1, _, _, rok) in _reference_states(robj, "gauss_newton", 5,
                                                                  coarse[0].shape):
        scale = np.abs(np.asarray(rp1)).max()
        spread[k] = np.abs(nudged(state) - np.asarray(rp1)).max() / scale
        if k < 3:
            continue
        assert float(ro1["damping"]) < 2e-5
        tp1, to1, _, _, tok = _port_step("gauss_newton", shared, k, state)
        assert bool(tok) == bool(rok)
        assert to1["damping"].item() == np.asarray(ro1["damping"]).item()
        assert np.abs(tp1.numpy() - np.asarray(rp1)).max() <= 1e-4 * scale, k
    assert spread[0] < 1e-7 < 1e-6 < spread[4], spread


def test_gauss_newton_requires_residual_objective():
    obj = topt.make_objective(lambda p: (p * p).sum())
    p = torch.zeros(3)
    with pytest.raises(ValueError, match="residual"):
        topt.opt_step("gauss_newton", obj, 0, p, topt.init_state("gauss_newton", p),
                      torch.zeros(3), torch.tensor(0.0), lr=0.1)


def test_gauss_newton_rejected_step_raises_damping_keeps_iterate():
    """At a point no trial improves, the LM fallback refuses (``ok`` false),
    multiplies the damping and does not move (the JAX package's test)."""
    spec = topt.GaussNewtonOptimizer()
    obj = topt.make_objective(None, residual_fn=lambda p: p)  # optimum at 0
    p = torch.zeros(3)
    opt = topt.init_state(spec, p)
    loss, g = obj.vg(p)
    p1, opt1, _, _, ok = topt.opt_step(spec, obj, 0, p, opt, g, loss, lr=0.1)
    assert not bool(ok) and torch.equal(p1, p)
    assert opt1["damping"].item() == pytest.approx(opt["damping"].item() * spec.damp_up)


def test_lbfgs_line_search_collapse_freezes_not_nans():
    """Every trial is NaN: each search collapses, the patience rule stops
    the loop after ``patience`` steps, and the start is returned (the JAX
    package's test)."""
    direction = torch.tensor([1.0, 2.0, -1.0])

    def trap(p):
        return torch.where((p != 0).any(), torch.tensor(float("nan")),
                           (direction * p).sum() + 1.0)

    stop = ConvergenceConfig(tol=1e-6, patience=3).resolve(50)
    best_p, trace, k = tconv.optimize_until(topt.make_objective(trap), torch.zeros(3),
                                            optimizer="lbfgs", stop=stop, lr=1.0)
    assert k == 3 and torch.equal(best_p, torch.zeros(3))
    assert torch.isfinite(trace).all() and trace[-1].item() == 1.0


# --- early stopping


def test_convergence_config_validates_and_resolves():
    assert ConvergenceConfig().resolve(40).max_iters == 40
    assert ConvergenceConfig(max_iters=7).resolve(40).max_iters == 7
    for bad in (dict(tol=-1.0), dict(patience=0), dict(max_iters=0)):
        with pytest.raises(ValueError):
            ConvergenceConfig(**bad)
    with pytest.raises(TypeError, match="ConvergenceConfig"):
        tconv.check_stop(1e-4, 40)
    with pytest.raises(ValueError, match="unresolved"):
        tconv.optimize_until(None, torch.zeros(3), optimizer="adam",
                             stop=ConvergenceConfig(), lr=0.1)


@pytest.mark.parametrize("name,stop", [
    ("adam", dict(tol=1e-3, patience=2, max_iters=30)),  # stops on a plateau
    ("adam", dict(tol=0.0, patience=40, max_iters=12)),  # runs its budget out
    ("lbfgs", dict(tol=1e-2, patience=2, max_iters=12)),
    ("gauss_newton", dict(tol=5e-2, patience=1, max_iters=12)),
])
def test_optimize_until_matches_reference(coarse, name, stop):
    """``steps`` equal, the trace at 1e-5 relative, its tail padded with the
    best loss and ``trace[-1]`` the loss of the params returned."""
    robj, tobj = _objectives(*coarse)
    p0 = np.zeros(rgrid_shape(coarse[0].shape, TILE) + (3,), np.float32)
    rp, rtrace, rk = rconv.optimize_until(robj, jnp.asarray(p0), optimizer=name,
                                          stop=rconv.ConvergenceConfig(**stop), lr=0.5)
    tp, ttrace, tk = tconv.optimize_until(tobj, torch.from_numpy(p0), optimizer=name,
                                          stop=ConvergenceConfig(**stop), lr=0.5)
    assert tk == int(rk) and ttrace.shape == (stop["max_iters"],)
    rtrace = np.asarray(rtrace)
    np.testing.assert_allclose(ttrace.numpy(), rtrace, rtol=1e-5)
    # the best loss the rule counted (the start counts) pads the tail, closes
    # the trace and is the loss of the params returned
    best = tobj.loss(torch.from_numpy(p0)).item()
    for loss in ttrace[:tk].tolist():
        if (best - loss) / max(abs(best), 1e-12) > stop["tol"]:
            best = loss
    assert ttrace[-1].item() == pytest.approx(best, rel=1e-6)
    assert (ttrace[tk:] == ttrace[-1]).all()
    assert tobj.loss(tp).item() == pytest.approx(best, rel=1e-6)
    assert np.abs(tp.numpy() - np.asarray(rp)).max() <= 1e-4
    if name == "adam" and stop["tol"] > 0:
        assert tk < stop["max_iters"]  # the plateau case stopped early


def test_adam_until_returns_best_params_when_optimiser_degrades():
    p0 = torch.zeros(4)
    stop = ConvergenceConfig(tol=1e-4, patience=4).resolve(50)
    p, trace, k = tconv.adam_until(lambda p: (p * p).sum(), p0, stop=stop, lr=0.5)
    assert k == 4 and torch.equal(p, p0) and trace[-1].item() == 0.0


# --- the Gauss-Newton products on the kernels


def test_residual_jvp_matches_reference(coarse):
    """``torch.func.jvp`` of the level residual (the forward kernel's plain
    version on the tangent) against ``jax.jvp`` of the reference's, at a
    random grid and at 0, where every border voxel sits on a clamp bound."""
    robj, tobj = _objectives(*coarse)
    gshape = rgrid_shape(coarse[0].shape, TILE) + (3,)
    rng = np.random.default_rng(2)
    v = rng.standard_normal(gshape).astype(np.float32)
    for p in (np.zeros(gshape, np.float32),
              (rng.standard_normal(gshape) * 0.5).astype(np.float32)):
        _, rjv = jax.jvp(robj.residual, (jnp.asarray(p),), (jnp.asarray(v),))
        r, jv = torch.func.jvp(tobj.residual, (torch.from_numpy(p),),
                               (torch.from_numpy(v),))
        rjv = np.asarray(rjv)
        assert np.abs(jv.numpy() - rjv).max() <= 1e-5 * np.abs(rjv).max()


@pytest.mark.parametrize("transform", ["displacement", "velocity"])
def test_linearization_matches_reference(coarse, transform):
    """The level objective's ``linearize``: the residual, ``J v`` (the
    forward kernel's plain version on the tangent, times the warp's
    derivative) and ``J^T w`` (the adjoint's) against ``jax.linearize`` and
    ``jax.linear_transpose`` of the reference's residual at 1e-5 of the
    largest entry, at 0 (every border voxel on a clamp bound) and at a
    random grid."""
    f, m = coarse
    kw = dict(tile=TILE, bending_weight=5e-3, mode="ttli", transform=transform)
    robj = rbatch.ffd_level_objective(jnp.asarray(f), jnp.asarray(m), impl="jnp",
                                      grad_impl="jnp", **kw)
    tobj = tbatch.ffd_level_objective(torch.from_numpy(f), torch.from_numpy(m),
                                      impl="cuda", grad_impl="cuda", **kw)
    gshape = rgrid_shape(f.shape, TILE) + (3,)
    rng = np.random.default_rng(3)
    v = rng.standard_normal(gshape).astype(np.float32)
    w = rng.standard_normal(f.size).astype(np.float32)
    for p in (np.zeros(gshape, np.float32),
              (rng.standard_normal(gshape) * 0.5).astype(np.float32)):
        r0, lin = jax.linearize(robj.residual, jnp.asarray(p))
        refs = (r0, lin(jnp.asarray(v)),
                jax.linear_transpose(lin, jnp.asarray(p))(jnp.asarray(w))[0])
        r, jvp, vjp = tobj.linearize(torch.from_numpy(p))
        outs = (r, jvp(torch.from_numpy(v)), vjp(torch.from_numpy(w)))
        for out, ref in zip(outs, refs):
            ref = np.asarray(ref)
            assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_gauss_newton_step_runs_the_kernels_path(coarse, monkeypatch):
    """The Gauss-Newton step on ``impl="cuda", grad_impl="cuda"`` reaches
    the kernels' dispatchers for its ``J`` and ``J^T`` products with real
    tensors (a launch reads ``data_ptr()``): per step one forward for the
    linearisation, one a CG iteration (the tangent only: the primal is not
    re-run), the trial and the value-and-grad; an adjoint a CG iteration
    and one for the gradient.  It agrees with the same step on the plain
    autograd graph at 1e-6."""
    f, m = coarse
    calls = {"forward": 0, "adjoint": 0}

    def counted(name, fn):
        def call(t, *args, **kwargs):
            t.data_ptr()
            calls[name] += 1
            return fn(t, *args, **kwargs)
        return call

    monkeypatch.setitem(ops.FORWARD_KERNELS, "ttli",
                        counted("forward", ops.FORWARD_KERNELS["ttli"]))
    monkeypatch.setattr(ops, "bsi_adjoint", counted("adjoint", ops.bsi_adjoint))
    kw = dict(tile=TILE, bending_weight=5e-3, mode="ttli")
    obj_k = tbatch.ffd_level_objective(torch.from_numpy(f), torch.from_numpy(m),
                                       impl="cuda", grad_impl="cuda", **kw)
    obj_p = tbatch.ffd_level_objective(torch.from_numpy(f), torch.from_numpy(m),
                                       impl="torch", grad_impl="autograd", **kw)
    p = torch.zeros(rgrid_shape(f.shape, TILE) + (3,))
    outs = []
    for obj in (obj_k, obj_p):
        loss, g = obj.vg(p)
        calls.update(forward=0, adjoint=0)
        outs.append(topt.opt_step("gauss_newton", obj, 0, p,
                                  topt.init_state("gauss_newton", p), g, loss, lr=0.5))
        if obj is obj_k:
            assert calls == {"forward": 1 + 10 + 1 + 1, "adjoint": 10 + 1}, calls
    assert calls == {"forward": 0, "adjoint": 0}  # the plain graph: no dispatcher
    assert bool(outs[0][4]) and bool(outs[1][4])
    scale = outs[1][0].abs().max()
    assert (outs[0][0] - outs[1][0]).abs().max() <= 1e-6 * scale


# --- the whole registration


def test_reference_ssd_rounding_at_the_fine_level(pair):
    """The cause of the L-BFGS spread (module docstring): at phi = 0 of the
    fine level the reference's float32 SSD is 1.2e-5 from float64, the
    port's under 1e-7."""
    fixed, moving, _ = pair
    exact = np.mean((moving.astype(np.float64) - fixed) ** 2)
    ref = float(jnp.mean((jnp.asarray(moving) - jnp.asarray(fixed)) ** 2))
    out = torch.mean((torch.from_numpy(moving) - torch.from_numpy(fixed)) ** 2).item()
    assert abs(ref - exact) >= 5e-6 * exact
    assert abs(out - exact) <= 1e-7 * exact


# (fields of both packages, the grid's tolerance): every case holds its
# per-level losses at 1e-4 and its steps; a grid is held at 1e-4, of its
# largest entry where that exceeds 1 (the velocity grid's is 6.8)
CASES = {
    "lbfgs": (dict(optimizer="lbfgs"), None),
    "gauss_newton": (dict(optimizer="gauss_newton"), 1e-4),
    "gauss_newton-bending": (dict(optimizer="gauss_newton", regularizer="bending"),
                             None),
    "adam-stop": (dict(iters=20, lr=0.05, stop=rconv.ConvergenceConfig(
        tol=1e-2, patience=2)), 1e-4),
    "velocity-bending-lbfgs-stop": (dict(iters=10, transform="velocity",
                                         regularizer="bending", optimizer="lbfgs",
                                         stop=rconv.ConvergenceConfig(
                                             tol=5e-2, patience=1)), 7e-4),
}

# Where the two packages' grids part.  The coarse level's grids agree within
# 1e-4 (measured 2.2e-5 and 7.0e-5 of the largest entry); the fine level
# takes that difference up by a factor of about 60 and 25 (to 1.4e-3 and
# 1.8e-3).  L-BFGS: its first fine step has no curvature pairs, so it is
# steepest descent from a unit-norm probe, and the quadratic refinement's
# denominator f(p + t d) - f(p) - t g.d is a difference of nearly equal
# losses.  Gauss-Newton with the bending energy: by the fourth fine step the
# damping is 1.2e-5, and CG's ten iterations on the barely damped system
# resolve the grid's weakly determined directions by rounding.  The
# reference does the same: its own fine level, run from the port's coarse
# grid, lands within 1e-4 of the port's result (measured 4.5e-5 and
# 2.1e-7), and 1.4e-3 and 1.8e-3 from its own.
SPLITS = {"lbfgs": "fine level, first step: the quadratic refinement",
          "gauss_newton-bending": "fine level, fourth step: CG at damping 1.2e-5"}


def _rel(out, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(out) - ref).max() / np.abs(ref).max()


def _ref_fine_level(fixed, moving, fields, coarse_grid):
    """The reference's own finest level, run from ``coarse_grid`` (a coarse
    level's result) as its ``ffd_register`` runs it: its params and warp."""
    from repro.core import registration as rreg
    from repro.core.ffd import upsample_grid as rupsample
    from repro.core.ffd import warp_volume as rwarp
    from repro.core.transform import dense_displacement as rdense

    opts = rreg.resolve_options(RefOptions(**fields), fixed.shape)
    phi = rupsample(jnp.asarray(coarse_grid), rgrid_shape(fixed.shape, opts.tile))
    phi = rreg._ffd_level_runner(fixed.shape, opts)(phi, jnp.asarray(fixed),
                                                    jnp.asarray(moving))[0]
    disp = rdense(opts.transform, phi, opts.tile, fixed.shape, mode=opts.mode,
                  impl=opts.impl)
    return np.asarray(phi), np.asarray(rwarp(jnp.asarray(moving), disp))


@pytest.mark.parametrize("case", list(CASES))
def test_ffd_register_matches_reference(pair, coarse, case):
    """Per-level losses at 1e-4 and ``steps`` equal; the grid (``CASES``)
    and the warp at 1e-4.  For a case in ``SPLITS`` the grid and the warp
    are held where the split leaves them determined: the coarse level alone
    at 1e-4, and the result against the reference's own fine level run from
    the port's coarse grid at 1e-4 (of the grids' largest entry)."""
    fields, params_atol = CASES[case]
    fields = {**REF_FIELDS, **fields}
    fixed, moving, _ = pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_register(fixed, moving, options=RefOptions(**fields))
    opts = options_from_reference(fields)
    out = ffd_register(fixed, moving, options=opts, device="cpu")
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-4)
    assert out.steps == ref.steps
    if ref.steps is not None:  # a level stopped early
        assert min(out.steps) < opts.iters
    mae0 = metrics.mae(torch.from_numpy(moving), torch.from_numpy(fixed)).item()
    assert metrics.mae(out.warped, torch.from_numpy(fixed)).item() < mae0
    if case not in SPLITS:
        np.testing.assert_allclose(out.params.numpy(), np.asarray(ref.params),
                                   atol=params_atol)
        assert np.abs(out.warped.numpy() - np.asarray(ref.warped)).max() <= 1e-4
        return

    one = {**fields, "levels": 1}
    out_c = ffd_register(*coarse, options=options_from_reference(one), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_c = ref_register(*coarse, options=RefOptions(**one))
        ref_f = _ref_fine_level(fixed, moving, fields, out_c.params.numpy())
    assert _rel(out_c.params.numpy(), ref_c.params) <= 1e-4
    assert np.abs(out_c.warped.numpy() - np.asarray(ref_c.warped)).max() <= 1e-4
    assert _rel(out.params.numpy(), ref_f[0]) <= 1e-4
    assert np.abs(out.warped.numpy() - ref_f[1]).max() <= 1e-4
