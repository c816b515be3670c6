"""Batched registration and the scheduler's lanes against the JAX package's
``repro.engine.batch`` and against the port's own solo ``ffd_register``.

``register_batch`` registers pair by pair through ``ffd_pipeline`` (the
port's kernels have no batch axis), so each pair's ``warped``, ``params``
and ``losses`` equal a solo ``ffd_register`` of it bit for bit, for every
optimiser and transform, with and without ``stop=``.  Against the reference
(pinned to ``mode="ttli", impl="jnp", grad_impl="jnp", fused="off"``, whose
``register_batch`` ``vmap``s the pipeline) ``warped`` and ``losses`` are
held at 1e-4 and ``steps`` equal.  ``params`` too, except where the
reference's own batch and solo grids part by more: Adam divides each
gradient entry by its own magnitude, so entries near its ``eps`` carry each
path's float32 rounding into the step.  On the second pair (seed 1) of the
fixed-step case the reference's ``vmap``ped batch lands 5.4e-4 from its
solo call (entries of magnitude ~1), and the port 4.1e-4 and 2.8e-4 from
them; there the port is held within the reference's own gap.

The lanes (``compile_level_splice`` / ``compile_level_chunk``) step each
live lane with ``optimize_plateau_step`` on fresh copies of its rows and a
host step index, so a lane's trajectory is the solo loop's bit for bit at
every step, whatever the chunk width.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.options import RegistrationOptions as RefOptions  # noqa: E402
from repro.core.registration import ffd_register as ref_register  # noqa: E402
from repro.data.volumes import make_pair as ref_make_pair  # noqa: E402
from repro.engine import batch as rbatch  # noqa: E402
from repro.engine import convergence as rconv  # noqa: E402
from repro_torch import (BatchRegistrationResult, ConvergenceConfig,  # noqa: E402
                         RegistrationOptions, ffd_register, register_batch)
from repro_torch.convert import options_from_reference  # noqa: E402
from repro_torch.core import ffd  # noqa: E402
from repro_torch.engine import batch as tbatch  # noqa: E402
from repro_torch.engine import convergence as tconv  # noqa: E402
from repro_torch.engine.autotune import resolve_options  # noqa: E402
from repro_torch.engine.optimizer import init_state  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
SHAPE = (28, 24, 20)
SMALL = (22, 20, 18)
CPU = torch.device("cpu")
REF_FIELDS = dict(mode="ttli", impl="jnp", grad_impl="jnp", fused="off", levels=2,
                  iters=5)
REF_STOP = dict(REF_FIELDS, iters=16, lr=0.05,
                stop=rconv.ConvergenceConfig(tol=1e-2, patience=2))


def _stack(pairs):
    return tuple(np.stack([p[j] for p in pairs]) for j in range(2))


@pytest.fixture(scope="module")
def pairs():
    return [tuple(np.array(a) for a in ref_make_pair(SHAPE, seed=s)[:2]) for s in (0, 1)]


def _reference(pairs, fields):
    fixed, moving = _stack(pairs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        batch = rbatch.register_batch(fixed, moving, options=RefOptions(**fields))
        solo = [ref_register(f, m, options=RefOptions(**fields)) for f, m in pairs]
    return batch, solo


@pytest.fixture(scope="module")
def ref_fixed(pairs):
    return _reference(pairs, REF_FIELDS)


@pytest.fixture(scope="module")
def ref_stop(pairs):
    return _reference(pairs, REF_STOP)


@pytest.mark.parametrize("which", ["fixed", "stop"])
def test_register_batch_matches_reference(pairs, ref_fixed, ref_stop, which):
    fields = REF_FIELDS if which == "fixed" else REF_STOP
    ref_batch, ref_solo = ref_fixed if which == "fixed" else ref_stop
    fixed, moving = _stack(pairs)
    out = register_batch(fixed, moving, options=options_from_reference(
        dict(fields, impl="pallas", grad_impl="pallas")), device="cpu")
    assert isinstance(out, BatchRegistrationResult)
    assert out.losses.dtype == torch.float32 and out.losses.shape == (2, 2)
    for name in ("warped", "params", "losses"):
        got = getattr(out, name).numpy()
        for b, solo in enumerate(ref_solo):
            ref_b = np.asarray(getattr(ref_batch, name))[b]
            ref_s = np.asarray(getattr(solo, name))
            # where the reference's own two grids part by more than 1e-4
            # (see the module docstring), the port is held within their gap
            atol = max(1e-4, np.abs(ref_b - ref_s).max()) if name == "params" else 1e-4
            assert np.abs(got[b] - ref_b).max() <= atol, (name, b)
            assert np.abs(got[b] - ref_s).max() <= atol, (name, b)
    if which == "fixed":
        assert out.steps is None and ref_batch.steps is None
    else:
        assert out.steps.dtype == torch.int32
        assert out.steps.tolist() == np.asarray(ref_batch.steps).tolist()
        assert out.steps.tolist() == [s.steps for s in ref_solo]
        assert out.steps.min() < fields["iters"]  # a level stopped early


# Every optimiser and transform, each with and without stop=: the batch's
# pairs are the solo calls bit for bit.
SOLO_CASES = {
    "adam-fused": dict(fused="on"),
    "adam": dict(fused="off"),
    "lbfgs": dict(optimizer="lbfgs"),
    "gauss_newton-bending": dict(optimizer="gauss_newton", regularizer="bending"),
    "velocity-bending": dict(transform="velocity", regularizer="bending", fused="off"),
}
STOP = ConvergenceConfig(tol=2e-2, patience=2)


@pytest.fixture(scope="module")
def small_pairs():
    from repro_torch import make_pair

    return [make_pair(SMALL, seed=s, device="cpu")[:2] for s in (0, 1)]


@pytest.mark.parametrize("stop", [None, STOP], ids=["fixed", "stop"])
@pytest.mark.parametrize("case", list(SOLO_CASES))
def test_register_batch_lanes_equal_solo_bit_for_bit(small_pairs, case, stop):
    opts = RegistrationOptions(levels=2, iters=4, stop=stop, **SOLO_CASES[case])
    fixed = torch.stack([p[0] for p in small_pairs])
    moving = torch.stack([p[1] for p in small_pairs])
    out = register_batch(fixed, moving, options=opts, device="cpu")
    for b, (f, m) in enumerate(small_pairs):
        solo = ffd_register(f, m, options=opts, device="cpu")
        assert torch.equal(out.warped[b], solo.warped)
        assert torch.equal(out.params[b], solo.params)
        assert torch.equal(out.losses[b], torch.tensor(solo.losses, dtype=torch.float32))
        assert (out.steps is None) == (solo.steps is None)
        if stop is not None:
            assert out.steps[b].tolist() == solo.steps


def test_register_batch_compiled_on_first_call_of_a_configuration(small_pairs):
    opts = RegistrationOptions(levels=1, iters=1, lr=0.123)
    fixed = torch.stack([p[0] for p in small_pairs])
    moving = torch.stack([p[1] for p in small_pairs])
    first = register_batch(fixed, moving, options=opts, device="cpu")
    again = register_batch(fixed, moving, options=opts, device="cpu")
    assert first.compiled and not again.compiled
    assert torch.equal(first.params, again.params)
    assert first.seconds > 0


@pytest.mark.parametrize("shapes,match", [
    (((2,) + SMALL[:2], (2,) + SMALL[:2]), "expects"),
    (((0,) + SMALL, (0,) + SMALL), "empty batch"),
    (((2,) + SMALL, (2,) + SHAPE), "shape mismatch"),
])
def test_register_batch_rejects_bad_stacks(shapes, match):
    a, b = (np.zeros(s, np.float32) for s in shapes)
    with pytest.raises(ValueError, match=match):
        register_batch(a, b, device="cpu")


def test_register_batch_rejects_options_of_another_type():
    vol = np.zeros((1,) + SMALL, np.float32)
    with pytest.raises(TypeError, match="RegistrationOptions"):
        register_batch(vol, vol, options={"iters": 3}, device="cpu")


def test_ffd_pipeline_returns_the_references_tuple(small_pairs):
    f, m = small_pairs[0]
    opts = resolve_options(RegistrationOptions(levels=2, iters=2), SMALL, CPU)
    warped, phi, losses = tbatch.ffd_pipeline(f, m, options=opts)
    assert warped.shape == SMALL and phi.shape[3] == 3 and losses.shape == (2,)
    out = tbatch.ffd_pipeline(f, m, options=opts.replace(stop=STOP))
    assert len(out) == 4 and len(out[3]) == 2 and all(isinstance(s, int) for s in out[3])


# ---------------------------------------------------------------------------
# The counters, against the reference's.

@pytest.mark.parametrize("k,since", [(0, 0), (3, 1), (3, 2), (5, 0), (7, 4)])
@pytest.mark.parametrize("stop", [None, (1e-3, 2, 5)])
def test_level_live_matches_reference(k, since, stop):
    ref_stop = port_stop = None
    if stop is not None:
        ref_stop = rconv.ConvergenceConfig(tol=stop[0], patience=stop[1],
                                           max_iters=stop[2])
        port_stop = ConvergenceConfig(tol=stop[0], patience=stop[1], max_iters=stop[2])
    want = bool(rconv.level_live(jnp.int32(k), jnp.int32(since), stop=ref_stop, iters=5))
    assert tconv.level_live(k, since, stop=port_stop, iters=5) is want
    got = tconv.level_live(torch.tensor(k), torch.tensor(since), stop=port_stop, iters=5)
    assert bool(got) is want


@pytest.fixture(scope="module")
def coarse_objectives(pairs):
    from repro.core.ffd import downsample2 as rdown

    f, m = (np.array(rdown(jnp.asarray(v))) for v in pairs[0])
    kw = dict(tile=(5, 5, 5), bending_weight=5e-3, mode="ttli")
    ref = rbatch.ffd_level_objective(jnp.asarray(f), jnp.asarray(m), impl="jnp",
                                     grad_impl="jnp", **kw)
    port = tbatch.ffd_level_objective(torch.from_numpy(f), torch.from_numpy(m),
                                      impl="cuda", grad_impl="cuda", **kw)
    return ref, port, ffd.grid_shape_for_volume(f.shape, (5, 5, 5)) + (3,)


def test_plateau_step_matches_reference(coarse_objectives):
    ref, port, gshape = coarse_objectives
    p0 = np.random.default_rng(0).normal(0.0, 0.2, gshape).astype(np.float32)
    rl, rg = ref.vg(jnp.asarray(p0))
    tl, tg = port.vg(torch.from_numpy(p0))
    zeros = np.zeros(gshape, np.float32)
    rs = (jnp.int32(0), jnp.asarray(p0), jnp.asarray(zeros), jnp.asarray(zeros), rg,
          jnp.int32(0), rl, jnp.asarray(p0))
    ts = (0, torch.from_numpy(p0), torch.zeros(gshape), torch.zeros(gshape), tg,
          torch.zeros((), dtype=torch.int32), tl, torch.from_numpy(p0))
    for _ in range(4):
        rs = rconv.plateau_step(ref.vg, *rs, tol=1e-3, lr=0.5)
        ts = tconv.plateau_step(port.vg, *ts, tol=torch.tensor(1e-3), lr=0.5)
        # (k, p, m, v, g, loss, since, best, best_p)
        assert ts[0] == int(rs[0])
        for j in (1, 2, 3, 8):
            ref_j = np.asarray(rs[j])
            assert np.abs(ts[j].numpy() - ref_j).max() <= 1e-5 * max(np.abs(ref_j).max(), 1)
        assert int(ts[6]) == int(rs[6])
        np.testing.assert_allclose(float(ts[7]), float(rs[7]), rtol=1e-5)
        rs = (rs[0],) + rs[1:5] + rs[6:]  # drop the loss: the next step's inputs
        ts = (ts[0],) + ts[1:5] + ts[6:]


# ---------------------------------------------------------------------------
# The lanes: the solo loop's step bit for bit, whatever the chunk width.

def _solo_level(obj, phi, opts, stop):
    """The solo level loop's params after each step (``optimize_until``'s
    body, step by step) and its steps."""
    from repro_torch.engine.convergence import optimize_plateau_step

    loss, g = obj.vg(phi)
    loss = loss.to(torch.float32)
    p, opt = phi.detach(), init_state(opts.optimizer, phi)
    since = torch.zeros((), dtype=torch.int32)
    best, best_p = loss, p
    tol = torch.tensor(stop.tol if stop is not None else float("-inf"))
    trail, k = [], 0
    limit = stop.max_iters if stop is not None else opts.iters
    while k < limit:
        k, p, opt, g, loss, since, best, best_p = optimize_plateau_step(
            obj, opts.optimizer, k, p, opt, g, loss, since, best, best_p, tol=tol,
            lr=opts.lr)
        trail.append((p, loss, best_p, best))
        if stop is not None and int(since) >= stop.patience:
            break
    return trail, k


def _lanes(opts, pairs, gshape):
    lvl = tuple(pairs[0][0].shape)
    state = tbatch.alloc_lanes(3, lvl, opts, CPU)  # lane 2 stays empty
    fixed, moving = [None] * 3, [None] * 3
    splice = tbatch.compile_level_splice(lvl, opts)
    for i, (f, m) in enumerate(pairs):
        splice(state, fixed, moving, i, torch.zeros(gshape), f, m)
    return state, fixed, moving


@pytest.fixture(scope="module")
def coarse_small(small_pairs):
    return [tuple(ffd.downsample2(v).contiguous() for v in p) for p in small_pairs]


LANE_OPTS = {
    "adam": RegistrationOptions(iters=5, fused="off"),
    "adam-stop": RegistrationOptions(iters=12, fused="off", stop=ConvergenceConfig(
        tol=5e-2, patience=2)),
    "lbfgs": RegistrationOptions(iters=5, optimizer="lbfgs"),
}


@pytest.mark.parametrize("name", list(LANE_OPTS))
def test_chunk_widths_give_identical_lanes(coarse_small, name):
    opts = resolve_options(LANE_OPTS[name], tuple(coarse_small[0][0].shape), CPU)
    gshape = ffd.grid_shape_for_volume(coarse_small[0][0].shape, opts.tile) + (3,)
    stop = tconv.check_stop(opts.stop, opts.iters)
    finals = []
    for chunk in (1, 3, 7):
        state, fixed, moving = _lanes(opts, coarse_small, gshape)
        run = tbatch.compile_level_chunk(tuple(coarse_small[0][0].shape), opts, chunk)
        for _ in range(opts.iters):
            run(state, fixed, moving)
        assert state["active"] == [True, True, False] and state["k"][2] == 0
        assert not state["phi"][2].any()  # the empty lane ran nothing
        finals.append(state)
    for other in finals[1:]:
        for key in ("phi", "best_p", "best", "loss", "since", "g"):
            assert torch.equal(finals[0][key], other[key]), key
        assert other["k"] == finals[0]["k"]
    for i, (f, m) in enumerate(coarse_small):
        trail, steps = _solo_level(tbatch._lane_obj(f, m, opts), torch.zeros(gshape),
                                   opts, stop)
        assert finals[0]["k"][i] == steps
        p, loss, best_p, best = trail[-1]
        assert torch.equal(finals[0]["phi"][i], p)
        assert torch.equal(finals[0]["best_p"][i], best_p)
        assert torch.equal(finals[0]["best"][i], best)


def test_chunk_step_equals_the_solo_step_at_each_index(coarse_small):
    """The lane's step index stays a host int, as the solo loop's: at
    ``k = 0..4`` the chunk's step (and Adam's bias correction in it) equals
    the solo step bit for bit."""
    opts = resolve_options(RegistrationOptions(iters=5, fused="off"),
                           tuple(coarse_small[0][0].shape), CPU)
    gshape = ffd.grid_shape_for_volume(coarse_small[0][0].shape, opts.tile) + (3,)
    state, fixed, moving = _lanes(opts, coarse_small[:1], gshape)
    run = tbatch.compile_level_chunk(tuple(coarse_small[0][0].shape), opts, 1)
    f, m = coarse_small[0]
    trail, _ = _solo_level(tbatch._lane_obj(f, m, opts), torch.zeros(gshape), opts, None)
    for k in range(5):
        assert state["k"][0] == k and isinstance(state["k"][0], int)
        run(state, fixed, moving)
        p, loss, _, _ = trail[k]
        assert torch.equal(state["phi"][0], p), k
        assert torch.equal(state["loss"][0], loss), k


def test_level_vol_shapes_follow_downsample2():
    shapes = tbatch.level_vol_shapes((23, 20, 17), 3)
    vol = torch.zeros(23, 20, 17)
    want = [tuple(vol.shape)]
    for _ in range(2):
        vol = ffd.downsample2(vol)
        want.append(tuple(vol.shape))
    assert shapes == want[::-1]
