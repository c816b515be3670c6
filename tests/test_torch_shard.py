"""Sharded ``register_batch`` (``engine.shard``) on ``torch.distributed`` with
gloo on the CPU, against the port's unsharded path and the JAX package's.

The JAX package's own sharded path (``tests/test_shard_engine.py``) fails on
this JAX: its ``jax.make_mesh`` builds explicit axes, which its
``with_sharding_constraint`` refuses.  So the port is held against the
reference's unsharded ``register_batch`` at its default ``lr=0.5`` and its
pure helpers (``REGISTRATION_RULES``, ``pad_batch``, ``batch_mask``), and
against its own unsharded path bit for bit: a rank runs ``ffd_pipeline`` on
fresh copies of its rows, as ``mesh=None`` does.  Warped volumes and losses
are held at 1e-4.  A pair's grid is held at 1e-4, or where rounding moves
the grids by more, within the two packages' spreads summed: how far each
package's own grid moves when the moving volume is nudged by one ulp (the
port's distance from an exact run plus the reference's).  At ``lr=0.5``
Adam divides each gradient entry by its own magnitude, so entries near its
``eps`` carry any rounding into a large step: on the first pair the port
lands 2.5e-4 from the reference, against spreads of 1.9e-4 (reference) and
3.0e-4 (port); on the third 1.1e-2, against 1.8e-2 and 3.7e-4.  The warped
volumes stay within 3e-6 and the losses within 1e-6.

The one-rank cases run in process on a gloo group of one; the two-rank case
spawns two processes (``torch.multiprocessing``, a ``FileStore`` in
``tmp_path``, one thread each, a join time limit).  The ranks import no JAX:
this module imports the JAX package only inside the tests that use it.
"""

import datetime
import sys
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro_torch import ConvergenceConfig, make_pair, register_batch  # noqa: E402
from repro_torch.convert import options_from_reference  # noqa: E402
from repro_torch.distributed.sharding import (REGISTRATION_RULES, AxisRules,  # noqa: E402
                                              placements)
from repro_torch.engine import make_registration_mesh, sharded_pipeline  # noqa: E402
from repro_torch.engine.shard import (GRID_AXES, LOSS_AXES, VOLUME_AXES,  # noqa: E402
                                      batch_mask, batch_multiple, lane_sharding,
                                      pad_batch)

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
SHAPE = (18, 16, 14)
REF_FIELDS = dict(tile=(5, 5, 5), levels=2, iters=4, mode="separable", impl="jnp",
                  grad_impl="jnp", fused="off")
STOP_FIELDS = dict(REF_FIELDS, iters=16, lr=0.05)  # with stop=(1e-2, 2)
CASES = {"b3": (3, False), "b3-stop": (3, True), "b1": (1, False), "b1-stop": (1, True)}
JOIN_SECONDS = 240


def _stacks():
    pairs = [make_pair(SHAPE, tile=(5, 5, 5), magnitude=1.2, seed=s, device="cpu")[:2]
             for s in range(3)]
    return (torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs]))


def _options(stop):
    fields = STOP_FIELDS if stop else REF_FIELDS
    opts = options_from_reference(dict(fields, impl="pallas", grad_impl="pallas"))
    return opts.replace(stop=ConvergenceConfig(tol=1e-2, patience=2)) if stop else opts


def _arrays(res):
    out = {k: getattr(res, k).numpy() for k in ("warped", "params", "losses")}
    out["steps"] = None if res.steps is None else res.steps.numpy()
    return out


def _bit_equal(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("warped", "params", "losses")) and (
        (a.steps is None and b.steps is None) or torch.equal(a.steps, b.steps))


@pytest.fixture(scope="module")
def stacks():
    return _stacks()


@pytest.fixture(scope="module")
def reference(stacks):
    """The JAX package's unsharded ``register_batch`` of the three pairs,
    with and without stop, and each pair's ``spread``: how far its grid
    moves when the moving volume is nudged by one ulp (:func:`_nudged`).  A
    case of B pairs is held against the first B rows."""
    from repro.core.options import RegistrationOptions as RefOptions
    from repro.engine.batch import register_batch as ref_register_batch
    from repro.engine.convergence import ConvergenceConfig as RefConvergence

    fixed, moving = (t.numpy() for t in stacks)
    nudged = _nudged(moving)
    runs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for stop in (False, True):
            fields = (dict(STOP_FIELDS, stop=RefConvergence(tol=1e-2, patience=2))
                      if stop else REF_FIELDS)
            opts = RefOptions(**fields)
            runs[stop] = (ref_register_batch(fixed, moving, options=opts),
                          ref_register_batch(fixed, nudged, options=opts))
    out = {}
    for name, (b, stop) in CASES.items():
        run, witness = runs[stop]
        out[name] = {k: (None if getattr(run, k) is None else np.asarray(getattr(run, k))[:b])
                     for k in ("warped", "params", "losses", "steps")}
        out[name]["spread"] = _spread(witness.params, run.params)[:b]
    return out


def _nudged(moving):
    """The moving volumes one ulp up: a rounding-size change of the input."""
    return np.nextafter(moving, np.float32(np.inf))


def _spread(a, b):
    """Each pair's largest grid entry difference."""
    return np.abs(np.asarray(a) - np.asarray(b)).reshape(len(a), -1).max(1)


@pytest.fixture(scope="module")
def port_spread(stacks):
    """The port's own spread, as the reference's: each pair's grid moved by
    the nudge, with and without stop (unsharded; lanes are independent)."""
    fixed, moving = stacks
    nudged = torch.from_numpy(_nudged(moving.numpy()))
    out = {}
    for stop in (False, True):
        opts = _options(stop)
        base = register_batch(fixed, moving, options=opts, device="cpu")
        out[stop] = _spread(register_batch(fixed, nudged, options=opts, device="cpu").params,
                            base.params)
    return out


def _assert_reference(got, want, port_spread):
    """Warped volumes and losses at 1e-4; a pair's grid at 1e-4 or within the
    two packages' spreads summed (the module docstring); steps equal."""
    for k in ("warped", "losses"):
        assert np.abs(got[k] - want[k]).max() <= 1e-4, k
    for i, (ref, own) in enumerate(zip(want["spread"], port_spread)):
        bound = max(1e-4, ref + own)
        assert np.abs(got["params"][i] - want["params"][i]).max() <= bound, i
    if want["steps"] is None:
        assert got["steps"] is None
    else:
        assert got["steps"].tolist() == want["steps"].tolist()


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo mesh in this process, torn down after the module."""
    mesh = make_registration_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


# -- the rules and the helpers -----------------------------------------------


@pytest.mark.parametrize("axes", [("data",), ("pod", "data")])
def test_registration_rules_match_reference(axes):
    from repro.distributed.sharding import REGISTRATION_RULES as REF_RULES

    ref, got = REF_RULES(axes), REGISTRATION_RULES(axes)
    assert isinstance(got, AxisRules) and dict(got) == dict(ref)
    # a PartitionSpec spells a one-axis tuple as the axis
    def one(entry):
        return entry[0] if isinstance(entry, tuple) and len(entry) == 1 else entry

    for logical in (VOLUME_AXES, GRID_AXES, LOSS_AXES):
        assert tuple(map(one, got.spec(logical))) == tuple(map(one, ref.spec(logical)))
    assert got["batch"] == (("pod", "data") if "pod" in axes else ("data",))


def test_placements(mesh):
    assert lane_sharding(mesh) == (Shard(0),)
    for logical in (VOLUME_AXES, GRID_AXES, LOSS_AXES):
        assert placements(mesh, logical) == (Shard(0),)
    assert placements(mesh, ("vol_x", "batch")) == (Shard(1),)
    assert placements(mesh, ("vol_x",)) == (Replicate(),)
    # a pod axis folds into the batch shards: both mesh dimensions shard dim 0
    pod = DeviceMesh("cpu", [[0]], mesh_dim_names=("pod", "data"))
    assert placements(pod, VOLUME_AXES) == (Shard(0), Shard(0))
    assert batch_multiple(pod) == 1


def test_pad_batch_and_mask_match_reference():
    from repro.engine import shard as ref_shard

    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    for multiple in (1, 2, 3, 4, 8):
        got, b = pad_batch(torch.from_numpy(x), multiple)
        want, want_b = ref_shard.pad_batch(x, multiple)
        assert b == want_b == 3
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(batch_mask(b, got.shape[0]).numpy(),
                                      np.asarray(ref_shard.batch_mask(b, want.shape[0])))
    with pytest.raises(ValueError, match="empty batch"):
        pad_batch(torch.zeros((0, 2)), 4)


def test_make_registration_mesh_defaults_and_errors(mesh):
    assert mesh.mesh_dim_names == ("data",) and mesh.device_type == "cpu"
    assert mesh.size() == dist.get_world_size() == 1
    assert dist.get_backend() == "gloo"
    assert batch_multiple(mesh) == 1
    assert make_registration_mesh(1, device="cpu").size() == 1
    assert make_registration_mesh(devices=[0], device="cpu").size() == 1
    for n in (0, 2):
        with pytest.raises(ValueError, match="ranks for a registration mesh"):
            make_registration_mesh(n, device="cpu")


# -- one rank, in process ----------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_register_batch_mesh_one_rank(mesh, stacks, reference, port_spread, case):
    b, stop = CASES[case]
    fixed, moving = (t[:b] for t in stacks)
    opts = _options(stop)
    base = register_batch(fixed, moving, options=opts, device="cpu")
    res = register_batch(fixed, moving, options=opts, device="cpu", mesh=mesh)
    assert res.warped.shape == fixed.shape and res.losses.shape == (b, 2)
    assert _bit_equal(res, base)
    _assert_reference(_arrays(res), reference[case], port_spread[stop][:b])
    if stop:
        assert res.steps.dtype == torch.int32 and res.steps.device.type == "cpu"
        assert res.steps.min() < STOP_FIELDS["iters"]  # a level stopped early


def test_register_batch_mesh_one_rank_bf16(mesh, stacks):
    """``compute_dtype="bfloat16"`` rides the options to the mesh's ranks:
    bit-equal to ``mesh=None``, a float32 warp and grid."""
    fixed, moving = stacks
    opts = _options(False).replace(compute_dtype="bfloat16")
    base = register_batch(fixed, moving, options=opts, device="cpu")
    res = register_batch(fixed, moving, options=opts, device="cpu", mesh=mesh)
    assert _bit_equal(res, base)
    assert res.warped.dtype == res.params.dtype == torch.float32


def test_register_batch_mesh_rejects_bad_shapes(mesh):
    v = torch.zeros((8, 8, 8))
    with pytest.raises(ValueError, match="stacks"):
        register_batch(v, v, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        register_batch(torch.zeros((2, 8, 8, 8)), torch.zeros((3, 8, 8, 8)), mesh=mesh,
                       device="cpu")
    with pytest.raises(ValueError, match="empty batch"):
        register_batch(torch.zeros((0, 8, 8, 8)), torch.zeros((0, 8, 8, 8)), mesh=mesh,
                       device="cpu")


def test_sharded_pipeline_outputs_dtensors(mesh, stacks):
    fixed, moving = stacks
    for stop in (False, True):
        out = sharded_pipeline(fixed, moving, options=_options(stop), mesh=mesh)
        assert len(out) == (4 if stop else 3)
        for t in out:
            assert isinstance(t, DTensor) and t.placements == (Shard(0),)
            assert t.shape[0] == 3 and t.to_local().shape[0] == 3


# -- two ranks ---------------------------------------------------------------


def _ranks_main(rank, world, store, out_dir):
    """One rank: each case sharded and unsharded, saved for the parent."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_registration_mesh(device="cpu")
        fixed, moving = _stacks()
        saved = {"jax_imported": "jax" in sys.modules}
        try:  # an unpadded batch of 3 does not split over 2 ranks
            sharded_pipeline(fixed, moving, options=_options(False), mesh=mesh)
            saved["unpadded_raises"] = False
        except ValueError as e:
            saved["unpadded_raises"] = "not a multiple" in str(e)
        for name, (b, stop) in CASES.items():
            opts = _options(stop)
            base = register_batch(fixed[:b], moving[:b], options=opts, device="cpu")
            res = register_batch(fixed[:b], moving[:b], options=opts, device="cpu",
                                 mesh=mesh)
            pipe = sharded_pipeline(*(pad_batch(t[:b], world)[0] for t in (fixed, moving)),
                                    options=opts, mesh=mesh)
            saved[name] = dict(_arrays(res), bit_equal=_bit_equal(res, base),
                               local=[t.to_local().shape[0] for t in pipe],
                               shards=[tuple(t.placements) == (Shard(0),) for t in pipe])
        torch.save(saved, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world, tmp_path):
    """Run ``fn(rank, world, store, out_dir)`` on ``world`` spawned ranks;
    fails (and kills them) after ``JOIN_SECONDS``."""
    ctx = mp.start_processes(fn, args=(world, str(tmp_path / "store"), str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_SECONDS
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"the ranks did not finish in {JOIN_SECONDS} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    for p in ctx.processes:
        assert not p.is_alive() and p.exitcode == 0
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return spawn_ranks(_ranks_main, 2, tmp_path_factory.mktemp("shard"))


@pytest.mark.parametrize("case", list(CASES))
def test_register_batch_two_ranks(two_ranks, reference, port_spread, case):
    """Each rank's sharded result equals its own unsharded call bit for bit
    (B = 3 pads one row, B = 1 pads rank 1's whole block), the two ranks'
    results are identical, and rank 0's is held against the reference's
    unsharded ``register_batch`` (1e-4, or the spreads: the module
    docstring)."""
    b, stop = CASES[case]
    r0, r1 = (r[case] for r in two_ranks)
    assert not any(r["jax_imported"] for r in two_ranks)
    assert all(r["unpadded_raises"] for r in two_ranks)
    assert r0["bit_equal"] and r1["bit_equal"]
    for k in ("warped", "params", "losses"):
        assert r0[k].shape[0] == b
        np.testing.assert_array_equal(r0[k], r1[k])
    _assert_reference(r0, reference[case], port_spread[stop][:b])
    padded = b + (-b) % 2
    assert r0["local"] == r1["local"] == [padded // 2] * (4 if stop else 3)
    assert all(r0["shards"]) and all(r1["shards"])
