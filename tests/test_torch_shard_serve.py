"""The registration scheduler with ``mesh=`` on two gloo ranks (CPU).

Every rank builds the scheduler, submits the same four requests (two volume
shapes, one of them easy, so a lane is freed mid-flight and recycled) and
drives ``run_until_idle``; rank ``r`` steps only the lanes of its block.
Held: every served result equals a solo ``ffd_register`` of its pair bit for
bit and is identical on both ranks, the stats too; against the JAX
package's unsharded scheduler (``impl="jnp", grad_impl="xla"``) the steps
are equal and the warps and losses within 1e-4.  Expiry is decided on the
first rank's clock: the ranks' fake clocks run 10^4 times apart and no
request expires on either.  ``lanes=3`` on two ranks raises, and the
load generator's ``--smoke --mesh --device cpu`` completes on both ranks.

The ranks are spawned (``torch.multiprocessing``, a ``FileStore`` in the
test's temporary directory, one thread each, a join time limit) and import
no JAX; this module imports the JAX package only inside the test that uses
it.
"""

import dataclasses
import datetime
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch import (AsyncRegistrationService, ConvergenceConfig,  # noqa: E402
                         RegistrationOptions, RegistrationScheduler, ffd_register)
from repro_torch.engine import make_registration_mesh  # noqa: E402
from repro_torch.launch import serve_registration  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
SHAPES = [(22, 20, 18), (22, 20, 18), (18, 16, 14), (22, 20, 18)]
HARD = [True, False, True, True]  # the easy pair frees its lane for request 3
OPTS = RegistrationOptions(tile=(6, 6, 6), levels=2, iters=16, lr=0.1, mode="separable",
                           impl="cuda", grad_impl="cuda", fused="off",
                           stop=ConvergenceConfig(tol=2e-3, patience=3))


def _pairs():
    rng = np.random.default_rng(0)
    out = []
    for shape, hard in zip(SHAPES, HARD):
        x, y, z = np.meshgrid(*[np.linspace(0, np.pi, s) for s in shape], indexing="ij")
        wave = (np.sin(x) * np.sin(y) * np.sin(z)).astype(np.float32)
        f = rng.normal(size=shape).astype(np.float32)
        m = (np.roll(f, 3, axis=0) + 2.5 * wave + 0.3 * rng.normal(size=shape)
             if hard else f + 0.02 * wave)
        out.append((f, m.astype(np.float32)))
    return out


class _Clock:
    """A fake clock that moves ``step`` seconds a read."""

    def __init__(self, step):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _serve_main(rank, world, store, out_dir):
    """One rank: the sharded stream, its solo calls, the clock and lane
    checks, the launcher's smoke run; saved for the parent."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_registration_mesh(device="cpu")
        pairs = _pairs()
        saved = {"jax_imported": "jax" in sys.modules}
        try:
            RegistrationScheduler(OPTS, lanes=3, mesh=mesh, device="cpu")
            saved["lanes3_raises"] = False
        except ValueError as e:
            saved["lanes3_raises"] = "multiple of the mesh's batch multiple" in str(e)
        service = AsyncRegistrationService(options=OPTS, lanes=2, mesh=mesh, device="cpu")
        saved["service_mesh"] = service.scheduler.mesh is mesh

        sched = RegistrationScheduler(OPTS, lanes=2, chunk=3, mesh=mesh, device="cpu")
        handles = [sched.submit(f, m) for f, m in pairs]
        # a queued pair waits where the caller put it; a rank builds the
        # pyramids of its own lanes' pairs only
        saved["queue_holds_no_pyramid"] = all(
            r.pyramid is None for b in sched._buckets.values() for r in b.stages[0].queue)
        sched.step()
        saved["pyramids_in_own_lanes"] = [
            (req.pyramid is not None, sched._local(i) is not None)
            for b in sched._buckets.values() for st in b.stages if st.lanes
            for i, req in enumerate(st.lanes) if req is not None]
        sched.run_until_idle()
        results = [h.result() for h in handles]
        solo = [ffd_register(f, m, options=OPTS, device="cpu") for f, m in pairs]
        saved["bit_equal"] = [
            r.steps == s.steps and r.losses == s.losses
            and torch.equal(r.params, s.params) and torch.equal(r.warped, s.warped)
            for r, s in zip(results, solo)]
        saved["results"] = [dict(warped=r.warped.numpy(), params=r.params.numpy(),
                                 losses=r.losses, steps=r.steps, recycled=r.recycled,
                                 seconds=r.seconds) for r in results]
        saved["stats"] = dataclasses.asdict(sched.stats)

        # expiry on the first rank's clock: rank 1's own would expire at once
        timed = RegistrationScheduler(OPTS, lanes=2, chunk=3, mesh=mesh, device="cpu",
                                      clock=_Clock(0.01 if rank == 0 else 100.0))
        h = timed.submit(*pairs[1], timeout=50.0)
        timed.run_until_idle()
        saved["clock"] = (h._error is None, dataclasses.asdict(timed.stats))

        # a bucket's "auto" axes are the first rank's: the others never resolve
        from repro_torch.engine import serve, shard

        resolve = shard.resolve_options
        if rank:
            shard.resolve_options = serve.resolve_options = None
        try:
            auto = RegistrationScheduler(dataclasses.replace(OPTS, fused="auto"), lanes=2,
                                         mesh=mesh, device="cpu")
            auto.submit(*pairs[2])
            saved["auto_fused"] = auto._buckets[SHAPES[2]].options.fused
        finally:
            shard.resolve_options = serve.resolve_options = resolve

        smoke = serve_registration.main(["--smoke", "--mesh", "--device", "cpu"])
        saved["smoke"] = (smoke["completed"], smoke["n"], dataclasses.asdict(smoke["stats"]))
        torch.save(saved, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    from test_torch_shard import spawn_ranks

    return spawn_ranks(_serve_main, 2, tmp_path_factory.mktemp("serve"))


def test_ranks_import_no_jax(two_ranks):
    assert not any(r["jax_imported"] for r in two_ranks)


def test_served_results_bit_equal_to_solo_on_every_rank(two_ranks):
    r0, r1 = two_ranks
    assert all(r0["bit_equal"]) and all(r1["bit_equal"])
    for a, b in zip(r0["results"], r1["results"]):
        np.testing.assert_array_equal(a["warped"], b["warped"])
        np.testing.assert_array_equal(a["params"], b["params"])
        assert (a["losses"], a["steps"], a["recycled"], a["seconds"]) == \
            (b["losses"], b["steps"], b["recycled"], b["seconds"])


def test_lanes_hold_only_their_owners_pyramids(two_ranks):
    """A queued pair holds no pyramid on any rank; after a round a request in
    a lane holds one exactly on the rank that owns the lane, and each rank
    owns one of the two lanes."""
    for r in two_ranks:
        assert r["queue_holds_no_pyramid"]
        assert r["pyramids_in_own_lanes"] and all(
            held == own for held, own in r["pyramids_in_own_lanes"])
    owned = [[own for _, own in r["pyramids_in_own_lanes"]] for r in two_ranks]
    assert [a != b for a, b in zip(*owned)] == [True] * len(owned[0])


def test_first_rank_resolves_the_buckets(two_ranks):
    """Rank 1 cannot resolve (its ``resolve_options`` is gone), and gets rank
    0's resolved axes."""
    r0, r1 = two_ranks
    assert r0["auto_fused"] == r1["auto_fused"] != "auto"


def test_stats_equal_on_every_rank(two_ranks):
    r0, r1 = two_ranks
    assert r0["stats"] == r1["stats"]
    stats = r0["stats"]
    assert stats["completed"] == 4 and stats["recycled"] >= 1
    assert stats["buckets"] == 2 and stats["compiles"] == OPTS.levels * 2
    assert sum(r["recycled"] for r in r0["results"]) == stats["recycled"]


def test_matches_the_reference_scheduler(two_ranks):
    from repro.core.options import RegistrationOptions as RefOptions
    from repro.engine.convergence import ConvergenceConfig as RefConvergence
    from repro.engine.serve import RegistrationScheduler as RefScheduler

    fields = dict(tile=(6, 6, 6), levels=2, iters=16, lr=0.1, mode="separable",
                  impl="jnp", grad_impl="xla", fused="off",
                  stop=RefConvergence(tol=2e-3, patience=3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = RefScheduler(RefOptions(**fields), lanes=2, chunk=3)
        handles = [ref.submit(f, m) for f, m in _pairs()]
        ref.run_until_idle()
    for served, h in zip(two_ranks[0]["results"], handles):
        want = h.result()
        assert served["steps"] == want.steps
        np.testing.assert_allclose(served["losses"], want.losses, rtol=1e-4)
        assert np.abs(served["warped"] - np.asarray(want.warped)).max() <= 1e-4


def test_lanes_must_split_evenly(two_ranks):
    assert all(r["lanes3_raises"] for r in two_ranks)
    assert all(r["service_mesh"] for r in two_ranks)


def test_expiry_on_the_first_ranks_clock(two_ranks):
    r0, r1 = two_ranks
    assert r0["clock"] == r1["clock"]
    completed, stats = r0["clock"]
    assert completed and stats["timed_out"] == 0 and stats["completed"] == 1


def test_launcher_smoke_with_mesh(two_ranks):
    r0, r1 = two_ranks
    assert r0["smoke"][:2] == r1["smoke"][:2] == (8, 8)
    assert r0["smoke"][2] == r1["smoke"][2]
