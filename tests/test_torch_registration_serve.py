"""``engine.serve``: lane recycling, bucketing and failure modes, the JAX
package's ``tests/test_serve.py`` ported, and the served results against the
JAX package's scheduler.

Splicing a queued pair into a lane freed mid-flight changes scheduling, not
results: in the port a served request equals a solo ``ffd_register`` of the
same pair bit for bit (the lanes step on fresh copies of their rows with the
solo loop's host step index), whatever the chunk width.  Against the JAX
package's scheduler (``impl="jnp", grad_impl="xla"``, its ``vmap``ped chunk)
``steps`` are equal and ``warped`` and the losses within 1e-4.  Everything
time-dependent runs under a fake clock (the device work still runs; only
the scheduler's notion of "now" is faked).  The port runs on the CPU here
(``device="cpu"``), where the kernels' plain versions run.
"""

import asyncio
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.options import RegistrationOptions as RefOptions  # noqa: E402
from repro.engine.convergence import ConvergenceConfig as RefConvergence  # noqa: E402
from repro.engine.serve import RegistrationScheduler as RefScheduler  # noqa: E402
from repro_torch import (AsyncRegistrationService, QueueFull,  # noqa: E402
                         RegistrationScheduler, RegistrationTimeout, ffd_register)
from repro_torch.convert import options_from_reference  # noqa: E402
from repro_torch.launch import serve_registration  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
SHAPE = (22, 20, 18)
REF_FIELDS = dict(tile=(6, 6, 6), levels=2, iters=16, lr=0.1, mode="separable",
                  impl="jnp", grad_impl="xla", fused="off",
                  stop=RefConvergence(tol=2e-3, patience=3))
OPTS = options_from_reference(dict(REF_FIELDS, impl="pallas", grad_impl="pallas"))


def scheduler(**kw):
    return RegistrationScheduler(OPTS, device="cpu", **kw)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _mixed_pairs(n, shape=SHAPE, hard_every=3, seed=0):
    """Every ``hard_every``-th pair needs the whole budget; the rest plateau
    within a few steps: the contrast that frees lanes mid-flight."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=shape).astype(np.float32)
    x, y, z = np.meshgrid(*[np.linspace(0, np.pi, s) for s in shape], indexing="ij")
    wave = (np.sin(x) * np.sin(y) * np.sin(z)).astype(np.float32)
    out = []
    for i in range(n):
        f = base + 0.05 * rng.normal(size=shape).astype(np.float32)
        if i % hard_every == 0:
            m = np.roll(f, 3, axis=0) + 2.5 * wave
            m = m + 0.3 * rng.normal(size=shape).astype(np.float32)
        else:
            m = f + 0.02 * wave
        out.append((f, m.astype(np.float32)))
    return out


def _assert_solo(served, f, m):
    solo = ffd_register(f, m, options=OPTS, device="cpu")
    assert served.steps == solo.steps
    assert served.losses == solo.losses
    assert torch.equal(served.params, solo.params)
    assert torch.equal(served.warped, solo.warped)


@pytest.fixture(scope="module")
def recycled_run():
    pairs = _mixed_pairs(6)
    sched = scheduler(lanes=2, chunk=3, max_queue=16)
    handles = [sched.submit(f, m) for f, m in pairs]
    sched.run_until_idle()
    return pairs, sched, [h.result() for h in handles]


class TestRecycling:
    def test_recycled_matches_solo(self, recycled_run):
        """Requests spliced into mid-flight lanes equal solo
        ``ffd_register`` bit for bit: steps, losses, grid and warp."""
        pairs, sched, results = recycled_run
        assert sched.stats.recycled >= 1
        assert sched.stats.completed == len(pairs)
        for (f, m), served in zip(pairs, results):
            _assert_solo(served, f, m)
        assert sum(r.recycled for r in results) == sched.stats.recycled

    def test_matches_the_reference_scheduler(self, recycled_run):
        pairs, _, results = recycled_run
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = RefScheduler(RefOptions(**REF_FIELDS), lanes=2, chunk=3, max_queue=16)
            handles = [ref.submit(f, m) for f, m in pairs]
            ref.run_until_idle()
        for served, h in zip(results, handles):
            want = h.result()
            assert served.steps == want.steps
            np.testing.assert_allclose(served.losses, want.losses, rtol=1e-4)
            assert np.abs(served.warped.numpy() - np.asarray(want.warped)).max() <= 1e-4

    @pytest.mark.parametrize("chunk", [3, 7])
    def test_chunk_width_never_changes_trajectories(self, chunk):
        """chunk only sets when the host looks: widths 1, 3 and 7 give
        bit-identical results."""
        f, m = _mixed_pairs(1)[0]
        results = []
        for width in (1, chunk):
            sched = scheduler(lanes=2, chunk=width)
            h = sched.submit(f, m)
            sched.run_until_idle()
            results.append(h.result())
        assert results[0].steps == results[1].steps
        assert results[0].losses == results[1].losses
        assert torch.equal(results[0].params, results[1].params)
        assert torch.equal(results[0].warped, results[1].warped)


class TestBucketing:
    def test_one_stage_key_per_shape_and_level(self):
        shapes = [SHAPE, (18, 16, 14)]
        sched = scheduler(lanes=2, chunk=4)
        rng = np.random.default_rng(1)
        for shape in shapes:
            for _ in range(2):
                f = rng.normal(size=shape).astype(np.float32)
                sched.submit(f, np.roll(f, 1, axis=0))
        sched.run_until_idle()
        assert sched.stats.buckets == len(shapes)
        assert sched.stats.compiles == OPTS.levels * len(shapes)
        assert sched.stats.completed == 2 * len(shapes)

    def test_shape_mismatch_rejected(self):
        sched = scheduler()
        f = np.zeros(SHAPE, np.float32)
        with pytest.raises(ValueError, match="equal shapes"):
            sched.submit(f, np.zeros((18, 16, 14), np.float32))


class TestFailureModes:
    def test_timeout_is_clean(self):
        clock = FakeClock()
        sched = scheduler(lanes=1, chunk=4, timeout=5.0, clock=clock)
        f, m = _mixed_pairs(1)[0]
        h = sched.submit(f, m)
        clock.advance(10.0)  # the deadline passes while still queued
        sched.step()
        assert h.done and sched.pending == 0
        assert sched.stats.timed_out == 1
        with pytest.raises(RegistrationTimeout, match="expired"):
            h.result()

    def test_unexpired_requests_complete_under_fake_clock(self):
        clock = FakeClock()
        sched = scheduler(lanes=1, timeout=60.0, clock=clock)
        f, m = _mixed_pairs(1)[0]
        h = sched.submit(f, m)
        sched.run_until_idle()
        assert h.result().warped is not None
        assert sched.stats.timed_out == 0

    def test_backpressure_queue_full(self):
        sched = scheduler(lanes=1, max_queue=1)
        f, m = _mixed_pairs(1)[0]
        sched.submit(f, m)
        with pytest.raises(QueueFull, match="max_queue"):
            sched.submit(f, m)
        assert sched.stats.rejected == 1
        sched.run_until_idle()  # the admitted request still completes
        assert sched.stats.completed == 1

    def test_result_before_done_raises(self):
        sched = scheduler(lanes=1)
        f, m = _mixed_pairs(1)[0]
        h = sched.submit(f, m)
        with pytest.raises(RuntimeError, match="in flight"):
            h.result()
        sched.run_until_idle()
        assert h.result() is not None

    def test_constructor_validation(self):
        with pytest.raises(TypeError, match="RegistrationOptions"):
            RegistrationScheduler({"iters": 3}, device="cpu")
        with pytest.raises(ValueError, match="lanes"):
            scheduler(lanes=0)
        with pytest.raises(ValueError, match="chunk"):
            scheduler(chunk=0)

    def test_run_until_idle_raises_when_the_queue_never_drains(self):
        sched = scheduler(lanes=1, chunk=1)
        f, m = _mixed_pairs(1)[0]
        sched.submit(f, m)
        with pytest.raises(RuntimeError, match="in flight"):
            sched.run_until_idle(max_rounds=1)


class TestAsyncFacade:
    def test_concurrent_registers(self):
        pairs = _mixed_pairs(3)

        async def run():
            service = AsyncRegistrationService(scheduler=scheduler(lanes=2, chunk=4))
            return await asyncio.gather(*(service.register(f, m) for f, m in pairs))

        results = asyncio.run(run())
        assert len(results) == len(pairs)
        for (f, m), served in zip(pairs, results):
            _assert_solo(served, f, m)


def test_launcher_smoke_on_the_cpu(capsys):
    out = serve_registration.main(["--smoke", "--device", "cpu", "--iters", "8"])
    assert out["completed"] == out["n"] == 8
    assert out["stats"].compiles == 4
    assert "smoke OK" in capsys.readouterr().out
