"""Registration-serving launcher: a Poisson load generator over engine.serve.

Plays an open-loop Poisson stream of mixed-difficulty registration requests
against a :class:`repro_torch.engine.serve.RegistrationScheduler` and prints
the serving numbers: p50/p99 request latency, pairs per second, recycled
lanes, and the stage count (``levels x distinct shapes`` however long the
run).  On the card (``--device cpu`` runs the kernels' plain versions):

    PYTHONPATH=src python -m repro_torch.launch.serve_registration [--rate 4.0] [--n 32]
    PYTHONPATH=src python -m repro_torch.launch.serve_registration --smoke
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve_registration --mesh

``--smoke`` pushes 8 mixed pairs (two volume shapes, easy and hard) through
the queue as fast as the scheduler takes them and asserts that every
request completes, that bucketing held the stage count to ``levels x
shapes``, and, on the card, that the forward and adjoint kernels launched.
The options pin ``mode="separable", impl="cuda", grad_impl="cuda"`` and
``fused="off"`` (no race): the separable forward kernel and the adjoint
kernel carry every step.  ``--mesh`` splits the lanes over the ranks of the
process group (``torchrun``'s, else one rank; ``engine.shard``), the lane
count rounded to an even split; every rank plays the same stream on the
first rank's clock and prints the same numbers.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

__all__ = ["main", "mixed_pairs", "play"]


def mixed_pairs(n, shapes, hard_every=3, seed=0):
    """Alternating-shape, mixed-difficulty pairs, the serving worst case.

    Easy pairs plateau in a few steps; every ``hard_every``-th needs the
    whole budget.  The contrast exercises lane recycling, the alternation
    bucketing.
    """
    rng = np.random.default_rng(seed)
    waves = {}
    out = []
    for i in range(n):
        shape = shapes[i % len(shapes)]
        if shape not in waves:
            x, y, z = np.meshgrid(*[np.linspace(0, np.pi, s) for s in shape],
                                  indexing="ij")
            waves[shape] = (np.sin(x) * np.sin(y) * np.sin(z)).astype(np.float32)
        f = rng.normal(size=shape).astype(np.float32)
        if hard_every and i % hard_every == 0:
            m = np.roll(f, 3, axis=0) + 2.5 * waves[shape]
            m = m + 0.3 * rng.normal(size=shape).astype(np.float32)
        else:
            m = f + 0.02 * waves[shape]
        out.append((f, m.astype(np.float32)))
    return out


def play(sched, pairs, arrivals, *, timeout=None):
    """Submit ``pairs`` at ``arrivals`` (seconds) and drive to completion, on
    the scheduler's clock (``sched.now()``: with a mesh the first rank's, so
    every rank submits alike).  Returns ``(handles, latencies, makespan)``."""
    handles, latencies = {}, {}
    start = sched.now()
    submitted = 0
    n = len(pairs)
    while len(latencies) < n:
        now = sched.now() - start
        while submitted < n and arrivals[submitted] <= now:
            f, m = pairs[submitted]
            handles[submitted] = sched.submit(f, m, timeout=timeout)
            submitted += 1
        if sched.pending:
            sched.step()
        elif submitted < n:
            time.sleep(max(arrivals[submitted] - now, 0.0) + 1e-4)
        end = sched.now() - start
        for i, h in handles.items():
            if h.done and i not in latencies:
                latencies[i] = end - arrivals[i]
    return handles, latencies, sched.now() - start


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--shape", type=int, nargs=3, default=(28, 24, 20))
    ap.add_argument("--n", type=int, default=32, help="requests in the stream")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate (requests/s); 0: submit as fast as "
                         "admission allows")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=3)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-request deadline in seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--mesh", action="store_true",
                    help="split the lanes over the process group's ranks (torchrun's, "
                         "else one)")
    ap.add_argument("--smoke", action="store_true",
                    help="8 mixed pairs over two shapes; assert all complete, "
                         "stages == levels x shapes, and the kernels launched")
    args = ap.parse_args(argv)

    from repro_torch.core.options import RegistrationOptions
    from repro_torch.engine.convergence import ConvergenceConfig
    from repro_torch.engine.serve import RegistrationScheduler
    from repro_torch.kernels import ops

    options = RegistrationOptions(
        tile=(6, 6, 6), levels=2, iters=args.iters, lr=0.1, mode="separable",
        impl="cuda", grad_impl="cuda", fused="off",
        stop=ConvergenceConfig(tol=2e-3, patience=3))
    shape = tuple(args.shape)
    if args.smoke:
        n = 8
        shapes = [shape, tuple(max(s - 4, 8) for s in shape)]
    else:
        n = args.n
        shapes = [shape]
    pairs = mixed_pairs(n, shapes, seed=args.seed)

    mesh = None
    lanes = args.lanes
    if args.mesh:
        from repro_torch.engine.shard import batch_multiple, make_registration_mesh

        mesh = make_registration_mesh(device=args.device)
        mult = batch_multiple(mesh)
        lanes = max(lanes, mult) // mult * mult  # round to an even split
        print(f"mesh: {lanes} lanes over {mult} rank(s), {lanes // mult} a rank "
              f"({mesh.device_type})")

    sched = RegistrationScheduler(options, lanes=lanes, chunk=args.chunk,
                                  max_queue=max(2 * n, 16), mesh=mesh, device=args.device)
    # warm each stage (one per shape x level) outside the timed stream
    for shape_ in shapes:
        f = np.zeros(shape_, np.float32)
        sched.submit(f, f)
    sched.run_until_idle()
    warm_stages = sched.stats.compiles

    if args.rate > 0:
        rng = np.random.default_rng(args.seed + 1)
        arrivals = np.concatenate([[0.0], rng.exponential(1.0 / args.rate, n - 1)]).cumsum()
    else:
        arrivals = np.zeros(n)
    ops.reset_launch_counts()
    handles, latencies, makespan = play(sched, pairs, arrivals, timeout=args.timeout)
    counts = {k: v for k, v in ops.launch_counts().items() if v}

    stats = sched.stats
    lat = np.asarray(sorted(latencies.values()))
    completed = sum(1 for h in handles.values() if h._error is None)
    print(f"{completed}/{n} completed in {makespan:.2f}s "
          f"({completed / makespan:.2f} pairs/s sustained)")
    print(f"latency p50 {np.percentile(lat, 50):.3f}s  p99 {np.percentile(lat, 99):.3f}s")
    print(f"recycled lanes: {stats.recycled}; chunks: {stats.chunks}; buckets: "
          f"{stats.buckets}; stages: {stats.compiles} ({warm_stages} at warm-up); "
          f"kernel launches {counts}")
    if stats.timed_out:
        print(f"timed out: {stats.timed_out}")

    if args.smoke:
        assert completed == n, f"smoke: only {completed}/{n} completed"
        expect = options.levels * len(shapes)
        assert stats.compiles == expect, (
            f"smoke: {stats.compiles} stages, expected {expect} (levels x shapes): "
            "shape bucketing regressed")
        if sched.device.type == "cuda":
            launched = counts.get("bsi_separable", 0) and counts.get("bsi_adjoint", 0)
            assert launched, f"smoke: the kernels did not launch: {counts}"
        print("smoke OK")
    return dict(completed=completed, n=n, makespan=makespan, latencies=latencies,
                stats=stats, counts=counts)


if __name__ == "__main__":
    main()
