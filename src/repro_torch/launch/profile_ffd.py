"""Where the time of the port's ``ffd_register`` goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_ffd [--shape X Y Z]
        [--iters N] [--calls K] [--top T] [--similarity NAME] [--remap]
        [--mode ttli|separable|tt|matmul|auto] [--grad-impl cuda|matmul|auto]
        [--fused on|off|auto] [--transform displacement|velocity]
        [--regularizer none|bending] [--optimizer adam|lbfgs|gauss_newton]
        [--stop TOL]

Builds the kernels (printing the build seconds), makes ``make_pair(shape,
seed=0)`` (default: the paper's phantom1, 512 x 228 x 385), with ``--remap``
maps the moving volume's intensities through ``(1 - v)^1.5`` (a synthetic
second modality), and traces the process's first ``ffd_register`` call with
the default options (the kernels), ``--similarity`` (default ``ssd``;
``nmi`` and ``ncc`` run the two-pass fused kernels, ``lncc`` the one-pass
marching-column kernel), ``--mode`` (the forward kernel; ``matmul`` also the fused
step's matrix-form displacement), ``--grad-impl`` (``matmul``: the
transposed-matmul adjoint), ``--fused``, ``--transform``,
``--regularizer``, ``--optimizer`` and ``--stop`` (early stopping at that
relative tolerance, ``ConvergenceConfig(tol=TOL)``) under ``torch.profiler``,
printing the host-side calls that took the most time (the first call pays
one-off costs beyond the build).  ``auto`` on ``--mode`` (with ``impl``
then ``auto`` too), ``--grad-impl`` or ``--fused`` is resolved by the
autotuner before the first traced call, and its race's seconds and result
are printed.  Then it times
``--calls`` more calls, and traces one more warm call, printing the device
time per kernel name, the package's CUDA kernels against PyTorch's own
kernels (the plain glue), the device time of each package kernel per
pyramid level (:func:`per_level_ms`), and the device's busy and idle share
of the call.
The last line is one JSON object with the same numbers.  Needs a CUDA device;
there is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import (PAPER_VOLUMES, ConvergenceConfig, RegistrationOptions,
                         ffd_register, make_pair)
from repro_torch.device import card_name, device_ms_by_name, traced
from repro_torch.engine.autotune import RACES, resolve_options
from repro_torch.kernels.build import load_library

def per_level_ms(prof, levels):
    """Device milliseconds of each package kernel per pyramid level, coarse
    first: its launches in time order, cut into ``levels`` equal runs.  Only
    for a kernel launched as often on every level (the fused step and the
    adjoint, once a step each); the others are left out."""
    starts = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "repro_torch" in e.name:
            starts.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.elapsed_us() / 1e3))
    out = {}
    for name, launches in starts.items():
        if len(launches) % levels:
            continue
        launches.sort()
        n = len(launches) // levels
        out[name] = [sum(ms for _, ms in launches[i * n:(i + 1) * n])
                     for i in range(levels)]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, default=PAPER_VOLUMES["phantom1"])
    ap.add_argument("--iters", type=int, default=RegistrationOptions().iters)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--similarity", default="ssd")
    ap.add_argument("--remap", action="store_true",
                    help="moving volume through (1 - v)^1.5")
    ap.add_argument("--mode", default="ttli",
                    choices=["ttli", "separable", "tt", "matmul", "auto"])
    ap.add_argument("--grad-impl", default="cuda", choices=["cuda", "matmul", "auto"])
    ap.add_argument("--fused", default="on", choices=["on", "off", "auto"])
    ap.add_argument("--transform", default="displacement",
                    choices=["displacement", "velocity"])
    ap.add_argument("--regularizer", default="none", choices=["none", "bending"])
    ap.add_argument("--optimizer", default="adam",
                    choices=["adam", "lbfgs", "gauss_newton"])
    ap.add_argument("--stop", type=float, default=None, metavar="TOL")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_ffd: needs a CUDA device")

    card = card_name()
    build_s = load_library().info.seconds
    fixed, moving, _ = make_pair(tuple(args.shape), seed=0)
    if args.remap:
        moving = (1.0 - moving) ** 1.5
    opts = RegistrationOptions(iters=args.iters, similarity=args.similarity,
                               mode=args.mode, grad_impl=args.grad_impl,
                               impl="auto" if args.mode == "auto" else "cuda",
                               fused=args.fused, transform=args.transform,
                               regularizer=args.regularizer, optimizer=args.optimizer,
                               stop=None if args.stop is None
                               else ConvergenceConfig(tol=args.stop))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resolved = resolve_options(opts, tuple(fixed.shape), torch.device("cuda"))
    resolve_s = time.perf_counter() - t0
    resolve_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"resolved mode={resolved.mode} impl={resolved.impl} "
          f"grad_impl={resolved.grad_impl} fused={resolved.fused} "
          f"({resolved.fused_reason}) in {resolve_s:.3f} s, peak device memory "
          f"{resolve_peak:.2f} GiB")
    races = [[race.seconds, list(race.timings)] for race in RACES]
    for race_s, timings in races:
        print(f"  race of {race_s:.3f} s, median ms per gradient (None: did not fit): "
              + ", ".join(f"{n} {'None' if us is None else format(us / 1e3, '.3f')}"
                          for n, us in timings))

    def run():
        ffd_register(fixed, moving, options=opts)

    traced(lambda: torch.ones(1, device="cuda").sum().item())  # profiler start-up
    cold, cold_wall = traced(run)
    host = sorted(cold.key_averages(), key=lambda a: -a.self_cpu_time_total)
    host_top = [[a.key, a.count, a.self_cpu_time_total / 1e3] for a in host[: args.top]]
    print(f"card: {card}; shape {tuple(args.shape)}, iters {args.iters}, "
          f"similarity {args.similarity}, remap {args.remap}, mode {args.mode}, "
          f"grad_impl {args.grad_impl}, transform {args.transform}, regularizer "
          f"{args.regularizer}, optimizer {args.optimizer}, stop {args.stop}; "
          f"kernel build {build_s:.2f} s")
    print(f"first call (traced): wall {cold_wall * 1e3:.1f} ms; host self time by op:")
    for key, count, ms in host_top:
        print(f"  {ms:10.2f} ms  x{count:<6d} {key[:100]}")

    seconds = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(args.calls):
        t0 = time.perf_counter()
        run()
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"later calls, seconds each: {seconds}; peak device memory {peak:.2f} GiB")

    warm, wall = traced(run)
    by_name = device_ms_by_name(warm)
    busy = sum(by_name.values())
    ours = sum(t for n, t in by_name.items() if "repro_torch" in n)
    print(f"warm call (traced): wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({busy / (wall * 1e3):.1%}), package kernels {ours:.1f} ms, "
          f"PyTorch kernels {busy - ours:.1f} ms")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]
    for name, ms in top:
        print(f"  {ms:10.2f} ms  {name[:110]}")
    levels = per_level_ms(warm, opts.levels)
    print("package kernels per level, coarse first (launches split evenly):")
    for name, split in sorted(levels.items(), key=lambda kv: -sum(kv[1])):
        print("  " + " + ".join(f"{ms:.2f}" for ms in split) + f" ms  {name[:100]}")
    print(json.dumps({
        "card": card, "shape": list(args.shape), "iters": args.iters,
        "similarity": args.similarity, "remap": args.remap, "mode": args.mode,
        "grad_impl": args.grad_impl, "fused": args.fused, "transform": args.transform,
        "regularizer": args.regularizer, "optimizer": args.optimizer, "stop": args.stop,
        "resolved": [resolved.mode, resolved.impl, resolved.grad_impl, resolved.fused],
        "resolve_seconds": resolve_s, "resolve_peak_gib": resolve_peak, "races": races,
        "build_seconds": build_s, "peak_gib": peak,
        "first_call_traced_ms": cold_wall * 1e3, "first_call_host_top": host_top,
        "seconds_per_call": seconds, "profiled_wall_ms": wall * 1e3,
        "device_busy_ms": busy, "busy_share": busy / (wall * 1e3),
        "package_kernels_ms": ours, "pytorch_kernels_ms": busy - ours,
        "top": [[n[:200], ms] for n, ms in top],
        "per_level_ms": {n[:200]: split for n, split in levels.items()}}))


if __name__ == "__main__":
    main()
