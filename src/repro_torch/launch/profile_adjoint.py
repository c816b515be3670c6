"""Where the time of the transposed-matmul BSI adjoint goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_adjoint [--shape X Y Z]
        [--tile D D D] [--channels C] [--reps N] [--split]

Builds the kernels, makes a random ``(X, Y, Z, C)`` cotangent (default: the
paper's phantom1, 512 x 228 x 385, tile 5^3, 3 channels; seed 1, scaled by
1e-3 as in ``chip_smoke.py``) and reports ``ops.bsi_adjoint_matmul`` on it
(:func:`adjoint_matmul_report`): milliseconds a call by CUDA events, the
device milliseconds of each of its launches (``torch.profiler``, per kernel
name), the device memory one call allocates beyond its output, whether two
calls are bit-equal, and its plain version's time.  ``--split`` also
times the box kernel with a stage left out (:func:`stage_split`: three
measurement builds, ``-DREPRO_ADJ_SKIP``).  The last line is one JSON object
with the same numbers.  Needs a CUDA device; there is no CPU
path.
"""

from __future__ import annotations

import argparse
import json
import re

import torch

from repro_torch import PAPER_VOLUMES
from repro_torch.core import ffd
from repro_torch.device import card_name, device_ms_by_name, traced
from repro_torch.kernels import bsi_adjoint, ops
from repro_torch.kernels.build import load_library

__all__ = ["SKIPS", "adjoint_matmul_report", "cuda_ms", "stage_split"]

# the box kernel's stages left out in its measurement builds (csrc:
# REPRO_ADJ_SKIP; 1 the staging, 2 the contraction, 4 the owner sums)
SKIPS = {"no staging": "REPRO_ADJ_SKIP=1", "no contraction": "REPRO_ADJ_SKIP=2",
         "no owner sums": "REPRO_ADJ_SKIP=4", "seam only": "REPRO_ADJ_SKIP=7"}


def cuda_ms(fn, reps=20, warmup=2):
    """Mean milliseconds per call over ``reps`` calls, CUDA events, warmed up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def adjoint_matmul_report(g, tile, grid_shape, reps=20) -> dict:
    """``ops.bsi_adjoint_matmul(g, tile, grid_shape)`` on the card: ``ms``
    (CUDA events), ``stages`` (device ms a call of each launch, by kernel
    name, from ``reps`` traced calls), ``extra_bytes`` (the peak allocated
    during one call beyond what was allocated before it and the output) and
    ``bit_equal`` (two calls give the same bits)."""

    def call():
        return ops.bsi_adjoint_matmul(g, tile, grid_shape)

    def calls():
        for _ in range(reps):
            call()
        torch.cuda.synchronize()

    ms = cuda_ms(call, reps)
    prof, _ = traced(calls)
    stages = {}
    for name, t in device_ms_by_name(prof).items():
        if "adjoint_matmul" in name:
            short = re.search(r"(\w+_kernel)", name).group(1)
            stages[short] = stages.get(short, 0.0) + t / reps
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a = call()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before - a.numel() * a.element_size()
    b = call()
    return dict(ms=ms, stages=stages, extra_bytes=extra, bit_equal=torch.equal(a, b))


def stage_split(g, tile, grid_shape, reps=20) -> dict:
    """Milliseconds a call of the two launches as built (``full``) and with
    each entry of :data:`SKIPS` left out of the box kernel (the builds in
    parallel), timed in turns, twice: ``{label: [ms, ms]}``."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(SKIPS)) as pool:
        libs = {"full": load_library(), **dict(zip(SKIPS, pool.map(
            lambda d: load_library((d,)), SKIPS.values())))}
    out = torch.empty(tuple(grid_shape) + (g.shape[3],), device=g.device)
    split = {k: [] for k in libs}
    for _ in range(2):
        for k, lib in libs.items():
            split[k].append(cuda_ms(lambda: bsi_adjoint.launch_matmul(g, out, tile, lib=lib),
                                    reps))
    return split


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, default=PAPER_VOLUMES["phantom1"])
    ap.add_argument("--tile", type=int, nargs=3, default=(5, 5, 5))
    ap.add_argument("--channels", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--split", action="store_true",
                    help="time the box kernel with a stage left out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_adjoint: needs a CUDA device")

    card = card_name()
    lib = load_library()
    build_s = lib.info.seconds
    for line in lib.info.ptxas:
        if "adjoint_matmul" in line:
            print(f"ptxas {line}")
    vol, tile = tuple(args.shape), tuple(args.tile)
    gshape = ffd.grid_shape_for_volume(vol, tile)
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = torch.randn(vol + (args.channels,), generator=gen, device="cuda") * 1e-3
    rep = adjoint_matmul_report(g, tile, gshape, args.reps)
    out = ops.bsi_adjoint_matmul(g, tile, gshape)
    ref = bsi_adjoint.plain_matmul(g, tile, gshape)
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    plain_ms = cuda_ms(lambda: bsi_adjoint.plain_matmul(g, tile, gshape), reps=3)
    split = stage_split(g, tile, gshape, args.reps) if args.split else {}
    print(f"card: {card}; volume {vol}, tile {tile}, {args.channels} channels, grid "
          f"{gshape}; kernel build {build_s:.2f} s")
    print(f"bsi_adjoint_matmul: {rep['ms']:.4f} ms a call (plain {plain_ms:.3f} ms); "
          f"max |kernel - plain| / max |plain| {rel:.3e}; launches: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in rep["stages"].items())
          + f"; {rep['extra_bytes'] / 1e6:.1f} MB beyond the output; two calls "
          f"bit-equal: {rep['bit_equal']}")
    for k, ms in split.items():
        print(f"  {k}: {', '.join(f'{t:.4f}' for t in ms)} ms")
    print(json.dumps({"card": card, "shape": list(vol), "tile": list(tile),
                      "channels": args.channels, "build_seconds": build_s,
                      "plain_ms": plain_ms, "rel_err": rel, "split": split, **rep}))


if __name__ == "__main__":
    main()
