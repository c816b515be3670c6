"""Where the time of the BSI adjoint kernels goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_adjoint
        [--form separable|matmul] [--shape X Y Z] [--tile D D D] [--channels C]
        [--reps N] [--split]

Builds the kernels, makes a random ``(X, Y, Z, C)`` cotangent (default: the
paper's phantom1, 512 x 228 x 385, tile 5^3, 3 channels; seed 1, scaled by
1e-3 as in ``chip_smoke.py``) and reports the adjoint of ``--form`` on it
(:func:`adjoint_report`; ``separable``, the default, is ``ops.bsi_adjoint``,
the backward of the default registration step; ``matmul`` is
``ops.bsi_adjoint_matmul``): milliseconds a call by CUDA events, the device
milliseconds of each of its launches in launch order (``torch.profiler``),
each kernel's registers and resident blocks an SM (``-Xptxas -v``), the
device memory one call allocates beyond its output, whether two calls are
bit-equal, and its plain version's time; beside them one ``fill_`` and
one ``sum`` of a tensor of the cotangent's shape, the card's own times to
write and to read those bytes.  The separable form's launches are also
timed with each geometry of :func:`fill_geometries` that differs from the
chosen one (:func:`geometry_ms`: a plane's y tiles in runs, a plane whole,
its z control points in parts).  ``--split`` also times the form's main
kernel with a part left out (:func:`stage_split`: measurement builds,
``-DREPRO_SEP_SKIP`` for the separable form, ``-DREPRO_ADJ_SKIP`` for the
matmul form), and the separable form's kernels built for any tile and
channels launched in place of those built for the paper's
(``-DREPRO_SEP_GENERAL=1|2|3``: the streaming kernel, the x sweep,
both).  The last line is one JSON object with the same
numbers.  Needs a CUDA device; there is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import re
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch import PAPER_VOLUMES
from repro_torch.core import ffd
from repro_torch.device import card_name, resident_blocks, traced
from repro_torch.kernels import bsi_adjoint, ops
from repro_torch.kernels.build import load_library

__all__ = ["FORMS", "SKIPS", "adjoint_report", "cuda_ms", "fill_geometries", "geometry_ms",
           "kernel_occupancy", "launch_ms", "stage_split"]

# per form: the dispatcher, the plain version, the bare launch (``lib=``)
# and what its kernels' names hold
FORMS = {
    "separable": (ops.bsi_adjoint, bsi_adjoint.plain, bsi_adjoint.launch,
                  lambda name: "adjoint" in name and "matmul" not in name),
    "matmul": (ops.bsi_adjoint_matmul, bsi_adjoint.plain_matmul, bsi_adjoint.launch_matmul,
               lambda name: "adjoint_matmul" in name),
}
# the measurement builds: the separable form's streaming kernel with a part
# left out (csrc: REPRO_SEP_SKIP; 1 the row loads, 2 the z arithmetic, 4 the
# stores of hy) or its kernels built for any tile and channels launched at
# the paper's (REPRO_SEP_GENERAL; 1 the streaming kernel, 2 the x sweep),
# and the matmul form's box kernel with a part left out (REPRO_ADJ_SKIP; 1
# the staging, 2 the contraction, 4 the owner sums)
SKIPS = {
    "separable": {"no row loads": "REPRO_SEP_SKIP=1", "no z arithmetic": "REPRO_SEP_SKIP=2",
                  "no stores": "REPRO_SEP_SKIP=4", "floor": "REPRO_SEP_SKIP=7",
                  "general stream": "REPRO_SEP_GENERAL=1",
                  "general x sweep": "REPRO_SEP_GENERAL=2", "general": "REPRO_SEP_GENERAL=3"},
    "matmul": {"no staging": "REPRO_ADJ_SKIP=1", "no contraction": "REPRO_ADJ_SKIP=2",
               "no owner sums": "REPRO_ADJ_SKIP=4", "seam only": "REPRO_ADJ_SKIP=7"},
}


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


def _short(name):
    return re.search(r"(\w+_kernel)", name).group(1)


def launch_ms(prof, reps, keep) -> dict:
    """Device milliseconds a call of each launch of a profile of ``reps``
    equal calls whose kernel name ``keep`` accepts, in launch order:
    ``{kernel: ms}``, a kernel launched more than once a call numbered
    ``kernel#1``, ``kernel#2``, ..."""
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA and keep(e.name)),
                    key=lambda e: e.time_range.start)
    per_call = len(events) // reps
    names = [_short(e.name) for e in events[:per_call]]
    out = {}
    for i, name in enumerate(names):
        label = f"{name}#{names[:i + 1].count(name)}" if names.count(name) > 1 else name
        out[label] = sum(e.time_range.elapsed_us() for e in events[i::per_call]) / 1e3 / reps
    return out


def adjoint_report(form, g, tile, grid_shape, reps=20) -> dict:
    """The adjoint of ``form`` (:data:`FORMS`) on ``g`` on the card: ``ms``
    (CUDA events), ``stages`` (device ms a call of each launch, in launch
    order, from ``reps`` traced calls), ``extra_bytes`` (the peak allocated
    during one call beyond what was allocated before it and the output) and
    ``bit_equal`` (two calls give the same bits)."""
    op, _, _, keep = FORMS[form]

    def call():
        return op(g, tile, grid_shape)

    def calls():
        for _ in range(reps):
            call()
        torch.cuda.synchronize()

    ms = cuda_ms(call, reps)
    prof, _ = traced(calls)
    stages = launch_ms(prof, reps, keep)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a = call()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before - a.numel() * a.element_size()
    b = call()
    return dict(ms=ms, stages=stages, extra_bytes=extra, bit_equal=torch.equal(a, b))


def kernel_occupancy(lib, tile, channels, vol) -> dict:
    """``{kernel instantiation: (ptxas line, blocks an SM)}`` for each kernel
    of the separable form in ``lib`` (asserted: no spills).  The streaming
    kernel takes the shared memory and threads of
    ``kernels.bsi_adjoint.stream_blocks``; the x sweep, 256 threads and
    (at the paper's tile) no shared memory."""
    keep = FORMS["separable"][3]
    geo = bsi_adjoint.stream_blocks(tuple(tile), channels, tuple(vol),
                                    bsi_adjoint.card_sms("cuda"))
    out = {}
    for line in lib.info.ptxas:
        name = line.split(":")[0]
        if not keep(name) or "registers" not in line:
            continue
        assert "0/0 B spill" in line, line
        smem, threads = (geo.smem, geo.threads) if "stream" in name else (0, 256)
        regs = int(re.search(r"(\d+) registers", line).group(1))
        out[name] = (line, resident_blocks(regs, smem, threads))
    return out


def fill_geometries(tile, channels, vol, sms) -> dict:
    """The separable form's geometries that fill a card of ``sms`` SMs, or
    do not: ``{label: StreamBlocks}``, each distinct geometry once.
    ``chosen`` is ``kernels.bsi_adjoint.stream_blocks``; ``one block a
    plane`` streams each x plane whole; ``z parts N`` splits each plane's
    z control points into N spans (one run a plane), for N = 2 and for the
    fewest that put as many warps in flight as the chosen geometry aims
    for."""
    from repro_torch.kernels.bsi_adjoint import stream_blocks, stream_geometry

    chosen = stream_blocks(tuple(tile), channels, tuple(vol), sms)
    ty, nzh = -(-vol[1] // tile[1]), -(-vol[2] // tile[2]) + 3
    cands = {"chosen": chosen,
             "one block a plane": stream_geometry(tile, channels, vol, chosen.span, ty)}
    target = bsi_adjoint.STREAM_FILL_WARPS_PER_SM * sms
    for parts in range(2, nzh + 1):
        geo = stream_geometry(tile, channels, vol, -(-chosen.span // parts), ty)
        if parts == 2 or vol[0] * geo.zparts * geo.threads // 32 >= target:
            cands[f"z parts {geo.zparts}"] = geo
        if vol[0] * geo.zparts * geo.threads // 32 >= target:
            break
    out = {}
    for label, geo in cands.items():
        if geo not in out.values():
            out[label] = geo
    return out


def geometry_ms(g, tile, grid_shape, reps=20) -> dict:
    """Milliseconds a call of the separable form's launches with each of
    :func:`fill_geometries` (the card's SMs), timed in turns, twice:
    ``{label: (StreamBlocks, [ms, ms])}``; each output asserted within 1e-5
    of the largest value of the chosen geometry's (runs sum a point's y
    bands in two partials, so the bits may differ)."""
    geos = fill_geometries(tile, g.shape[3], tuple(g.shape[:3]), bsi_adjoint.card_sms(g.device))
    outs = {k: torch.empty(tuple(grid_shape) + (g.shape[3],), device=g.device) for k in geos}
    times = {k: [] for k in geos}
    for _ in range(2):
        for k, geo in geos.items():
            times[k].append(cuda_ms(lambda: bsi_adjoint.launch(g, outs[k], tile, geo=geo), reps))
    first = next(iter(outs.values()))
    for k, o in outs.items():
        assert (o - first).abs().max() <= 1e-5 * first.abs().max(), f"{k} disagrees"
    return {k: (geos[k], times[k]) for k in geos}


def stage_split(form, g, tile, grid_shape, reps=20) -> dict:
    """Milliseconds a call of the form's launches as built (``full``) and in
    each measurement build of :data:`SKIPS` (the builds in parallel), timed
    in turns, twice: ``{label: [ms, ms]}``."""
    skips = SKIPS[form]
    launch = FORMS[form][2]
    with ThreadPoolExecutor(len(skips)) as pool:
        libs = {"full": load_library(), **dict(zip(skips, pool.map(
            lambda d: load_library((d,)), skips.values())))}
    out = torch.empty(tuple(grid_shape) + (g.shape[3],), device=g.device)
    split = {k: [] for k in libs}
    for _ in range(2):
        for k, lib in libs.items():
            split[k].append(cuda_ms(lambda: launch(g, out, tile, lib=lib), reps))
    return split


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--form", choices=tuple(FORMS), default="separable")
    ap.add_argument("--shape", type=int, nargs=3, default=PAPER_VOLUMES["phantom1"])
    ap.add_argument("--tile", type=int, nargs=3, default=(5, 5, 5))
    ap.add_argument("--channels", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--split", action="store_true",
                    help="time the form's main kernel with a part left out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_adjoint: needs a CUDA device")

    card = card_name()
    lib = load_library()
    build_s = lib.info.seconds
    vol, tile, form = tuple(args.shape), tuple(args.tile), args.form
    gshape = ffd.grid_shape_for_volume(vol, tile)
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = torch.randn(vol + (args.channels,), generator=gen, device="cuda") * 1e-3
    print(f"card: {card}; volume {vol}, tile {tile}, {args.channels} channels, grid "
          f"{gshape}; kernel build {build_s:.2f} s")
    if form == "separable":
        occ = kernel_occupancy(lib, tile, args.channels, vol)
    else:
        occ = {ln.split(":")[0]: (ln, None) for ln in lib.info.ptxas
               if FORMS[form][3](ln.split(":")[0]) and "registers" in ln}
    for line, per_sm in occ.values():
        print(f"ptxas {line}" + ("" if per_sm is None else f"; {per_sm} blocks an SM"))
    field = torch.empty_like(g)
    fill_ms = cuda_ms(lambda: field.fill_(0.0), args.reps)
    del field
    read_ms = cuda_ms(lambda: g.sum(), args.reps)
    print(f"write floor: one fill_ of the cotangent ({g.numel() * 4 / 1e6:.1f} MB), "
          f"{fill_ms:.4f} ms; read floor: one sum of it, {read_ms:.4f} ms")
    op, plain = FORMS[form][:2]
    rep = adjoint_report(form, g, tile, gshape, args.reps)
    out = op(g, tile, gshape)
    ref = plain(g, tile, gshape)
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    plain_ms = cuda_ms(lambda: plain(g, tile, gshape), reps=3)
    geos = geometry_ms(g, tile, gshape, args.reps) if form == "separable" else {}
    split = stage_split(form, g, tile, gshape, args.reps) if args.split else {}
    print(f"bsi_adjoint ({form}): {rep['ms']:.4f} ms a call (plain {plain_ms:.3f} ms); "
          f"max |kernel - plain| / max |plain| {rel:.3e}; launches: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in rep["stages"].items())
          + f"; {rep['extra_bytes'] / 1e6:.1f} MB beyond the output; two calls "
          f"bit-equal: {rep['bit_equal']}")
    for k, (geo, ms) in geos.items():
        print(f"  {k}: {vol[0] * geo.runs * geo.zparts} blocks of {geo.threads} threads "
              f"({geo.runs} runs of {geo.run} y tiles, {geo.zparts} z parts of {geo.span}): "
              + ", ".join(f"{t:.4f}" for t in ms) + " ms")
    for k, ms in split.items():
        print(f"  {k}: {', '.join(f'{t:.4f}' for t in ms)} ms")
    print(json.dumps({"card": card, "form": form, "shape": list(vol), "tile": list(tile),
                      "channels": args.channels, "build_seconds": build_s,
                      "fill_ms": fill_ms, "read_ms": read_ms, "plain_ms": plain_ms,
                      "rel_err": rel,
                      "geometries": {k: dict(geo._asdict(), ms=ms)
                                     for k, (geo, ms) in geos.items()},
                      "occupancy": {k: v[1] for k, v in occ.items()}, "split": split,
                      **rep}))


if __name__ == "__main__":
    main()
