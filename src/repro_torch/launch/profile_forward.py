"""Where the time of the forward BSI kernels goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_forward [--shape X Y Z]
        [--tile D D D] [--channels C] [--reps N] [--kernels NAME ...] [--split]
        [--against LIB]

Builds the kernels, makes a random ``(nx, ny, nz, C)`` control grid for the
volume (default: the paper's phantom1, 512 x 228 x 385, tile 5^3, 3
channels; seed 3, scaled by 2.5 as in ``chip_smoke.py``) and reports
``ops.bsi_ttli``, ``ops.bsi_separable``, ``ops.bsi_tt`` and
``ops.bsi_matmul`` on it (or the kernels ``--kernels`` names;
:func:`forward_report`): milliseconds a call by CUDA events, device
milliseconds a call from ``torch.profiler``, the largest difference from the
plain version and whether the two are equal bit for bit, whether two calls
are bit-equal, the kernel's registers, shared memory and resident blocks an
SM (:func:`occupancy`), the SM clock under load
(:func:`sm_clock_under_load`) and, for TT and the matrix form, its static
instructions of :data:`SASS_OPS` (``cuobjdump -sass``); beside them, one
``fill_`` of a tensor of the field's shape, the card's own time to write
those bytes.  ``--split`` also times each kernel with a part left out
(:func:`stage_split`: measurement builds, ``-DREPRO_FWD_SKIP`` for the
staged kernels, ``-DREPRO_TT_SKIP`` for TT, ``-DREPRO_MM_SKIP`` for the
matrix form).  ``--against LIB`` runs each kernel as built and as in the
library at ``LIB`` (another build, as the parent commit's) on the same
inputs, compares the outputs bit for bit and times both in turns
(:func:`against`).  The last line is one JSON object with the numbers.
Needs a CUDA device; there is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch import PAPER_VOLUMES
from repro_torch.core import ffd
from repro_torch.device import card_name, device_ms_by_name, resident_blocks, traced
from repro_torch.kernels import bsi_matmul, bsi_separable, bsi_tt, bsi_ttli, ops
from repro_torch.kernels.bsi_adjoint import card_sms
from repro_torch.kernels.build import BuildInfo, Library, load_library, sass_counts
from repro_torch.launch.profile_adjoint import cuda_ms

__all__ = ["KERNELS", "MODULES", "SKIPS", "against", "forward_report", "kernel_occupancy",
           "occupancy", "stage_split"]

MODULES = {"bsi_ttli": bsi_ttli, "bsi_separable": bsi_separable, "bsi_tt": bsi_tt,
           "bsi_matmul": bsi_matmul}
KERNELS = tuple(MODULES)
# the parts left out in the measurement builds, per kernel.  The staged
# kernels (csrc/bsi_forward.cuh: REPRO_FWD_SKIP): 1 the x-y stage, 2 the z
# stage's table and arithmetic (a constant is stored), 4 the stores; 8 the
# stores alone: the same positions in the same order, a constant value, no
# stage.  TT (csrc/bsi_tt.cu: REPRO_TT_SKIP): 1 the stores, 2 the weights
# (each term's weight a constant), 4 the sums (a constant is stored), 8 all
# but the sums (no barrier, nothing stored but the staging); 16 one fused
# multiply-add a term (a rounding the form may not have).  The matrix form
# (csrc/bsi_matmul.cu: REPRO_MM_SKIP): 1 the stores, 2 the products (a
# constant is stored at the same positions), 4 the window's copy and W^T's
# build; 6 the stores alone.
STAGED_SKIPS = {"no x-y stage": "REPRO_FWD_SKIP=1", "no z arithmetic": "REPRO_FWD_SKIP=2",
                "no stores": "REPRO_FWD_SKIP=4", "floor": "REPRO_FWD_SKIP=7",
                "store only": "REPRO_FWD_SKIP=8"}
SKIPS = {"bsi_ttli": STAGED_SKIPS, "bsi_separable": STAGED_SKIPS,
         "bsi_tt": {"no stores": "REPRO_TT_SKIP=1", "constant weights": "REPRO_TT_SKIP=2",
                    "constant weights, no stores": "REPRO_TT_SKIP=3",
                    "store only": "REPRO_TT_SKIP=4", "sums alone": "REPRO_TT_SKIP=8",
                    "constant weights, sums alone": "REPRO_TT_SKIP=10",
                    "fused multiply-adds, sums alone": "REPRO_TT_SKIP=24"},
         "bsi_matmul": {"no stores": "REPRO_MM_SKIP=1", "no products": "REPRO_MM_SKIP=2",
                        "stores alone": "REPRO_MM_SKIP=6"}}
# the static SASS instructions reported per kernel (cuobjdump -sass)
SASS_OPS = {"bsi_tt": ("FMUL", "FADD", "FFMA", "LDS"),
            "bsi_matmul": ("FFMA", "HGMMA", "LDS", "STS", "UBLKCP")}


def _call(name, phi, tile, vol):
    return getattr(ops, name)(phi, tile, vol)


def forward_report(name, phi, tile, vol, reps=20) -> dict:
    """``ops.<name>(phi, tile, vol)`` on the card: ``ms`` (CUDA events),
    ``device_ms`` (the kernel's device time a call, from ``reps`` traced
    calls), ``max_abs_err`` and ``rel_err`` against the plain version (of
    the largest plain value), ``equals_plain`` (the same bits as the plain
    version), ``bit_equal`` (two calls give the same bits) and
    ``plain_ms``."""
    module = MODULES[name]

    def calls():
        for _ in range(reps):
            _call(name, phi, tile, vol)
        torch.cuda.synchronize()

    ms = cuda_ms(lambda: _call(name, phi, tile, vol), reps)
    prof, _ = traced(calls)
    device_ms = sum(t for k, t in device_ms_by_name(prof).items()
                    if f"{name}_kernel" in k) / reps
    a, b = _call(name, phi, tile, vol), _call(name, phi, tile, vol)
    ref = module.plain(phi, tile, vol)
    err = (a - ref).abs().max().item()
    plain_ms = cuda_ms(lambda: module.plain(phi, tile, vol), reps=3)
    return dict(ms=ms, device_ms=device_ms, max_abs_err=err,
                rel_err=err / ref.abs().max().item(), equals_plain=torch.equal(a, ref),
                bit_equal=torch.equal(a, b), plain_ms=plain_ms)


def occupancy(lib, name, tile, channels, vol) -> dict:
    """The ``-Xptxas -v`` line of the kernel's instantiation for ``tile``
    and ``channels`` (``registers``, with its spills), its shared memory
    a block, its resident blocks an SM and its grid; the staged kernels'
    tiles along z a block too (``kernels.bsi_ttli.forward_blocks``), TT's
    geometry from ``kernels.bsi_tt.occupancy_key``."""
    tile, vol = tuple(tile), tuple(vol)
    if name in ("bsi_tt", "bsi_matmul"):
        symbol, smem, grid = MODULES[name].occupancy_key(tile, channels, vol,
                                                         card_sms(torch.device("cuda")))
        extra = {}
    else:
        symbol = f"{name}_kernelILi{3 if channels == 3 else 0}E"
        geo = bsi_ttli.forward_blocks(tile, channels, vol)
        smem, grid, extra = geo.smem, geo.grid, dict(bz=geo.bz)
    return dict(kernel_occupancy(lib, symbol, smem, grid), **extra)


def kernel_occupancy(lib, symbol, smem, grid) -> dict:
    """The ``-Xptxas -v`` line of the one kernel of ``lib`` whose name holds
    ``symbol`` (``registers``, with its spills), ``smem`` (its shared memory
    a block, in bytes), its resident blocks an SM at 256 threads a block and
    ``grid``."""
    regs = [ln for ln in lib.info.ptxas if symbol in ln and "registers" in ln]
    assert len(regs) == 1, regs
    per_sm = resident_blocks(int(re.search(r"(\d+) registers", regs[0]).group(1)),
                             smem, bsi_ttli.KERNEL_THREADS)
    return dict(registers=regs[0], smem=smem, blocks_per_sm=per_sm, grid=grid)


def sm_clock_under_load(fn, n=400) -> str:
    """nvidia-smi's SM clock (MHz) and power draw, read while ``n`` calls
    of ``fn`` queued back to back run."""
    for _ in range(n):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], check=True, capture_output=True, text=True,
        timeout=60).stdout.strip()
    torch.cuda.synchronize()
    return out


def stage_split(phi, tile, vol, names=KERNELS, reps=20) -> dict:
    """Milliseconds a call of each kernel of ``names`` as built (``full``)
    and in each of its measurement builds (:data:`SKIPS`, all built in
    parallel), timed in turns, twice: ``{kernel: {label: [ms, ms]}}``."""
    defines = sorted({d for n in names for d in SKIPS[n].values()})
    with ThreadPoolExecutor(len(defines)) as pool:
        built = dict(zip(defines, pool.map(lambda d: load_library((d,)), defines)))
    out = torch.empty(tuple(vol) + (phi.shape[3],), device=phi.device)
    libs = {n: {"full": load_library(), **{k: built[d] for k, d in SKIPS[n].items()}}
            for n in names}
    split = {n: {k: [] for k in libs[n]} for n in names}
    for _ in range(2):
        for n in names:
            for k, lib in libs[n].items():
                split[n][k].append(cuda_ms(
                    lambda: MODULES[n].launch(phi, out, tile, lib=lib), reps))
    return split


def against(phi, tile, vol, other, names=KERNELS, reps=20) -> dict:
    """Each kernel of ``names`` as built and as in ``other`` (another
    build's library, as the parent commit's) on the same inputs:
    ``{kernel: {"bit_equal": the two outputs equal, "ms": [this, other,
    other, this]}}``, the four timed in turns."""
    out = {}
    for n in names:
        a, b = (torch.empty(tuple(vol) + (phi.shape[3],), device=phi.device)
                for _ in range(2))
        MODULES[n].launch(phi, a, tile)
        MODULES[n].launch(phi, b, tile, lib=other)
        out[n] = {"bit_equal": bool(torch.equal(a, b))}
        out[n]["ms"] = [cuda_ms(lambda: MODULES[n].launch(phi, a, tile, lib=lib), reps)
                        for lib in (load_library(), other, other, load_library())]
    return out


def _grid(vol, tile, channels):
    gshape = ffd.grid_shape_for_volume(vol, tile)
    gen = torch.Generator(device="cuda").manual_seed(3)
    return torch.randn(gshape + (channels,), generator=gen, device="cuda") * 2.5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, default=PAPER_VOLUMES["phantom1"])
    ap.add_argument("--tile", type=int, nargs=3, default=(5, 5, 5))
    ap.add_argument("--channels", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS))
    ap.add_argument("--split", action="store_true",
                    help="time each kernel with a part left out")
    ap.add_argument("--against", metavar="LIB",
                    help="another build of the kernels: outputs compared bit for bit, "
                         "both timed in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: needs a CUDA device")

    vol, tile = tuple(args.shape), tuple(args.tile)
    phi = _grid(vol, tile, args.channels)
    card = card_name()
    lib = load_library()
    build_s = lib.info.seconds
    print(f"card: {card}; volume {vol}, tile {tile}, {args.channels} channels, grid "
          f"{tuple(phi.shape[:3])}; kernel build {build_s:.2f} s")
    field = torch.empty(vol + (args.channels,), device="cuda")
    fill_ms = cuda_ms(lambda: field.fill_(0.0), args.reps)
    del field
    print(f"write floor: one fill_ of the field, {fill_ms:.4f} ms")
    result = {"card": card, "shape": list(vol), "tile": list(tile),
              "channels": args.channels, "build_seconds": build_s, "fill_ms": fill_ms}
    for name in args.kernels:
        rep = forward_report(name, phi, tile, vol, args.reps)
        rep.update(occupancy(lib, name, tile, args.channels, vol))
        rep["clock"] = sm_clock_under_load(lambda: _call(name, phi, tile, vol))
        print(f"{name}: {rep['ms']:.4f} ms a call (device {rep['device_ms']:.4f} ms; "
              f"plain {rep['plain_ms']:.3f} ms); max |kernel - plain| "
              f"{rep['max_abs_err']:.3e} ({rep['rel_err']:.3e} of the largest), "
              f"bit for bit: {rep['equals_plain']}; two calls bit-equal: "
              f"{rep['bit_equal']}; {rep['registers']}; "
              f"{rep['smem']} B of shared memory a block, {rep['blocks_per_sm']} "
              f"blocks an SM; under load: {rep['clock']} (SM clock, its maximum, "
              f"power)")
        if name in SASS_OPS:  # the sums' instructions, as compiled
            fn = rep["registers"].split(":")[0]
            rep["sass"] = {op: sass_counts(lib.info.path, fn, op)[fn]
                           for op in SASS_OPS[name]}
            print(f"{name} SASS, static instructions: {rep['sass']}")
        result[name] = rep
    if args.split:
        result["split"] = stage_split(phi, tile, vol, args.kernels, args.reps)
        for name, split in result["split"].items():
            for k, ms in split.items():
                print(f"  {name} {k}: {', '.join(f'{t:.4f}' for t in ms)} ms")
    if args.against:
        other = Library(BuildInfo(Path(args.against), 0.0, ()))
        result["against"] = against(phi, tile, vol, other, args.kernels, args.reps)
        for name, r in result["against"].items():
            print(f"{name} against {args.against}: bit-equal {r['bit_equal']}; ms this, "
                  f"other, other, this: {', '.join(f'{t:.4f}' for t in r['ms'])}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
