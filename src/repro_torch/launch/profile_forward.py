"""Where the time of the staged forward BSI kernels goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_forward [--shape X Y Z]
        [--tile D D D] [--channels C] [--reps N] [--split]

Builds the kernels, makes a random ``(nx, ny, nz, C)`` control grid for the
volume (default: the paper's phantom1, 512 x 228 x 385, tile 5^3, 3
channels; seed 3, scaled by 2.5 as in ``chip_smoke.py``) and reports
``ops.bsi_ttli`` and ``ops.bsi_separable`` on it (:func:`forward_report`):
milliseconds a call by CUDA events, device milliseconds a call from
``torch.profiler``, the largest difference from the plain version, whether
two calls are bit-equal, and the kernel's registers and resident blocks an
SM; beside them, one ``fill_`` of a tensor of the field's shape, the card's
own time to write those bytes.  ``--split`` also times each kernel with a
part left out (:func:`stage_split`: measurement builds,
``-DREPRO_FWD_SKIP``).  The last line is one JSON object with the numbers.
Needs a CUDA device; there is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import re
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch import PAPER_VOLUMES
from repro_torch.core import ffd
from repro_torch.device import card_name, device_ms_by_name, resident_blocks, traced
from repro_torch.kernels import bsi_separable, bsi_ttli, ops
from repro_torch.kernels.build import load_library
from repro_torch.launch.profile_adjoint import cuda_ms

__all__ = ["KERNELS", "MODULES", "SKIPS", "forward_report", "occupancy", "stage_split"]

MODULES = {"bsi_ttli": bsi_ttli, "bsi_separable": bsi_separable}
KERNELS = tuple(MODULES)
# the parts left out in the measurement builds (csrc/bsi_forward.cuh:
# REPRO_FWD_SKIP; 1 the x-y stage, 2 the z stage's table and arithmetic (a
# constant is stored), 4 the stores; 8 the stores alone: the same positions
# in the same order, a constant value, no stage)
SKIPS = {"no x-y stage": "REPRO_FWD_SKIP=1", "no z arithmetic": "REPRO_FWD_SKIP=2",
         "no stores": "REPRO_FWD_SKIP=4", "floor": "REPRO_FWD_SKIP=7",
         "store only": "REPRO_FWD_SKIP=8"}


def _call(name, phi, tile, vol):
    return getattr(ops, name)(phi, tile, vol)


def forward_report(name, phi, tile, vol, reps=20) -> dict:
    """``ops.<name>(phi, tile, vol)`` on the card: ``ms`` (CUDA events),
    ``device_ms`` (the kernel's device time a call, from ``reps`` traced
    calls), ``max_abs_err`` and ``rel_err`` against the plain version (of
    the largest plain value), ``bit_equal`` (two calls give the same bits)
    and ``plain_ms``."""
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
                rel_err=err / ref.abs().max().item(), bit_equal=torch.equal(a, b),
                plain_ms=plain_ms)


def occupancy(lib, name, tile, channels, vol) -> dict:
    """The ``-Xptxas -v`` line of the kernel's instantiation for
    ``channels`` (``registers``; asserted: no spills), its shared memory a
    block, its resident blocks an SM, its tiles along z a block and its grid
    (``kernels.bsi_ttli.forward_blocks``)."""
    inst = f"{name}_kernelILi{3 if channels == 3 else 0}E"
    regs = [ln for ln in lib.info.ptxas if inst in ln and "registers" in ln]
    assert len(regs) == 1 and "0/0 B spill" in regs[0], regs
    geo = bsi_ttli.forward_blocks(tuple(tile), channels, tuple(vol))
    per_sm = resident_blocks(int(re.search(r"(\d+) registers", regs[0]).group(1)),
                             geo.smem, bsi_ttli.KERNEL_THREADS)
    return dict(registers=regs[0], smem=geo.smem, blocks_per_sm=per_sm, bz=geo.bz,
                grid=geo.grid)


def stage_split(phi, tile, vol, reps=20) -> dict:
    """Milliseconds a call of each kernel as built (``full``) and in each
    measurement build of :data:`SKIPS` (built in parallel), timed in turns,
    twice: ``{kernel: {label: [ms, ms]}}``."""
    with ThreadPoolExecutor(len(SKIPS)) as pool:
        libs = {"full": load_library(), **dict(zip(SKIPS, pool.map(
            lambda d: load_library((d,)), SKIPS.values())))}
    out = torch.empty(tuple(vol) + (phi.shape[3],), device=phi.device)
    split = {name: {k: [] for k in libs} for name in KERNELS}
    for _ in range(2):
        for name in KERNELS:
            for k, lib in libs.items():
                split[name][k].append(cuda_ms(
                    lambda: MODULES[name].launch(phi, out, tile, lib=lib), reps))
    return split


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
    ap.add_argument("--split", action="store_true",
                    help="time each kernel with a part left out")
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
    for name in KERNELS:
        rep = forward_report(name, phi, tile, vol, args.reps)
        rep.update(occupancy(lib, name, tile, args.channels, vol))
        print(f"{name}: {rep['ms']:.4f} ms a call (device {rep['device_ms']:.4f} ms; "
              f"plain {rep['plain_ms']:.3f} ms); max |kernel - plain| "
              f"{rep['max_abs_err']:.3e} ({rep['rel_err']:.3e} of the largest); two "
              f"calls bit-equal: {rep['bit_equal']}; {rep['registers']}; "
              f"{rep['smem']} B of shared memory a block, {rep['blocks_per_sm']} "
              f"blocks an SM")
        result[name] = rep
    if args.split:
        result["split"] = stage_split(phi, tile, vol, args.reps)
        for name, split in result["split"].items():
            for k, ms in split.items():
                print(f"  {name} {k}: {', '.join(f'{t:.4f}' for t in ms)} ms")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
