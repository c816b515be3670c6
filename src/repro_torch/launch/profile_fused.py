"""Where the time of the fused ssd and stats kernels goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_fused [--shape X Y Z]
        [--tile D D D] [--reps N] [--kernels NAME ...] [--split]
        [--sass-against LIB]

Builds the kernels, makes ``make_pair(shape, seed=0)`` (default: the paper's
phantom1, 512 x 228 x 385) and the control grid of ``chip_smoke.py``'s phase
3 (seed 0, scaled by 2.5 and then by 0.4, the level's own scale), and
reports ``ops.fused_ssd_loss`` (``bsi_fused``) on the pair and
``ops.fused_stats`` (``bsi_fused_stats``) on the moving volume remapped by
``(1 - v)^1.5``, as ``chip_smoke.py`` runs them (:func:`fused_report`):
milliseconds a call by CUDA events, the device milliseconds a call of the
fused kernel and of the lane-wise reduce after it (``torch.profiler``), the
difference from the plain version relative to it (of the sum; for stats also
whether min, max and count equal the plain version's), whether two calls are
bit-equal, the kernel's registers, shared memory, resident blocks an SM and
grid (``kernels.bsi_fused.occupancy_key``), and the SM clock under load.
Beside them, a ``sum`` of each volume: the card's own time to read those
bytes.  ``--split`` also times each kernel with a part left out
(:func:`fused_split`: measurement builds, ``-DREPRO_FUSED_SKIP``).
``--sass-against LIB`` compares the SASS (``cuobjdump -sass``) of this
build's kernels of :data:`SASS_SAME` with that of the library at ``LIB``
(another build of the kernels, as the parent commit's), function by
function.  The last line is one JSON object with the numbers.  Needs a CUDA
device; there is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch import PAPER_VOLUMES, make_pair
from repro_torch.core import ffd
from repro_torch.device import card_name, device_ms_by_name, traced
from repro_torch.kernels import bsi_fused, ops
from repro_torch.kernels.build import load_library, nvcc_path
from repro_torch.launch.profile_adjoint import cuda_ms
from repro_torch.launch.profile_forward import kernel_occupancy, sm_clock_under_load

__all__ = ["KERNELS", "SASS_SAME", "SKIPS", "fused_report", "fused_split", "inputs",
           "sass_compare"]

KERNELS = {"bsi_fused": "ssd", "bsi_fused_stats": "stats"}
# the parts left out in the measurement builds (csrc/bsi_fused.cu:
# REPRO_FUSED_SKIP): 1 the x-y stage, 2 the displacement (each voxel sampled
# at identity), 4 the gathers (the sample is the sum of the voxel's
# coordinates: the displacement stays, the moving volume is not read); 7 all
# three; 8 all but the reduction (each thread's sums a constant)
SKIPS = {"no x-y stage": "REPRO_FUSED_SKIP=1", "identity sample": "REPRO_FUSED_SKIP=2",
         "no gathers": "REPRO_FUSED_SKIP=4", "floor": "REPRO_FUSED_SKIP=7",
         "reduction alone": "REPRO_FUSED_SKIP=8"}
# the kernels --sass-against compares: every fused kernel but the lerp form's
# ssd and stats, the lane-wise reduce and the staged forward kernels
SASS_SAME = ("bsi_fused_ncc_kernel", "bsi_fused_nmi_kernel", "bsi_fused_lncc_kernel",
             "bsi_fused_ssd_kernelILi1E", "bsi_fused_stats_kernelILi1E",
             "reduce_partials_kernel", "bsi_ttli_kernel", "bsi_separable_kernel")


def inputs(shape, tile):
    """``(phi, moving, fixed, remapped)`` on the card, as ``chip_smoke.py``'s
    phase 3 makes them."""
    fixed, moving, _ = make_pair(shape, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    phi = torch.randn(ffd.grid_shape_for_volume(shape, tile) + (3,), generator=gen,
                      device="cuda") * 2.5
    return phi * 0.4, moving, fixed, (1.0 - moving) ** 1.5


def _launch(kind, phi, mov, fix, tile, lib):
    blocks = bsi_fused.moment_blocks(tile, tuple(mov.shape)).tiles
    return bsi_fused.launch(kind, phi, mov, fix, tile, blocks, lib=lib)


def fused_report(name, phi, mov, fix, tile, reps=20) -> dict:
    """Kernel ``name`` through its dispatcher on the card: ``ms`` (CUDA
    events), ``kernel_ms`` and ``reduce_ms`` (device time a call of the
    fused kernel and of the reduce, from ``reps`` traced calls),
    ``rel_err`` (of the sum against the plain version), ``exact`` (stats:
    min, max and count equal the plain version's), ``bit_equal`` (two calls)
    and ``plain_ms``."""
    if KERNELS[name] == "ssd":
        def call():
            return ops.fused_ssd_loss(phi, mov, fix, tile)

        def plain():
            return bsi_fused.plain(phi, mov, fix, tile) / mov.numel()
    else:
        def call():
            return ops.fused_stats(phi, mov, tile)

        def plain():
            return bsi_fused.plain_stats(phi, mov, tile)

    def calls():
        for _ in range(reps):
            call()
        torch.cuda.synchronize()

    ms = cuda_ms(call, reps)
    prof, _ = traced(calls)
    by_name = device_ms_by_name(prof)
    kernel_ms = sum(t for k, t in by_name.items() if "bsi_fused" in k) / reps
    reduce_ms = sum(t for k, t in by_name.items() if "reduce_partials" in k) / reps
    a, b, ref = (v.reshape(-1) for v in (call(), call(), plain()))
    rel = abs(a[0].item() - ref[0].item()) / abs(ref[0].item())
    return dict(ms=ms, kernel_ms=kernel_ms, reduce_ms=reduce_ms, rel_err=rel,
                exact=bool(torch.equal(a[1:], ref[1:])), bit_equal=bool(torch.equal(a, b)),
                value=a.tolist(), plain=ref.tolist(), plain_ms=cuda_ms(plain, reps=3))


def occupancy(lib, name, tile, vol) -> dict:
    """The kernel's ptxas line, its shared memory a block (dynamic and
    static), resident blocks an SM and grid."""
    symbol, smem, grid = bsi_fused.occupancy_key(KERNELS[name], tile, vol)
    line = [ln for ln in lib.info.ptxas if symbol in ln and "registers" in ln]
    static = int(re.search(r"(\d+) B static smem", line[0]).group(1)) if line else 0
    return kernel_occupancy(lib, symbol, smem + static, grid)


def fused_split(phi, mov, fix, rem, tile, names, reps=20) -> dict:
    """Milliseconds a call of each kernel of ``names`` as built (``full``)
    and in each measurement build of :data:`SKIPS` (all built in parallel),
    timed in turns, twice: ``{kernel: {label: [ms, ms]}}``."""
    with ThreadPoolExecutor(len(SKIPS)) as pool:
        built = list(pool.map(lambda d: load_library((d,)), SKIPS.values()))
    libs = {"full": load_library(), **dict(zip(SKIPS, built))}
    args = {"bsi_fused": (mov, fix), "bsi_fused_stats": (rem, None)}
    split = {n: {k: [] for k in libs} for n in names}
    for _ in range(2):
        for n in names:
            for k, lib in libs.items():
                split[n][k].append(cuda_ms(
                    lambda: _launch(KERNELS[n], phi, *args[n], tile, lib), reps))
    return split


def _sass_functions(path, parts) -> dict:
    """``{function: its SASS}`` of the functions in the library at ``path``
    whose mangled name holds one of ``parts``, instruction addresses left
    out."""
    cuobjdump = str(Path(nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1) if any(p in m.group(1) for p in parts) else None
            if fn:
                out[fn] = []
        elif fn:
            out[fn].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip())
    return {k: "\n".join(v) for k, v in out.items()}


def sass_compare(path, other, parts=SASS_SAME) -> dict:
    """``{part: [functions, functions whose SASS is the same in both]}``
    for each of ``parts``, between the libraries at ``path`` and ``other``;
    a function missing from ``other`` counts as different."""
    mine, theirs = _sass_functions(path, parts), _sass_functions(other, parts)
    return {p: [sum(p in f for f in mine),
                sum(p in f and theirs.get(f) == s for f, s in mine.items())]
            for p in parts}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, default=PAPER_VOLUMES["phantom1"])
    ap.add_argument("--tile", type=int, nargs=3, default=(5, 5, 5))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", nargs="+", choices=tuple(KERNELS), default=list(KERNELS))
    ap.add_argument("--split", action="store_true",
                    help="time each kernel with a part left out")
    ap.add_argument("--sass-against", metavar="LIB",
                    help="compare the SASS of the kernels of SASS_SAME with LIB's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_fused: needs a CUDA device")

    vol, tile = tuple(args.shape), tuple(args.tile)
    lib = load_library()
    phi, mov, fix, rem = inputs(vol, tile)
    card = card_name()
    print(f"card: {card}; volume {vol}, tile {tile}, grid {tuple(phi.shape[:3])}; "
          f"kernel build {lib.info.seconds:.2f} s ({lib.info.path})")
    sums = {k: cuda_ms(lambda: v.sum(), args.reps)
            for k, v in (("moving", mov), ("fixed", fix))}
    print(f"read floor: one sum of the moving volume {sums['moving']:.4f} ms, of the "
          f"fixed volume {sums['fixed']:.4f} ms")
    result = {"card": card, "shape": list(vol), "tile": list(tile),
              "library": str(lib.info.path), "build_seconds": lib.info.seconds,
              "sum_ms": sums}
    for name in args.kernels:
        m, f = (mov, fix) if name == "bsi_fused" else (rem, None)
        rep = fused_report(name, phi, m, f, tile, args.reps)
        rep.update(occupancy(lib, name, tile, vol))
        rep["clock"] = sm_clock_under_load(
            lambda: _launch(KERNELS[name], phi, m, f, tile, lib))
        print(f"{name}: {rep['ms']:.4f} ms a call (device: kernel {rep['kernel_ms']:.4f} "
              f"ms, reduce {rep['reduce_ms']:.4f} ms; plain {rep['plain_ms']:.3f} ms); "
              f"{rep['value']} against plain {rep['plain']}, relative "
              f"{rep['rel_err']:.3e}; min, max, count exact: {rep['exact']}; two calls "
              f"bit-equal: {rep['bit_equal']}; {rep['registers']}; {rep['smem']} B of "
              f"shared memory a block, {rep['blocks_per_sm']} blocks an SM, grid "
              f"{rep['grid']}; under load: {rep['clock']} (SM clock, its maximum, power)")
        result[name] = rep
    if args.split:
        result["split"] = fused_split(phi, mov, fix, rem, tile, args.kernels, args.reps)
        for name, split in result["split"].items():
            for k, ms in split.items():
                print(f"  {name} {k}: {', '.join(f'{t:.4f}' for t in ms)} ms")
    if args.sass_against:
        result["sass_same"] = sass_compare(lib.info.path, args.sass_against)
        for part, (n, same) in result["sass_same"].items():
            print(f"SASS of {part}: {same} of {n} functions identical to {args.sass_against}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
