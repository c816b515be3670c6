"""Where the time of the fused moment kernels goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_fused [--shape X Y Z]
        [--tile D D D] [--reps N] [--kernels NAME ...] [--split]
        [--sass-against LIB]

Builds the kernels, makes ``make_pair(shape, seed=0)`` (default: the paper's
phantom1, 512 x 228 x 385) and the control grid of ``chip_smoke.py``'s phase
3 (seed 0, scaled by 2.5 and then by 0.4, the level's own scale), and
reports the fused ssd, stats and ncc kernels in both displacement forms
(:data:`KERNELS`) through their dispatchers, as ``chip_smoke.py`` runs them:
``ops.fused_ssd_loss`` on the pair, ``ops.fused_stats`` on the moving volume
remapped by ``(1 - v)^1.5`` and ``ops.fused_ncc_moments`` on the remapped
pair, centred by the plain stats' mean and the fixed volume's
(:func:`fused_report`): milliseconds a call by CUDA events, the device
milliseconds a call of the fused kernel and of the lane-wise reduce after it
(``torch.profiler``), the difference of the sums from the plain version
relative to it (for stats also whether min, max and count equal the plain
version's), whether two calls are bit-equal, the kernel's registers, shared
memory, resident blocks an SM and grid (``kernels.bsi_fused.occupancy_key``),
and the SM clock under load.  Beside them, a ``sum`` of each volume: the
card's own time to read those bytes.  ``--split`` also times each kernel
with a part left out (:func:`fused_split`: measurement builds,
``-DREPRO_FUSED_SKIP``).  ``--sass-against LIB`` compares the SASS
(``cuobjdump -sass``) of this build's kernels of :data:`SASS_SAME` with that
of the library at ``LIB`` (another build of the kernels, as the parent
commit's), function by function.  The last line is one JSON object with the
numbers.  Needs a CUDA device; there is no CPU path.  To time another
commit's kernels beside these, run that commit's own copy of the script
from its tree, in turns with this one.
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
from repro_torch.kernels import bsi_fused, bsi_ttli, ops
from repro_torch.kernels.build import load_library, nvcc_path
from repro_torch.launch.profile_adjoint import cuda_ms
from repro_torch.launch.profile_forward import kernel_occupancy, sm_clock_under_load

__all__ = ["KERNELS", "SASS_SAME", "SKIPS", "fused_report", "fused_split", "inputs",
           "sass_compare"]

# launch-count name -> (moment, displacement form)
KERNELS = {"bsi_fused": ("ssd", "lerp"), "bsi_fused_stats": ("stats", "lerp"),
           "bsi_fused_ncc": ("ncc", "lerp"), "bsi_fused_matmul": ("ssd", "matmul"),
           "bsi_fused_stats_matmul": ("stats", "matmul"),
           "bsi_fused_ncc_matmul": ("ncc", "matmul")}
# the leading lanes of each moment's row that are sums (the rest of stats'
# row, min, max and count, is exact)
SUM_LANES = {"ssd": 1, "stats": 1, "ncc": 3}
# the parts left out in the measurement builds (csrc/bsi_fused.cu:
# REPRO_FUSED_SKIP): 1 the staging (the x-y stage; the matrix form's basis
# and control window), 2 the displacement (each voxel sampled at identity),
# 4 the gathers (the sample is the sum of the voxel's coordinates: the
# displacement stays, the moving volume is not read); 7 all three; 8 all but
# the reduction (each thread's sums a constant); the matrix form's 64-term
# sum with 16 its basis weights as constants (no basis loads), 32 its
# window values as constants (no window loads)
SKIPS = {"no staging": "REPRO_FUSED_SKIP=1", "identity sample": "REPRO_FUSED_SKIP=2",
         "no gathers": "REPRO_FUSED_SKIP=4", "floor": "REPRO_FUSED_SKIP=7",
         "reduction alone": "REPRO_FUSED_SKIP=8",
         "no basis loads": "REPRO_FUSED_SKIP=16", "no window loads": "REPRO_FUSED_SKIP=32"}
MATMUL_ONLY = ("no basis loads", "no window loads")
# the kernels --sass-against compares: the fused kernels the walk does not
# carry, the lane-wise reduce and the staged forward kernels
SASS_SAME = ("bsi_fused_nmi_kernel", "bsi_fused_lncc_kernel", "reduce_partials_kernel",
             "bsi_ttli_kernel", "bsi_separable_kernel")


def inputs(shape, tile):
    """``(phi, moving, fixed, remapped)`` on the card, as ``chip_smoke.py``'s
    phase 3 makes them."""
    fixed, moving, _ = make_pair(shape, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    phi = torch.randn(ffd.grid_shape_for_volume(shape, tile) + (3,), generator=gen,
                      device="cuda") * 2.5
    return phi * 0.4, moving, fixed, (1.0 - moving) ** 1.5


def _calls(name, phi, mov, fix, rem, tile, lib=None):
    """``(call, plain)``: kernel ``name`` on its inputs, through its
    dispatcher (``lib`` None) or launched from ``lib`` (a measurement build)
    on the dispatcher's blocks, and its plain version on the same."""
    kind, form = KERNELS[name]
    kw = dict(disp_form=form)
    scal = None
    if kind == "ssd":
        vols = (mov, fix)
        call = lambda: ops.fused_ssd_loss(phi, mov, fix, tile, **kw)
        plain = lambda: bsi_fused.plain(phi, mov, fix, tile, **kw) / mov.numel()
    elif kind == "stats":
        vols = (rem, None)
        call = lambda: ops.fused_stats(phi, rem, tile, **kw)
        plain = lambda: bsi_fused.plain_stats(phi, rem, tile, **kw)
    else:
        st = bsi_fused.plain_stats(phi, rem, tile, **kw)
        vols, scal = (rem, fix), torch.stack([st[0] / rem.numel(), fix.mean()])
        call = lambda: ops.fused_ncc_moments(phi, rem, fix, scal, tile, **kw)
        plain = lambda: bsi_fused.plain_ncc(phi, rem, fix, scal, tile, **kw)
    if lib is not None:
        blocks = bsi_fused.moment_blocks(tile, tuple(mov.shape), form).tiles
        call = lambda: bsi_fused.launch(kind, phi, *vols, tile, blocks, scal=scal, lib=lib,
                                        **kw)
    return call, plain


def fused_report(name, call, plain, reps=20) -> dict:
    """Kernel ``name`` by ``call``, its dispatcher, on the card: ``ms`` (CUDA
    events), ``kernel_ms`` and ``reduce_ms`` (device time a call of the
    fused kernel and of the reduce, from ``reps`` traced calls),
    ``rel_err`` (of the sums against ``plain``, relative to its largest),
    ``exact`` (the lanes that are not sums equal plain's), ``bit_equal``
    (two calls) and ``plain_ms``."""
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
    n = SUM_LANES[KERNELS[name][0]]
    rel = ((a[:n] - ref[:n]).abs().max() / ref[:n].abs().max()).item()
    return dict(ms=ms, kernel_ms=kernel_ms, reduce_ms=reduce_ms, rel_err=rel,
                exact=bool(torch.equal(a[n:], ref[n:])), bit_equal=bool(torch.equal(a, b)),
                value=a.tolist(), plain=ref.tolist(), plain_ms=cuda_ms(plain, reps=3))


def occupancy(lib, name, tile, vol) -> dict:
    """The kernel's ptxas line, its shared memory a block (dynamic and
    static), resident blocks an SM and grid; ``name`` a key of
    :data:`KERNELS`, or one with ``_bf16`` or ``_f16`` appended (the bf16 or
    fp16 kernel, ``bsi_fused_stats_bf16``, ``bsi_fused_ncc_matmul_f16``)."""
    dtype = next((dt for dt, sx in bsi_ttli.ENTRY_SUFFIX.items()
                  if dt != torch.float32 and name.endswith(f"_{sx}")), torch.float32)
    if dtype != torch.float32:
        name = name.removesuffix(f"_{bsi_ttli.ENTRY_SUFFIX[dtype]}")
    kind, form = KERNELS[name]
    symbol, smem, grid = bsi_fused.occupancy_key(kind, form, tile, vol, dtype=dtype)
    line = [ln for ln in lib.info.ptxas if symbol in ln and "registers" in ln]
    static = int(re.search(r"(\d+) B static smem", line[0]).group(1)) if line else 0
    return kernel_occupancy(lib, symbol, smem + static, grid)


def fused_split(tensors, tile, names, reps=20) -> dict:
    """Milliseconds a call of each kernel of ``names`` on ``tensors`` (those of
    :func:`inputs`), launched from the library as built (``full``) and from
    each measurement build of :data:`SKIPS` (all built in parallel; the matrix
    form's parts for its kernels only), timed in turns, twice:
    ``{kernel: {label: [ms, ms]}}``."""
    with ThreadPoolExecutor(len(SKIPS)) as pool:
        built = list(pool.map(lambda d: load_library((d,)), SKIPS.values()))
    libs = {"full": load_library(), **dict(zip(SKIPS, built))}
    calls = {n: {k: _calls(n, *tensors, tile, lib)[0] for k, lib in libs.items()
                 if KERNELS[n][1] == "matmul" or k not in MATMUL_ONLY} for n in names}
    split = {n: {k: [] for k in calls[n]} for n in names}
    for _ in range(2):
        for n in names:
            for k, call in calls[n].items():
                split[n][k].append(cuda_ms(call, reps))
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
        call, plain = _calls(name, phi, mov, fix, rem, tile)
        rep = fused_report(name, call, plain, args.reps)
        rep.update(occupancy(lib, name, tile, vol))
        rep["clock"] = sm_clock_under_load(call)
        occ = (f"{rep['registers']}; {rep['smem']} B of shared memory a block, "
               f"{rep['blocks_per_sm']} blocks an SM, grid {rep['grid']}; ")
        print(f"{name}: {rep['ms']:.4f} ms a call (device: kernel {rep['kernel_ms']:.4f} "
              f"ms, reduce {rep['reduce_ms']:.4f} ms; plain {rep['plain_ms']:.3f} ms); "
              f"{rep['value']} against plain {rep['plain']}, sums relative "
              f"{rep['rel_err']:.3e}; other lanes exact: {rep['exact']}; two calls "
              f"bit-equal: {rep['bit_equal']}; {occ}under load: {rep['clock']} (SM "
              "clock, its maximum, power)")
        result[name] = rep
    if args.split:
        result["split"] = fused_split((phi, mov, fix, rem), tile, args.kernels, args.reps)
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
