#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and hold every
kernel against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases; any failure raises and the script exits nonzero:

1. the card's name and power limit (nvidia-smi) and the device count;
2. build the kernels from ``src/repro_torch/csrc`` with nvcc (build seconds,
   registers and spills from ``-Xptxas -v``; the bf16 flash kernel's HGMMA
   instructions from ``cuobjdump -sass``, asserted, and no spills; the
   float32 flash kernel's HMMA instructions, asserted);
3. each kernel at the shapes of the paper's phantom1 volume (512, 228, 385),
   tile 5^3, 3 channels (the four forward kernels cropped to the volume):
   compared with its plain version, and timed with CUDA
   events beside the plain version, its byte/operation bound and, where one
   PyTorch call computes the same function, that call.  The stats, ncc and
   nmi kernels run on the multi-modal pair of phase 4; every fused variant
   runs in both displacement forms (the matrix form's rows end ``_matmul``;
   the fused LNCC's beside the halo-cube kernel it replaced).  The nmi
   kernel's rows are bound by the least form of their function
   (``launch/bounds.py:nmi_bound``: the histogram as one dense TF32 product
   or as the products of the non-zero weights this run's data has, the
   Parzen weights at the bins the kernel evaluates); its three TF32
   products and the fp32-pipe bound of every bin are printed beside.  Each
   form prints its split, its time with the weights or the histogram stage
   left out (two measurement builds, ``-DREPRO_NMI_STAGES``), its resident
   blocks an SM, registers and HMMA instructions (``cuobjdump -sass``,
   asserted).  The ``bsi_ttli``, ``bsi_separable`` and ``bsi_tt`` rows
   print their registers (no spills, asserted), shared memory, resident
   blocks an SM and grid (``kernels.bsi_ttli.forward_blocks``,
   ``kernels.bsi_tt.tt_blocks``; their split is
   ``launch/profile_forward.py``'s); ``bsi_tt`` is asserted equal to its
   plain version bit for bit, and two calls equal, at phantom1 and at the
   main path's coarse level.  The separable adjoint's row prints
   its two launches' device times (the streaming z-y kernel, the x sweep),
   each kernel's registers (no spills, asserted) and blocks an SM, the
   streaming block's shared memory and geometry
   (``kernels.bsi_adjoint.stream_blocks``) and the device memory one call
   allocates beyond its output (asserted at most 32 MB), and asserts two
   calls bit-equal (``launch/profile_adjoint.py`` has its split); the
   kernel is also held to its plain version at the main path's coarse
   level, where its geometry splits each x plane into runs of y tiles.  The
   matmul adjoint's row prints its two launches' device times (box
   contraction, seam sum), its box kernel's registers (no spills, asserted)
   and blocks an SM, and the device memory one call allocates beyond its
   output (asserted at most 64 MB), and asserts two calls bit-equal.  The
   ``bsi_matmul`` row (the tensor-core kernel, 3xTF32) is held to its plain
   version at 1e-5 at phantom1 and at the main path's coarse level, two
   calls bit-equal (asserted), and prints both its and plain's largest
   error against the float64 function, its registers (no spills,
   asserted), shared memory, blocks an SM and grid, and the time of its
   three TF32 products at 495 TFLOP/s.  The ``bsi_fused``,
   ``bsi_fused_stats`` and ``bsi_fused_ncc`` rows, in both forms (the
   column walks on the forward kernels' blocks,
   ``kernels.bsi_fused.moment_blocks``), are held to their plain versions
   (the sums at 1e-5 relative, stats' min, max and count exact), print
   their registers (no spills, asserted), shared memory, blocks an SM and
   grid, and assert two calls bit-equal (``launch/profile_fused.py`` has
   their split);
4. the paths, each with the launch counts set to 0 just before and read just
   after: ``ffd_register`` with the default options and ``fused="on"`` (the
   fused SSD, TTLI and adjoint kernels) on ``make_pair(phantom1, seed=0)``; the same pair at
   ``iters=5`` on the kernels and on the plain path, whose per-level losses
   must agree to 1e-4, and a small pair on the card against the CPU.  Then
   the multi-modal path: the moving volume remapped by ``(1 - v)^1.5`` and
   registered with ``similarity="nmi"`` (the stats, nmi, TTLI and adjoint
   kernels), scored by the MAE of the original moving volume warped by the
   recovered field, beside an SSD run on the same pair, and what
   ``fused="auto"`` resolves to for ``RegistrationOptions(similarity="nmi")``
   (its race, once, on a fresh temporary disk cache); the NCC and NMI
   paths at ``iters=5`` on the kernels and on the plain path; and a small
   remapped pair with NMI on the card against the CPU.  Then the LNCC path
   in the matrix form, ``RegistrationOptions(similarity="lncc",
   mode="matmul", grad_impl="matmul")`` (the fused LNCC, matmul and
   matmul-adjoint kernels), cold and warm, with its peak memory, per-level
   losses, MAE and launch counts, against the plain path at full depth,
   what ``fused="auto"`` resolves to for its options (the race's two
   timings, on a fresh temporary disk cache), and beside the same call at a
   quarter and a half of phantom1's extent (see
   ``run_lncc_path``); at ``iters=5`` on the kernels and on the
   plain path: LNCC in the lerp and matrix forms, SSD, NCC and NMI in the
   matrix form; and the LNCC matrix form on a small pair, card against CPU.
   Then the separable and TT forward kernels' paths, ``mode="separable"``
   and ``mode="tt"`` (each kernel with the adjoint and fused SSD kernels),
   at full depth with their launch counts, and at ``iters=5`` against the
   plain path.  Last, the JAX package's default call: all-``"auto"``
   options, resolved first by the autotuner's race (every candidate's
   median printed, all 12 kernel triples timed) with the disk cache in a
   fresh temporary file, then run at full depth with the winner's launch
   counts, then resolved again from the disk file with no race; and what
   the default options (``fused="auto"``) resolve to, with the race's
   seconds.  Every run above that counts the fused kernels passes
   ``fused="on"``;
5. the flash-attention kernels at gemma2-2b's layer (batch 4, 8160 tokens, 8
   query and 4 key/value heads, head dim 256, softcap 50), global and local
   (window 4096) in bf16 (wgmma) and global in float32 (mma.sync, 3xTF32),
   against their plain version and timed beside it and the bound; the
   global layer with softcap 0 too in both, beside
   ``scaled_dot_product_attention`` (float32 on a pinned backend, named,
   held to the kernel at 2e-5), and those cases are the kernels line's two
   rows.  bf16 is held to ``plain`` at one bf16 step + ``2^-8 max|v|`` and,
   on exact-score inputs, to its rounding twin at one step; float32 at 2e-5,
   two calls bit-equal (``check_flash``);
6. the serving path: ``generate`` of gemma2-2b at full width and depth,
   batch 4, 8160-token prompts, 32 greedy tokens, bf16, cold and warm, with
   its launch counts (26 ``flash_attention``, no other kernel); then, at
   batch 1, the kernel path against the plain path (prefill and 4 decode
   steps fed the prompt's next tokens): in float32, logits within 1e-4 of
   the largest and the greedy picks equal; in bf16, logits within twice the
   bf16 plain path's gap to the float32 plain logits (``compare_serve_paths``);
7. one JSON line of the kernels (the float32 flash row's launches are the
   float32 serving path's of phase 6), the nvidia-smi line, and the result
   line.

Float32 convolutions and matrix products are pinned to full fp32
(``allow_tf32 = False``) so the library yardsticks compute in fp32 too.
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TILE = (5, 5, 5)
REPS = 20


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def only(**counts):
    """Expected launch counts: ``counts``, and 0 for every other kernel."""
    from repro_torch.kernels import ops

    return {k: counts.get(k, 0) for k in ops.launch_counts()}


def cuda_ms(torch, fn, reps=REPS, warmup=2):
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


def conv_kernel(torch, tile, channels, device):
    """``K[a + (3-l)d]`` = LUT ``W[a, l]`` per axis, the outer product of the
    three axes, one filter per channel: BSI as a strided transposed conv."""
    from repro_torch.core.bspline import weight_lut

    axes = []
    for d in tile:
        w = weight_lut(d, torch.float32, device)  # (d, 4)
        k = torch.zeros(4 * d, dtype=torch.float32, device=device)
        for l in range(4):
            k[(3 - l) * d:(4 - l) * d] = w[:, l]
        axes.append(k)
    k3 = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    return k3.expand(channels, 1, *k3.shape).contiguous()


def yardsticks(torch, phi, g, tile):
    """The library calls that compute the forward BSI of ``phi`` (cropped to
    ``g``'s volume) and the adjoint of ``g``: a strided transposed conv and a
    strided conv, fp32, channels first; each returns channels last."""
    import torch.nn.functional as F

    X, Y, Z, c = g.shape
    (tx, ty, tz), (dx, dy, dz) = (n - 3 for n in phi.shape[:3]), tile
    K = conv_kernel(torch, tile, c, phi.device)
    phi_cf = phi.permute(3, 0, 1, 2).unsqueeze(0).contiguous()
    g_cf = torch.zeros((1, c, tx * dx, ty * dy, tz * dz), device=g.device)
    g_cf[0, :, :X, :Y, :Z] = g.permute(3, 0, 1, 2)

    def forward():
        full = F.conv_transpose3d(phi_cf, K, stride=tile, groups=c)
        return full[0, :, 3 * dx:3 * dx + X, 3 * dy:3 * dy + Y, 3 * dz:3 * dz + Z]

    def adjoint():
        return F.conv3d(g_cf, K, stride=tile, padding=tuple(3 * d for d in tile),
                        groups=c)

    return (lambda: forward().permute(1, 2, 3, 0)), (lambda: adjoint()[0].permute(
        1, 2, 3, 0))


def remap(v):
    """Monotone-decreasing intensity remap: a synthetic second modality."""
    return (1.0 - v) ** 1.5


def plain_passes():
    from repro_torch.kernels import bsi_fused

    return dict(stats=bsi_fused.plain_stats, ncc_moments=bsi_fused.plain_ncc,
                nmi_histogram=bsi_fused.plain_nmi)


# the nmi kernel's stages left out in its measurement builds (csrc:
# REPRO_NMI_STAGES; bit 0 the weights, bit 1 the histogram)
NMI_STAGES = {"weights only": "REPRO_NMI_STAGES=1", "histogram only": "REPRO_NMI_STAGES=2"}


def nmi_stage_builds():
    """The kernels built once for each entry of ``NMI_STAGES``, the builds
    in parallel: ``{label: Library}``."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.build import load_library

    with ThreadPoolExecutor(len(NMI_STAGES)) as pool:
        libs = pool.map(lambda d: load_library((d,)), NMI_STAGES.values())
        return dict(zip(NMI_STAGES, libs))


def nmi_work(torch, phi, moving, fixed, scal, bins, sigma, form, chunk=1 << 22):
    """What this run's data makes the nmi kernel's function need: the
    Parzen weights the kernel evaluates (those within ``nmi_support`` of
    the nearest centre, over both volumes) and the voxels' products of
    non-zero weights (``parzen_weights``, the plain version's weights)."""
    from repro_torch.core.similarity import parzen_centres, parzen_weights
    from repro_torch.kernels import bsi_fused

    support = bsi_fused.nmi_support(bins, sigma * (bins - 1))
    centres = parzen_centres(bins, fixed.device)
    s = fixed.new_full((), sigma)
    evaluated = products = 0
    with torch.no_grad():
        w = bsi_fused.warped(phi, moving, TILE, form).reshape(-1)
        f = fixed.reshape(-1)
        for i in range(0, w.numel(), chunk):
            nonzero = 1
            for v, lo, hi in ((w[i:i + chunk], scal[0], scal[1]),
                              (f[i:i + chunk], scal[2], scal[3])):
                x = (v - lo) / torch.clamp(hi - lo, min=1e-8)
                k_lo, k_hi = bsi_fused.nmi_support_range(x, bins, support)
                evaluated += int((k_hi - k_lo + 1).sum())
                nonzero = nonzero * (parzen_weights(x, centres, s, 1e-8) != 0).sum(1)
            products += int(nonzero.sum())
    return support, evaluated, products


def nmi_report(torch, lib, stage_libs, phi, moving, fixed, scal, bins, sigma, eps, form):
    """The nmi kernel in ``form`` at this run's inputs: its time in full and
    with a stage left out (the split), resident blocks an SM, registers and
    HMMA instructions (asserted: the histogram runs on the tensor cores);
    the work this run's data needs and the bound it gives.  Returns
    ``(bound_ms, bound_by, summary)``."""
    from repro_torch.device import resident_blocks
    from repro_torch.kernels import bsi_fused
    from repro_torch.kernels.build import sass_counts
    from repro_torch.launch.bounds import bound_ms, kernel_bounds, nmi_bound

    vol = tuple(fixed.shape)
    name = "bsi_fused_nmi" + ("_matmul" if form == "matmul" else "")
    blocks = bsi_fused.block_tiles(TILE, form, bsi_fused.nmi_smem_bytes(bins))
    kw = dict(disp_form=form, scal=scal, bins=bins, sigma=sigma, eps=eps)
    split = {"full": cuda_ms(torch, lambda: bsi_fused.launch(
        "nmi", phi, moving, fixed, TILE, blocks, **kw))}
    for label, stage_lib in stage_libs.items():
        split[label] = cuda_ms(torch, lambda: bsi_fused.launch(
            "nmi", phi, moving, fixed, TILE, blocks, lib=stage_lib, **kw))
    weights = split["full"] - split["histogram only"]
    histogram = split["full"] - split["weights only"]
    rest = split["full"] - weights - histogram

    tag = f"ILi{bsi_fused.DISP_FORMS.index(form)}ELi{bsi_fused.nmi_padded_bins(bins)}E"
    regs = [ln for ln in lib.info.ptxas if "bsi_fused_nmi_kernel" in ln and tag in ln]
    assert len(regs) == 1 and "0/0 B spill" in regs[0], regs
    smem = bsi_fused._disp_smem_bytes(TILE, blocks, form) + bsi_fused.nmi_smem_bytes(bins)
    per_sm = resident_blocks(int(re.search(r"(\d+) registers", regs[0]).group(1)), smem,
                             256)
    hmma = {fn: n for fn, n in sass_counts(lib.info.path, "bsi_fused_nmi_kernel",
                                           "HMMA").items() if tag in fn}
    assert len(hmma) == 1 and all(hmma.values()), hmma

    support, evaluated, products = nmi_work(torch, phi, moving, fixed, scal, bins, sigma,
                                            form)
    nb = nmi_bound(vol, TILE, bins, evaluated=evaluated, products=products)
    old_ms, old_by = bound_ms(*kernel_bounds(vol, TILE, 3, bins)[name])
    n = moving.numel()
    log(f"{name}: {split['full']:.4f} ms; a stage left out: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in split.items() if k != "full")
        + f" -> the weights stage ~{weights:.4f} ms, the histogram ~{histogram:.4f} ms, "
        f"the rest ~{rest:.4f} ms; {per_sm} blocks an SM of tiles {blocks} ({smem} B of "
        f"shared memory); {regs}; HMMA {list(hmma.values())}; support +-{support} bins, "
        f"{evaluated} weights evaluated ({evaluated / (2 * n):.3f} a voxel and volume of "
        f"{bins}), {products} products of non-zero weights ({products / n:.2f} a voxel); "
        f"bound {nb['ms']:.4f} ms ({nb['by']}, {nb['form']}; " + ", ".join(
            f"{k} {ms:.4f} ms" for k, (ms, _) in nb["forms"].items())
        + f"); the kernel's three TF32 products {nb['work_tf32_ms']:.4f} ms; the fp32-pipe "
        f"bound of every bin {old_ms:.4f} ms ({old_by})")
    return nb["ms"], nb["by"], dict(
        split=split, weights_ms=weights, histogram_ms=histogram, rest_ms=rest,
        blocks_per_sm=per_sm, registers=regs, hmma=list(hmma.values()),
        evaluated=evaluated, products=products, bound_ms=nb["ms"], bound_form=nb["form"],
        forms_ms={k: ms for k, (ms, _) in nb["forms"].items()},
        work_tf32_ms=nb["work_tf32_ms"], fp32_pipe_bound_ms=old_ms)


# the device memory one matmul-adjoint call may allocate beyond its output at
# phantom1: its partials (the band sums of an earlier design took 280 MB)
ADJOINT_EXTRA_BYTES = 64e6


def adjoint_matmul_summary(lib, g, gshape):
    """The matmul adjoint at this run's inputs: its time and each launch's
    device time (``launch/profile_adjoint.py``), its box kernel's registers
    (asserted: no spills) and resident blocks an SM, and the device memory
    one call allocates beyond its output (asserted at most 64 MB); two calls
    asserted bit-equal."""
    from repro_torch.device import resident_blocks
    from repro_torch.kernels import bsi_adjoint
    from repro_torch.launch.profile_adjoint import adjoint_report

    geo = bsi_adjoint.matmul_blocks(TILE, g.shape[3], tuple(g.shape[:3]))
    rep = adjoint_report("matmul", g, TILE, gshape)
    regs = [ln for ln in lib.info.ptxas
            if "adjoint_matmul_box_kernel" in ln and f"ILi{geo.cols}E" in ln]
    assert len(regs) == 1 and "0/0 B spill" in regs[0], regs
    per_sm = resident_blocks(int(re.search(r"(\d+) registers", regs[0]).group(1)),
                             geo.smem, 2 * geo.cols)
    log(f"bsi_adjoint_matmul: {rep['ms']:.4f} ms; launches " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in rep["stages"].items())
        + f"; {math.prod(geo.boxes)} boxes of {geo.box} tiles, {2 * geo.cols} threads and "
        f"{geo.smem} B of shared memory a block, {per_sm} blocks an SM; {regs[0]}; "
        f"{rep['extra_bytes'] / 1e6:.1f} MB beyond the output (the partials "
        f"{4 * geo.partial_floats / 1e6:.1f} MB; limit {ADJOINT_EXTRA_BYTES / 1e6:.0f} "
        f"MB); two calls bit-equal: {rep['bit_equal']}")
    assert rep["bit_equal"], rep
    assert rep["extra_bytes"] <= ADJOINT_EXTRA_BYTES, rep
    return dict(rep, box=geo.box, boxes=geo.boxes, blocks_per_sm=per_sm,
                registers=regs[0])


# the device memory one separable-adjoint call may allocate beyond its
# output at phantom1: the runs' partials of hy, 24 MB (an earlier design's
# intermediates took 136 MB)
SEPARABLE_EXTRA_BYTES = 32e6


def adjoint_separable_summary(lib, g, gshape):
    """The separable adjoint at this run's inputs: each launch's device time
    (``launch/profile_adjoint.py``), each kernel's registers (asserted: no
    spills), the streaming kernel's shared memory and geometry
    (``kernels.bsi_adjoint.stream_blocks``), blocks an SM, and the device
    memory one call allocates beyond its output (asserted at most 32 MB);
    two calls asserted bit-equal."""
    from repro_torch.kernels import bsi_adjoint
    from repro_torch.launch.profile_adjoint import adjoint_report, kernel_occupancy

    vol = tuple(g.shape[:3])
    geo = bsi_adjoint.stream_blocks(TILE, g.shape[3], vol, bsi_adjoint.card_sms(g.device))
    rep = adjoint_report("separable", g, TILE, gshape)
    occ = kernel_occupancy(lib, TILE, g.shape[3], vol)
    log(f"bsi_adjoint: {rep['ms']:.4f} ms; launches " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in rep["stages"].items())
        + f"; {geo.zparts * geo.runs * vol[0]} blocks of {geo.threads} threads ({geo.runs} "
        f"runs of {geo.run} y tiles, {geo.zparts} z parts), {geo.smem} B of shared memory a "
        f"streaming block; " + "; ".join(f"{line}, {per_sm} blocks an SM"
                                          for line, per_sm in occ.values())
        + f"; {rep['extra_bytes'] / 1e6:.1f} MB beyond the output (the partials "
        f"{4 * geo.partial_floats / 1e6:.1f} MB; limit {SEPARABLE_EXTRA_BYTES / 1e6:.0f} MB); "
        f"two calls bit-equal: {rep['bit_equal']}")
    assert rep["bit_equal"], rep
    assert rep["extra_bytes"] <= SEPARABLE_EXTRA_BYTES, rep


def check_matmul_forward(torch, phi, vol):
    """``bsi_matmul`` at ``vol``: within 1e-5 of its plain version and two
    calls bit-equal (asserted); its largest error and plain's against the
    float64 function (``bsi_matmul.exact``), logged.  Returns the error
    against plain and ``{kernel_f64, plain_f64}``."""
    from repro_torch.kernels import bsi_matmul, ops

    out = ops.bsi_matmul(phi, TILE, vol)
    ref = bsi_matmul.plain(phi, TILE, vol)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    equal = torch.equal(out, ops.bsi_matmul(phi, TILE, vol))
    exact = bsi_matmul.exact(phi, TILE, vol)
    f64 = dict(kernel_f64=(out.double() - exact).abs().max().item(),
               plain_f64=(ref.double() - exact).abs().max().item())
    log(f"bsi_matmul at {vol}: max |kernel - plain| = {err:.3e} (limit 1e-5); two "
        f"calls bit-equal: {equal}; max |kernel - f64| {f64['kernel_f64']:.3e}, max "
        f"|plain - f64| {f64['plain_f64']:.3e}")
    assert math.isfinite(err) and err <= 1e-5, (vol, err)
    assert equal, vol
    return err, f64


def check_coarse_adjoint(torch, fixed):
    """The separable adjoint at the main path's coarse level (the pyramid's
    ``downsample2`` of phantom1), where its geometry splits each x plane
    into runs of y tiles (asserted) and the x sweep sums each seam's two
    partials: held to its plain version at 1e-5 of the largest value, two
    calls bit-equal."""
    from repro_torch.core import ffd
    from repro_torch.kernels import bsi_adjoint, ops

    dev = fixed.device
    vol = tuple(ffd.downsample2(fixed).shape)
    gshape = ffd.grid_shape_for_volume(vol, TILE)
    geo = bsi_adjoint.stream_blocks(TILE, 3, vol, bsi_adjoint.card_sms(dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn(vol + (3,), generator=gen, device=dev) * 1e-3
    out = ops.bsi_adjoint(g, TILE, gshape)
    ref = bsi_adjoint.plain(g, TILE, gshape)
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    equal = torch.equal(out, ops.bsi_adjoint(g, TILE, gshape))
    log(f"bsi_adjoint at the coarse level {vol}: {geo.runs} runs of {geo.run} y tiles a "
        f"plane; max |kernel - plain| relative {rel:.3e} (limit 1e-5); two calls "
        f"bit-equal: {equal}")
    assert geo.runs > 1, geo
    assert math.isfinite(rel) and rel <= 1e-5, rel
    assert equal


def check_kernels(torch, fixed, moving, lib, stage_libs):
    """Phase 3: every kernel against its plain version at phantom1 shapes;
    ``lib`` the kernels, ``stage_libs`` the nmi kernel's measurement builds."""
    from repro_torch.core import ffd
    from repro_torch.kernels import bsi_adjoint, bsi_fused, bsi_ttli, ops
    from repro_torch.launch.bounds import bound_ms, kernel_bounds

    dev = fixed.device
    vol = tuple(fixed.shape)
    gshape = ffd.grid_shape_for_volume(vol, TILE)
    gen = torch.Generator(device=dev).manual_seed(0)
    phi = torch.randn(gshape + (3,), generator=gen, device=dev) * 2.5
    g = torch.randn(vol + (3,), generator=gen, device=dev) * 1e-3
    library_fwd, library_adj = yardsticks(torch, phi, g, TILE)
    # bytes each input read once and each output written once, and the
    # operations of each algorithm, from this run's shapes
    bounds = {k: bound_ms(*v) for k, v in kernel_bounds(vol, TILE, 3).items()}
    rows = []

    # --- bsi_ttli
    out = ops.bsi_ttli(phi, TILE, vol)
    ref = bsi_ttli.plain(phi, TILE, vol)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    log(f"bsi_ttli: max |kernel - plain| = {err:.3e} (limit 1e-5)")
    assert math.isfinite(err) and err <= 1e-5, err
    lib_err = (library_fwd() - ref).abs().max().item()
    log(f"bsi_ttli: library yardstick (conv_transpose3d) max |diff| = {lib_err:.3e}")
    log_forward_occupancy(lib, "bsi_ttli", vol)
    b_ms, b_by = bounds["bsi_ttli"]
    rows.append(dict(
        name="bsi_ttli", route="cuda", source="src/repro_torch/csrc/bsi_ttli.cu",
        replaces="src/repro/kernels/bsi_ttli.py:72", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.bsi_ttli(phi, TILE, vol)),
        plain_ms=cuda_ms(torch, lambda: bsi_ttli.plain(phi, TILE, vol), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(torch, library_fwd)))

    # --- bsi_adjoint
    out = ops.bsi_adjoint(g, TILE, gshape)
    ref = bsi_adjoint.plain(g, TILE, gshape)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    log(f"bsi_adjoint: max |kernel - plain| = {err:.3e}, relative {rel:.3e} "
        "(limit 1e-5 relative)")
    assert math.isfinite(rel) and rel <= 1e-5, rel
    lib_err = (library_adj() - ref).abs().max().item()
    log(f"bsi_adjoint: library yardstick (conv3d) max |diff| = {lib_err:.3e}")
    check_coarse_adjoint(torch, fixed)
    adjoint_separable_summary(lib, g, gshape)
    b_ms, b_by = bounds["bsi_adjoint_separable"]
    rows.append(dict(
        name="bsi_adjoint", route="cuda", source="src/repro_torch/csrc/bsi_adjoint.cu",
        replaces="src/repro/kernels/bsi_adjoint.py:125", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.bsi_adjoint(g, TILE, gshape)),
        plain_ms=cuda_ms(torch, lambda: bsi_adjoint.plain(g, TILE, gshape), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(torch, library_adj)))

    # --- bsi_fused (ssd): the level's displacement is the pair's own scale
    phi_f = phi * 0.4
    out = ops.fused_ssd_loss(phi_f, moving, fixed, TILE)
    ref = bsi_fused.plain(phi_f, moving, fixed, TILE) / moving.numel()
    err = abs(out.item() - ref.item())
    rel = err / abs(ref.item())
    log(f"bsi_fused: kernel {out.item():.9g} plain {ref.item():.9g} relative "
        f"{rel:.3e} (limit 1e-5 relative)")
    assert math.isfinite(rel) and rel <= 1e-5, rel
    log_walk(torch, lib, "bsi_fused", lambda: ops.fused_ssd_loss(phi_f, moving, fixed, TILE),
             vol)
    b_ms, b_by = bounds["bsi_fused_ssd"]
    rows.append(dict(
        name="bsi_fused", route="cuda", source="src/repro_torch/csrc/bsi_fused.cu",
        replaces="src/repro/kernels/bsi_fused.py:291", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.fused_ssd_loss(phi_f, moving, fixed, TILE)),
        plain_ms=cuda_ms(torch, lambda: bsi_fused.plain(phi_f, moving, fixed, TILE),
                         reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    # --- the multi-modal pass kernels, on the remapped pair
    rem = remap(moving)
    n = rem.numel()
    out = ops.fused_stats(phi_f, rem, TILE)
    ref = bsi_fused.plain_stats(phi_f, rem, TILE)
    rel = abs(out[0].item() - ref[0].item()) / abs(ref[0].item())
    err = (out - ref).abs().max().item()
    log(f"bsi_fused_stats: kernel {out.tolist()} plain {ref.tolist()}; sum relative "
        f"{rel:.3e} (limit 1e-5); min, max, count exact: "
        f"{torch.equal(out[1:], ref[1:])}")
    assert torch.equal(out[1:], ref[1:]) and out[3].item() == n, (out, ref)
    assert math.isfinite(rel) and rel <= 1e-5, rel
    log_walk(torch, lib, "bsi_fused_stats", lambda: ops.fused_stats(phi_f, rem, TILE), vol)
    b_ms, b_by = bounds["bsi_fused_stats"]
    rows.append(dict(
        name="bsi_fused_stats", route="cuda", source="src/repro_torch/csrc/bsi_fused.cu",
        replaces="src/repro/kernels/bsi_fused.py:291", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.fused_stats(phi_f, rem, TILE)),
        plain_ms=cuda_ms(torch, lambda: bsi_fused.plain_stats(phi_f, rem, TILE), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))

    passes = plain_passes()

    def loss_check(name, spec):
        """The two-pass loss on the kernels against the same finish on the
        plain versions, 1e-5 relative."""
        out = ops.fused_similarity_loss(phi_f, rem, fixed, TILE, sim_spec=spec).item()
        ref = ops.two_pass_loss(spec, phi_f, rem, fixed, TILE, **passes).item()
        rel = abs(out - ref) / abs(ref)
        log(f"{name}: loss kernel {out:.9g} plain {ref:.9g} relative {rel:.3e} "
            "(limit 1e-5)")
        assert math.isfinite(rel) and rel <= 1e-5, rel
        return abs(out - ref)

    scal = torch.stack([ref[0] / n, fixed.mean()])
    out = ops.fused_ncc_moments(phi_f, rem, fixed, scal, TILE)
    mom = bsi_fused.plain_ncc(phi_f, rem, fixed, scal, TILE)
    rel = ((out - mom).abs().max() / mom.abs().max()).item()
    log(f"bsi_fused_ncc: moments kernel {out.tolist()} plain {mom.tolist()}; relative "
        f"{rel:.3e} (limit 1e-5)")
    assert math.isfinite(rel) and rel <= 1e-5, rel
    log_walk(torch, lib, "bsi_fused_ncc",
             lambda: ops.fused_ncc_moments(phi_f, rem, fixed, scal, TILE), vol)
    err = loss_check("bsi_fused_ncc", ("ncc",))
    b_ms, b_by = bounds["bsi_fused_ncc"]
    rows.append(dict(
        name="bsi_fused_ncc", route="cuda", source="src/repro_torch/csrc/bsi_fused.cu",
        replaces="src/repro/kernels/bsi_fused.py:291", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.fused_ncc_moments(phi_f, rem, fixed, scal, TILE)),
        plain_ms=cuda_ms(torch, lambda: bsi_fused.plain_ncc(phi_f, rem, fixed, scal,
                                                             TILE), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))

    st = bsi_fused.plain_stats(phi_f, rem, TILE)
    scal = torch.stack([st[1], st[2], fixed.min(), fixed.max()])
    kw = dict(bins=32, sigma=0.5 / 31, eps=1e-8)  # nmi()'s defaults
    out = ops.fused_nmi_histogram(phi_f, rem, fixed, scal, TILE, **kw)
    ref = bsi_fused.plain_nmi(phi_f, rem, fixed, scal, TILE, **kw)
    err = (out - ref).abs().max().item()
    rel_cell = err / ref.abs().max().item()
    log(f"bsi_fused_nmi: histogram max |kernel - plain| {err:.3e}, relative to the "
        f"largest cell {rel_cell:.3e} (limit 1e-5)")
    assert math.isfinite(rel_cell) and rel_cell <= 1e-5, rel_cell
    loss_check("bsi_fused_nmi", ("nmi", 32, 0.5, 1e-8))
    b_ms, b_by, nmi = nmi_report(torch, lib, stage_libs, phi_f, rem, fixed, scal, 32,
                                 0.5 / 31, 1e-8, "lerp")
    rows.append(dict(
        name="bsi_fused_nmi", route="cuda", source="src/repro_torch/csrc/bsi_fused.cu",
        replaces="src/repro/kernels/bsi_fused.py:291", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.fused_nmi_histogram(phi_f, rem, fixed, scal, TILE,
                                                          **kw)),
        plain_ms=cuda_ms(torch, lambda: bsi_fused.plain_nmi(phi_f, rem, fixed, scal,
                                                            TILE, **kw), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, nmi=nmi))
    for r in rows:
        log(f"{r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{'-' if r['library_ms'] is None else format(r['library_ms'], '.4f')} ms")
    return rows


def check_matmul_kernels(torch, fixed, moving, lib, stage_libs):
    """Phase 3: the matrix-form kernels, the fused variants in the matrix
    form and the fused LNCC in both forms, against their plain versions at
    phantom1 shapes."""
    from repro_torch.core import ffd
    from repro_torch.kernels import bsi_adjoint, bsi_fused, bsi_matmul, ops
    from repro_torch.launch.bounds import (bound_ms, kernel_bounds, matmul_tf32_ms,
                                           unfused_floor_ms)

    dev = fixed.device
    vol = tuple(fixed.shape)
    gshape = ffd.grid_shape_for_volume(vol, TILE)
    gen = torch.Generator(device=dev).manual_seed(1)
    phi = torch.randn(gshape + (3,), generator=gen, device=dev) * 2.5
    g = torch.randn(vol + (3,), generator=gen, device=dev) * 1e-3
    library_fwd, library_adj = yardsticks(torch, phi, g, TILE)
    bounds = {k: bound_ms(*v) for k, v in kernel_bounds(vol, TILE, 3).items()}
    rows = []

    def row(name, source, replaces, err, ms, plain_ms, bound_key, library_ms=None,
            bound=None, **extra):
        b_ms, b_by = bound or bounds[bound_key]
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=library_ms, **extra))

    # --- bsi_matmul
    err, f64 = check_matmul_forward(torch, phi, vol)
    lib_err = (library_fwd() - bsi_matmul.plain(phi, TILE, vol)).abs().max().item()
    log(f"bsi_matmul: library yardstick (conv_transpose3d) max |diff| = {lib_err:.3e}")
    log_forward_occupancy(lib, "bsi_matmul", vol)
    coarse = tuple(ffd.downsample2(fixed).shape)
    phi_c = torch.randn(ffd.grid_shape_for_volume(coarse, TILE) + (3,), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2)) * 2.5
    check_matmul_forward(torch, phi_c, coarse)
    log_forward_occupancy(lib, "bsi_matmul", coarse)
    del phi_c
    mma, gflop, tf32_ms = matmul_tf32_ms(vol, TILE, 3)
    log(f"bsi_matmul: its three TF32 products {mma / 1e6:.2f} M mma.sync, {gflop:.2f} "
        f"GFLOP, {tf32_ms:.4f} ms at 495 TFLOP/s")
    row("bsi_matmul", "src/repro_torch/csrc/bsi_matmul.cu",
        "src/repro/kernels/bsi_matmul.py:91", err,
        cuda_ms(torch, lambda: ops.bsi_matmul(phi, TILE, vol)),
        cuda_ms(torch, lambda: bsi_matmul.plain(phi, TILE, vol), reps=3), "bsi_matmul",
        cuda_ms(torch, library_fwd), tf32_ms=tf32_ms, **f64)

    # --- bsi_adjoint_matmul
    out = ops.bsi_adjoint_matmul(g, TILE, gshape)
    ref = bsi_adjoint.plain_matmul(g, TILE, gshape)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    log(f"bsi_adjoint_matmul: max |kernel - plain| = {err:.3e}, relative {rel:.3e} "
        "(limit 1e-5 relative)")
    assert math.isfinite(rel) and rel <= 1e-5, rel
    lib_err = (library_adj() - ref).abs().max().item()
    log(f"bsi_adjoint_matmul: library yardstick (conv3d) max |diff| = {lib_err:.3e}")
    adj = adjoint_matmul_summary(lib, g, gshape)
    row("bsi_adjoint_matmul", "src/repro_torch/csrc/bsi_adjoint.cu",
        "src/repro/kernels/bsi_adjoint.py:194", err, adj["ms"],
        cuda_ms(torch, lambda: bsi_adjoint.plain_matmul(g, TILE, gshape), reps=3),
        "bsi_adjoint_matmul", cuda_ms(torch, library_adj), adjoint=adj)

    # --- the fused variants in the matrix form; stats, ncc and nmi on the
    # remapped pair, as in check_kernels
    phi_f = phi * 0.4
    rem = remap(moving)
    n = rem.numel()
    fused_src, fused_rep = "src/repro_torch/csrc/bsi_fused.cu", "src/repro/kernels/bsi_fused.py:291"
    mm = dict(disp_form="matmul")
    # the matrix form's floor under its rounding, beside its byte bound
    floor = unfused_floor_ms(vol)
    log(f"fused matrix form: 384 unfused fp32 instructions a voxel, floor {floor:.4f} ms")
    out = ops.fused_ssd_loss(phi_f, moving, fixed, TILE, **mm)
    ref = bsi_fused.plain(phi_f, moving, fixed, TILE, **mm) / n
    err = abs(out.item() - ref.item())
    rel = err / abs(ref.item())
    log(f"bsi_fused_matmul: kernel {out.item():.9g} plain {ref.item():.9g} relative "
        f"{rel:.3e} (limit 1e-5 relative)")
    assert math.isfinite(rel) and rel <= 1e-5, rel
    log_walk(torch, lib, "bsi_fused_matmul",
             lambda: ops.fused_ssd_loss(phi_f, moving, fixed, TILE, **mm), vol)
    row("bsi_fused_matmul", fused_src, fused_rep + " (disp_form=matmul, :87-89)", err,
        cuda_ms(torch, lambda: ops.fused_ssd_loss(phi_f, moving, fixed, TILE, **mm)),
        cuda_ms(torch, lambda: bsi_fused.plain(phi_f, moving, fixed, TILE, **mm), reps=3),
        "bsi_fused_ssd_matmul")

    out = ops.fused_stats(phi_f, rem, TILE, **mm)
    st = bsi_fused.plain_stats(phi_f, rem, TILE, **mm)
    rel = abs(out[0].item() - st[0].item()) / abs(st[0].item())
    log(f"bsi_fused_stats_matmul: kernel {out.tolist()} plain {st.tolist()}; sum "
        f"relative {rel:.3e} (limit 1e-5); min, max, count exact: "
        f"{torch.equal(out[1:], st[1:])}")
    assert torch.equal(out[1:], st[1:]) and out[3].item() == n, (out, st)
    assert math.isfinite(rel) and rel <= 1e-5, rel
    log_walk(torch, lib, "bsi_fused_stats_matmul",
             lambda: ops.fused_stats(phi_f, rem, TILE, **mm), vol)
    row("bsi_fused_stats_matmul", fused_src, fused_rep + " (disp_form=matmul)",
        (out - st).abs().max().item(),
        cuda_ms(torch, lambda: ops.fused_stats(phi_f, rem, TILE, **mm)),
        cuda_ms(torch, lambda: bsi_fused.plain_stats(phi_f, rem, TILE, **mm), reps=3),
        "bsi_fused_stats_matmul")

    scal = torch.stack([st[0] / n, fixed.mean()])
    out = ops.fused_ncc_moments(phi_f, rem, fixed, scal, TILE, **mm)
    ref = bsi_fused.plain_ncc(phi_f, rem, fixed, scal, TILE, **mm)
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    log(f"bsi_fused_ncc_matmul: moments max |kernel - plain| {err:.3e}, relative "
        f"{rel:.3e} (limit 1e-5)")
    assert math.isfinite(rel) and rel <= 1e-5, rel
    log_walk(torch, lib, "bsi_fused_ncc_matmul",
             lambda: ops.fused_ncc_moments(phi_f, rem, fixed, scal, TILE, **mm), vol)
    row("bsi_fused_ncc_matmul", fused_src, fused_rep + " (disp_form=matmul)", err,
        cuda_ms(torch, lambda: ops.fused_ncc_moments(phi_f, rem, fixed, scal, TILE, **mm)),
        cuda_ms(torch, lambda: bsi_fused.plain_ncc(phi_f, rem, fixed, scal, TILE, **mm),
                reps=3), "bsi_fused_ncc_matmul")

    scal = torch.stack([st[1], st[2], fixed.min(), fixed.max()])
    kw = dict(bins=32, sigma=0.5 / 31, eps=1e-8, **mm)
    out = ops.fused_nmi_histogram(phi_f, rem, fixed, scal, TILE, **kw)
    ref = bsi_fused.plain_nmi(phi_f, rem, fixed, scal, TILE, **kw)
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    log(f"bsi_fused_nmi_matmul: histogram max |kernel - plain| {err:.3e}, relative to "
        f"the largest cell {rel:.3e} (limit 1e-5)")
    assert math.isfinite(rel) and rel <= 1e-5, rel
    b_ms, b_by, nmi = nmi_report(torch, lib, stage_libs, phi_f, rem, fixed, scal, 32,
                                 0.5 / 31, 1e-8, "matmul")
    row("bsi_fused_nmi_matmul", fused_src, fused_rep + " (disp_form=matmul)", err,
        cuda_ms(torch, lambda: ops.fused_nmi_histogram(phi_f, rem, fixed, scal, TILE,
                                                       **kw)),
        cuda_ms(torch, lambda: bsi_fused.plain_nmi(phi_f, rem, fixed, scal, TILE, **kw),
                reps=3), "bsi_fused_nmi_matmul", bound=(b_ms, b_by), nmi=nmi)

    # --- the fused LNCC, both forms, on the mono-modal pair (window 9): the
    # marching column, beside the halo-cube kernel it replaced (PERF.md row
    # 3e: 18.43 and 21.57 ms on an H100 80GB HBM3 at 700 W)
    halo_cube_ms = {"lerp": 18.43, "matmul": 21.57}
    for form, name in (("lerp", "bsi_fused_lncc"), ("matmul", "bsi_fused_lncc_matmul")):
        lk = dict(window=9, eps=1e-5, disp_form=form)
        out = ops.fused_lncc(phi_f, moving, fixed, TILE, **lk)
        ref = bsi_fused.plain_lncc(phi_f, moving, fixed, TILE, **lk)
        err = abs(out[0].item() - ref[0].item())
        rel = err / abs(ref[0].item())
        npos = math.prod(s - 8 for s in vol)
        log(f"{name}: sum cc kernel {out[0].item():.9g} plain {ref[0].item():.9g} "
            f"relative {rel:.3e} (limit 1e-5); count {out[1].item():.0f} "
            f"(VALID positions {npos})")
        assert math.isfinite(rel) and rel <= 1e-5, rel
        assert out[1].item() == ref[1].item() == npos, (out, ref)
        row(name, fused_src, fused_rep + f" (lncc, :218-239; disp_form={form})", err,
            cuda_ms(torch, lambda: ops.fused_lncc(phi_f, moving, fixed, TILE, **lk)),
            cuda_ms(torch, lambda: bsi_fused.plain_lncc(phi_f, moving, fixed, TILE, **lk),
                    reps=3), "bsi_fused_lncc" + ("_matmul" if form == "matmul" else ""))
        own, _ = bsi_fused.lncc_blocks(TILE, 9, form, vol)
        log(f"{name}: column {own} tiles, {bsi_fused.num_partials(vol, TILE, own)} "
            f"blocks; {rows[-1]['ms']:.4f} ms (the halo-cube kernel it replaced: "
            f"{halo_cube_ms[form]} ms, {halo_cube_ms[form] / rows[-1]['ms']:.2f}x)")
    for r in rows:
        log(f"{r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{'-' if r['library_ms'] is None else format(r['library_ms'], '.4f')} ms")
    return rows


def log_forward_occupancy(lib, name, vol):
    """The forward kernel ``name``'s registers (asserted: no spills), shared
    memory and resident blocks an SM, and its grid at ``vol``
    (``launch/profile_forward.py``)."""
    from repro_torch.launch.profile_forward import occupancy

    occ = occupancy(lib, name, TILE, 3, vol)
    assert "0/0 B spill" in occ["registers"], occ["registers"]
    along_z = f"{occ['bz']} tiles along z a block, " if "bz" in occ else ""
    log(f"{name}: {occ['registers']}; {occ['smem']} B of shared memory a block, "
        f"{occ['blocks_per_sm']} blocks an SM; {along_z}grid {occ['grid']}")


def log_walk(torch, lib, name, call, vol):
    """The fused ssd, stats or ncc kernel ``name`` (either form): its
    registers (asserted: no spills), shared memory, resident blocks an SM and
    grid (``launch/profile_fused.py``), and two calls of ``call`` bit-equal
    (asserted)."""
    from repro_torch.launch.profile_fused import occupancy

    occ = occupancy(lib, name, TILE, vol)
    assert "0/0 B spill" in occ["registers"], occ["registers"]
    same = torch.equal(call(), call())
    log(f"{name}: {occ['registers']}; {occ['smem']} B of shared memory a block, "
        f"{occ['blocks_per_sm']} blocks an SM, grid {occ['grid']}; two calls "
        f"bit-equal: {same}")
    assert same


def check_tt_bits(torch, phi, vol):
    """``bsi_tt`` at ``vol``: equal to its plain version bit for bit, and
    two calls equal (asserted)."""
    from repro_torch.kernels import bsi_tt, ops

    a, b = ops.bsi_tt(phi, TILE, vol), ops.bsi_tt(phi, TILE, vol)
    ref = bsi_tt.plain(phi, TILE, vol)
    torch.cuda.synchronize()
    same, again = torch.equal(a, ref), torch.equal(a, b)
    log(f"bsi_tt at {vol}: bit for bit with plain: {same}; two calls bit-equal: {again}")
    assert same and again, (vol, (a - ref).abs().max().item())


def check_forward_forms(torch, fixed, lib):
    """Phase 3: the separable and TT forward kernels at phantom1, cropped to
    the volume, against their plain versions (1e-5 of the largest value;
    TT bit for bit, there and at the main path's coarse level, and two
    calls bit-equal); ``lib`` the kernels as built."""
    from repro_torch.core import ffd
    from repro_torch.kernels import bsi_separable, bsi_tt, ops
    from repro_torch.launch.bounds import bound_ms, kernel_bounds

    dev = fixed.device
    vol = tuple(fixed.shape)
    gshape = ffd.grid_shape_for_volume(vol, TILE)
    gen = torch.Generator(device=dev).manual_seed(3)
    phi = torch.randn(gshape + (3,), generator=gen, device=dev) * 2.5
    library_fwd, _ = yardsticks(torch, phi, torch.empty(vol + (3,), device=dev), TILE)
    bounds = {k: bound_ms(*v) for k, v in kernel_bounds(vol, TILE, 3).items()}
    rows = []
    for name, module, replaces in (
            ("bsi_separable", bsi_separable, "src/repro/kernels/bsi_separable.py:70"),
            ("bsi_tt", bsi_tt, "src/repro/kernels/bsi_tt.py:58")):
        kernel = ops.FORWARD_KERNELS[name[len("bsi_"):]]
        out = kernel(phi, TILE, vol)
        ref = module.plain(phi, TILE, vol)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        log(f"{name}: max |kernel - plain| = {err:.3e}, relative to the largest value "
            f"{rel:.3e} (limit 1e-5); bit for bit: {torch.equal(out, ref)}")
        assert math.isfinite(rel) and rel <= 1e-5, rel
        del out, ref
        log_forward_occupancy(lib, name, vol)
        if name == "bsi_tt":
            check_tt_bits(torch, phi, vol)
            coarse = tuple(ffd.downsample2(fixed).shape)
            phi_c = torch.randn(ffd.grid_shape_for_volume(coarse, TILE) + (3,),
                                generator=gen, device=dev) * 2.5
            check_tt_bits(torch, phi_c, coarse)
            log_forward_occupancy(lib, name, coarse)
        b_ms, b_by = bounds[name]
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=replaces, max_abs_err=err,
            ms=cuda_ms(torch, lambda: kernel(phi, TILE, vol)),
            plain_ms=cuda_ms(torch, lambda: module.plain(phi, TILE, vol), reps=3),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(torch, library_fwd)))
    for r in rows:
        log(f"{r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"(conv_transpose3d) {r['library_ms']:.4f} ms")
    return rows


def run_main_path(torch, fixed, moving):
    """Phase 4: the port's ffd_register on the kernels, counted."""
    from repro_torch import RegistrationOptions, ffd_register
    from repro_torch.kernels import ops

    opts = RegistrationOptions(fused="on")
    mem0 = torch.cuda.memory_stats()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = ffd_register(fixed, moving, options=opts, measure_bsi_time=True)
    counts = ops.launch_counts()
    mem1 = torch.cuda.memory_stats()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path: peak device memory {peak:.2f} GiB; allocator " + ", ".join(
            f"{k} +{mem1.get(k, 0) - mem0.get(k, 0)}"
            for k in ("num_alloc_retries", "num_device_alloc", "num_device_free")))
    steps = opts.levels * (opts.iters + 1)
    expected = only(bsi_ttli=steps + 1 + 4, bsi_adjoint=steps, bsi_fused=steps)
    log(f"main path: losses {res.losses}, {res.seconds:.3f} s, bsi_seconds "
        f"{res.bsi_seconds:.4f}, launches {counts} (expected {expected})")
    assert all(counts[k] > 0 for k in ("bsi_ttli", "bsi_adjoint", "bsi_fused")), counts
    assert counts == expected, (counts, expected)
    assert res.warped.shape == fixed.shape and res.params.shape[3] == 3
    assert torch.isfinite(res.warped).all() and torch.isfinite(res.params).all()
    mae0 = (moving - fixed).abs().mean().item()
    mae1 = (res.warped - fixed).abs().mean().item()
    log(f"main path: mean |moving - fixed| {mae0:.6f} -> |warped - fixed| {mae1:.6f}")
    assert mae1 < mae0, (mae0, mae1)
    return counts


def compare_paths(torch, fixed, moving):
    """Phase 4: kernels vs plain path at iters=5, and the card vs the CPU."""
    from repro_torch import RegistrationOptions, ffd_register, make_pair
    from repro_torch.kernels import ops

    kern = ffd_register(fixed, moving, options=RegistrationOptions(iters=5, fused="on"))
    ops.reset_launch_counts()
    plain = ffd_register(fixed, moving, options=RegistrationOptions(
        iters=5, impl="torch", grad_impl="torch", fused="off"))
    assert not any(ops.launch_counts().values()), ops.launch_counts()  # plain ops only
    rel = max(abs(a - b) / abs(b) for a, b in zip(kern.losses, plain.losses))
    log(f"iters=5: kernels {kern.losses} plain {plain.losses} max relative {rel:.3e} "
        f"(limit 1e-4); {kern.seconds:.3f} s vs {plain.seconds:.3f} s")
    assert rel <= 1e-4, rel

    f, m, _ = make_pair((28, 24, 20), seed=0, device="cpu")
    opts = RegistrationOptions(iters=5, fused="on")
    card = ffd_register(f, m, options=opts)
    host = ffd_register(f, m, options=opts, device="cpu")
    err = (card.params.cpu() - host.params).abs().max().item()
    log(f"small pair: card {card.losses} cpu {host.losses}, "
        f"params max |diff| {err:.3e}")
    assert err <= 1e-4 and all(abs(a - b) <= 1e-4 * abs(b)
                               for a, b in zip(card.losses, host.losses))


def run_multimodal(torch, fixed, moving):
    """Phase 4: the multi-modal path, ``similarity="nmi"`` on the remapped pair."""
    from repro_torch import RegistrationOptions, ffd_register
    from repro_torch.core import ffd, metrics
    from repro_torch.kernels import ops

    rem = remap(moving)
    opts = RegistrationOptions(similarity="nmi", fused="on")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = ffd_register(fixed, rem, options=opts, measure_bsi_time=True)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = opts.levels * (opts.iters + 1)
    expected = only(bsi_ttli=steps + 1 + 4, bsi_adjoint=steps, bsi_fused_stats=steps,
                    bsi_fused_nmi=steps)
    res_s = res.seconds
    log(f"nmi path: losses {res.losses}, {res.seconds:.3f} s, bsi_seconds "
        f"{res.bsi_seconds:.4f}, peak device memory {peak:.2f} GiB, launches "
        f"{counts} (expected {expected})")
    assert counts == expected, (counts, expected)
    assert torch.isfinite(res.params).all() and all(map(math.isfinite, res.losses))

    def recovered_mae(params):
        """MAE of the original moving volume warped by a recovered field."""
        with torch.no_grad():
            disp = ffd.dense_field(params, TILE, tuple(fixed.shape), mode="ttli",
                                   impl="cuda", grad_impl="cuda")
            return metrics.mae(ffd.warp_volume(moving, disp), fixed).item()

    mae0 = metrics.mae(moving, fixed).item()
    mae_nmi = recovered_mae(res.params)
    ssd = ffd_register(fixed, rem, options=RegistrationOptions(fused="on"))
    mae_ssd = recovered_mae(ssd.params)
    log(f"nmi path: MAE of the recovered warp, pre-registration {mae0:.6f}, nmi "
        f"{mae_nmi:.6f}, ssd on the same remapped pair {mae_ssd:.6f} "
        f"({ssd.seconds:.3f} s)")
    assert mae_nmi < mae0, (mae0, mae_nmi)
    del res, ssd
    auto_fused = log_fused_resolution(torch, tuple(fixed.shape), "nmi options",
                                      similarity="nmi")
    return counts, dict(seconds=res_s, peak_gib=peak, mae=(mae0, mae_nmi),
                        fused_auto=auto_fused)


def compare_multimodal_paths(torch, fixed, moving):
    """Phase 4: NCC and NMI at iters=5 on the kernels and on the plain path,
    and a small remapped pair with NMI on the card against the CPU."""
    from repro_torch import RegistrationOptions, ffd_register, make_pair
    from repro_torch.kernels import ops

    rem = remap(moving)
    counts = {}
    for sim in ("ncc", "nmi"):
        ops.reset_launch_counts()
        kern = ffd_register(fixed, rem, options=RegistrationOptions(
            iters=5, similarity=sim, fused="on"))
        counts[sim] = ops.launch_counts()
        steps = 2 * (5 + 1)
        expected = only(bsi_ttli=steps + 1, bsi_adjoint=steps, bsi_fused_stats=steps,
                        **{f"bsi_fused_{sim}": steps})
        assert counts[sim] == expected, (sim, counts[sim], expected)
        ops.reset_launch_counts()
        plain = ffd_register(fixed, rem, options=RegistrationOptions(
            iters=5, impl="torch", grad_impl="torch", fused="off", similarity=sim))
        assert not any(ops.launch_counts().values()), ops.launch_counts()
        rel = max(abs(a - b) / abs(b) for a, b in zip(kern.losses, plain.losses))
        log(f"{sim} iters=5: kernels {kern.losses} plain {plain.losses} max relative "
            f"{rel:.3e} (limit 1e-4); {kern.seconds:.3f} s vs {plain.seconds:.3f} s; "
            f"launches {counts[sim]}")
        assert rel <= 1e-4, rel

    f, m, _ = make_pair((28, 24, 20), seed=0, device="cpu")
    opts = RegistrationOptions(iters=5, similarity="nmi", fused="on")
    card = ffd_register(f, remap(m), options=opts)
    host = ffd_register(f, remap(m), options=opts, device="cpu")
    err = (card.params.cpu() - host.params).abs().max().item()
    log(f"small remapped pair, nmi: card {card.losses} cpu {host.losses}, "
        f"params max |diff| {err:.3e}")
    assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(card.losses, host.losses))
    return counts["ncc"]


LNCC_MATMUL = dict(similarity="lncc", mode="matmul", grad_impl="matmul", fused="on")


def run_lncc_path(torch, fixed, moving):
    """Phase 4: the slice's path, LNCC in the matrix form at phantom1 (full
    depth), cold then warm, and the plain path at full depth beside it; the
    launches are those of the cold call.

    The MAE of the warp is printed, not asserted to fall: at phantom1 the
    phantom's local variances (noise sd 0.01, smooth parenchyma) sit far
    below LNCC's eps of 1e-5, the mean local cc^2 stays near 0.1 and
    Adam's per-entry steps move the grid where LNCC has no signal.  The same
    registration at a quarter and a half of phantom1's extent (the same
    phantom, finer structures per voxel) shows the trend, and there the MAE
    must fall.  The kernel path must match the plain path at full depth.
    """
    from repro_torch import RegistrationOptions, ffd_register, make_pair
    from repro_torch.core import metrics
    from repro_torch.kernels import ops

    opts = RegistrationOptions(**LNCC_MATMUL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = ffd_register(fixed, moving, options=opts, measure_bsi_time=True)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    warm = ffd_register(fixed, moving, options=opts)
    steps = opts.levels * (opts.iters + 1)
    expected = only(bsi_matmul=steps + 1 + 4, bsi_adjoint_matmul=steps,
                    bsi_fused_lncc_matmul=steps)
    mae0 = metrics.mae(moving, fixed).item()
    mae1 = metrics.mae(res.warped, fixed).item()
    falls = [(t[0].item(), t[-1].item()) for t in res.traces]
    log(f"lncc matmul path: cold {res.seconds:.3f} s, warm {warm.seconds:.3f} s, "
        f"bsi_seconds {res.bsi_seconds:.4f}, peak device memory {peak:.2f} GiB; "
        f"losses {res.losses} (each level first -> last step {falls}); MAE "
        f"{mae0:.6f} -> {mae1:.6f}; launches {counts} (expected {expected})")
    assert counts == expected, (counts, expected)
    assert all(last < first for first, last in falls), falls
    assert warm.losses == res.losses, (warm.losses, res.losses)
    assert torch.isfinite(res.warped).all() and torch.isfinite(res.params).all()

    ops.reset_launch_counts()
    plain = ffd_register(fixed, moving, options=RegistrationOptions(
        **dict(LNCC_MATMUL, impl="torch", grad_impl="torch", fused="off")))
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    mae_plain = metrics.mae(plain.warped, fixed).item()
    rel = max(abs(a - b) / abs(b) for a, b in zip(res.losses, plain.losses))
    log(f"lncc matmul path, plain at full depth: losses {plain.losses}, MAE "
        f"{mae_plain:.6f}, {plain.seconds:.3f} s; kernels vs plain: losses max "
        f"relative {rel:.3e} (limit 1e-4), MAE relative "
        f"{abs(mae1 - mae_plain) / mae_plain:.3e} (limit 1e-2)")
    assert rel <= 1e-4, rel
    # Adam's per-entry steps carry float32 gradient differences into the
    # grid (5e-4 of the MAE at 40 x 33 x 47 on the CPU); 1e-2 still tells
    # the kernels apart from a change of the MAE by the registration itself
    assert abs(mae1 - mae_plain) <= 1e-2 * mae_plain, (mae1, mae_plain)

    auto_fused = log_fused_resolution(torch, tuple(fixed.shape), "lncc matmul options",
                                      **dict(LNCC_MATMUL, fused="auto"))

    trend = []
    for shape in ((128, 57, 96), (256, 114, 192)):
        f, m, _ = make_pair(shape, seed=0)
        r = ffd_register(f, m, options=opts)
        trend.append((shape, metrics.mae(m, f).item(), metrics.mae(r.warped, f).item(),
                      r.losses))
    trend.append((tuple(fixed.shape), mae0, mae1, res.losses))
    for shape, before, after, losses in trend:
        log(f"lncc matmul at {shape}: MAE {before:.6f} -> {after:.6f} "
            f"({after / before - 1:+.1%}), losses {losses}")
    assert trend[0][2] < trend[0][1], trend[0]
    return counts, dict(cold_s=res.seconds, warm_s=warm.seconds, peak_gib=peak,
                        losses=res.losses, mae=(mae0, mae1), plain_s=plain.seconds,
                        fused_auto=auto_fused, trend=[t[:3] for t in trend])


def log_fused_resolution(torch, vol, label, **fields):
    """Phase 4: what ``fused="auto"`` resolves to for
    ``RegistrationOptions(**fields)`` at ``vol``: the fused level step's race
    against the unfused one, once, on a fresh temporary disk cache."""
    from repro_torch import RegistrationOptions
    from repro_torch.engine import autotune

    opts = RegistrationOptions(**fields)
    assert opts.fused == "auto", opts
    with tempfile.TemporaryDirectory(prefix="repro_torch_autotune_") as cache_dir:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(cache_dir, "fused.json")
        try:
            autotune._MEM_CACHE.clear()
            autotune.resolve_options.cache_clear()
            n_races = len(autotune.RACES)
            t0 = time.perf_counter()
            r = autotune.resolve_options(opts, vol, torch.device("cuda"))
            race_s = time.perf_counter() - t0
        finally:
            del os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
    assert len(autotune.RACES) == n_races + 1 and "race" in r.fused_reason, r
    log(f"{label}, fused='auto' at {vol}: fused={r.fused} "
        f"({r.fused_reason}); resolve {race_s:.3f} s, race: "
        + ", ".join(f"{n} " + ("did not fit" if us is None else f"{us / 1e3:.3f} ms")
                    for n, us in autotune.RACES[-1].timings))
    return r.fused


def compare_matmul_paths(torch, fixed, moving):
    """Phase 4: kernels vs plain path at iters=5 for LNCC in both forms and
    SSD, NCC and NMI in the matrix form (NCC and NMI on the remapped pair);
    then the LNCC matrix form on a small pair, card against CPU.  Returns
    each path's launch counts."""
    from repro_torch import RegistrationOptions, ffd_register, make_pair
    from repro_torch.kernels import ops

    steps = 2 * (5 + 1)
    paths = {
        "lncc": (dict(similarity="lncc", fused="on"), moving,
                 only(bsi_ttli=steps + 1, bsi_adjoint=steps, bsi_fused_lncc=steps)),
        "lncc_matmul": (LNCC_MATMUL, moving,
                        only(bsi_matmul=steps + 1, bsi_adjoint_matmul=steps,
                             bsi_fused_lncc_matmul=steps)),
        "ssd_matmul": (dict(mode="matmul", grad_impl="matmul", fused="on"), moving,
                       only(bsi_matmul=steps + 1, bsi_adjoint_matmul=steps,
                            bsi_fused_matmul=steps)),
        "ncc_matmul": (dict(similarity="ncc", mode="matmul", grad_impl="matmul",
                            fused="on"),
                       remap(moving),
                       only(bsi_matmul=steps + 1, bsi_adjoint_matmul=steps,
                            bsi_fused_stats_matmul=steps, bsi_fused_ncc_matmul=steps)),
        "nmi_matmul": (dict(similarity="nmi", mode="matmul", grad_impl="matmul",
                            fused="on"),
                       remap(moving),
                       only(bsi_matmul=steps + 1, bsi_adjoint_matmul=steps,
                            bsi_fused_stats_matmul=steps, bsi_fused_nmi_matmul=steps)),
    }
    counts = {}
    for name, (fields, mov, expected) in paths.items():
        ops.reset_launch_counts()
        kern = ffd_register(fixed, mov, options=RegistrationOptions(iters=5, **fields))
        counts[name] = ops.launch_counts()
        assert counts[name] == expected, (name, counts[name], expected)
        ops.reset_launch_counts()
        plain = ffd_register(fixed, mov, options=RegistrationOptions(
            iters=5, **dict(fields, impl="torch", grad_impl="torch", fused="off")))
        assert not any(ops.launch_counts().values()), ops.launch_counts()
        rel = max(abs(a - b) / abs(b) for a, b in zip(kern.losses, plain.losses))
        log(f"{name} iters=5: kernels {kern.losses} plain {plain.losses} max relative "
            f"{rel:.3e} (limit 1e-4); {kern.seconds:.3f} s vs {plain.seconds:.3f} s")
        assert rel <= 1e-4, rel

    f, m, _ = make_pair((28, 24, 20), seed=0, device="cpu")
    opts = RegistrationOptions(iters=5, **LNCC_MATMUL)
    card = ffd_register(f, m, options=opts)
    host = ffd_register(f, m, options=opts, device="cpu")
    err = (card.params.cpu() - host.params).abs().max().item()
    log(f"small pair, lncc matmul: card {card.losses} cpu {host.losses}, params max "
        f"|diff| {err:.3e}")
    assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(card.losses, host.losses))
    return counts


def level_falls(res):
    """Each level's first and last loss of the Adam trace."""
    return [(t[0].item(), t[-1].item()) for t in res.traces]


def run_forward_form_paths(torch, fixed, moving):
    """Phase 4: ``mode="separable"`` and ``mode="tt"`` on the kernels at
    phantom1, full depth, counted; then each at ``iters=5`` on the kernels
    and on the plain path.  Returns each path's launch counts and a summary
    of its call."""
    from repro_torch import RegistrationOptions, ffd_register
    from repro_torch.core import metrics
    from repro_torch.kernels import ops

    counts, calls = {}, {}
    mae0 = metrics.mae(moving, fixed).item()
    for mode in ("separable", "tt"):
        opts = RegistrationOptions(mode=mode, fused="on")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = ffd_register(fixed, moving, options=opts, measure_bsi_time=True)
        counts[mode] = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = opts.levels * (opts.iters + 1)
        expected = only(bsi_adjoint=steps, bsi_fused=steps,
                        **{f"bsi_{mode}": steps + 1 + 4})
        mae1 = metrics.mae(res.warped, fixed).item()
        falls = level_falls(res)
        log(f"{mode} path: {res.seconds:.3f} s, bsi_seconds {res.bsi_seconds:.4f}, "
            f"peak device memory {peak:.2f} GiB; losses {res.losses} (each level "
            f"first -> last step {falls}); MAE {mae0:.6f} -> {mae1:.6f}; launches "
            f"{counts[mode]} (expected {expected})")
        assert counts[mode] == expected, (mode, counts[mode], expected)
        assert all(last < first for first, last in falls), falls
        assert mae1 < mae0, (mae0, mae1)
        assert torch.isfinite(res.warped).all() and torch.isfinite(res.params).all()
        calls[mode] = dict(seconds=res.seconds, peak_gib=peak, mae=(mae0, mae1),
                           losses=res.losses)

        kern = ffd_register(fixed, moving, options=RegistrationOptions(
            iters=5, mode=mode, fused="on"))
        ops.reset_launch_counts()
        plain = ffd_register(fixed, moving, options=RegistrationOptions(
            iters=5, mode=mode, impl="torch", grad_impl="torch", fused="off"))
        assert not any(ops.launch_counts().values()), ops.launch_counts()
        rel = max(abs(a - b) / abs(b) for a, b in zip(kern.losses, plain.losses))
        log(f"{mode} iters=5: kernels {kern.losses} plain {plain.losses} max relative "
            f"{rel:.3e} (limit 1e-4); {kern.seconds:.3f} s vs {plain.seconds:.3f} s")
        assert rel <= 1e-4, rel
    return counts, calls


def expected_launches(opts, steps):
    """The launch counts of an ``ffd_register`` call with resolved options
    ``opts`` and ``steps`` gradient evaluations: per step the forward and
    adjoint kernels of its axes and, fused, the fused SSD kernel; one more
    forward for the final warp."""
    counts = {}
    if opts.impl == "cuda":
        counts[f"bsi_{opts.mode}"] = steps + 1
    if opts.grad_impl in ("cuda", "matmul"):
        counts[{"cuda": "bsi_adjoint", "matmul": "bsi_adjoint_matmul"}[
            opts.grad_impl]] = steps
    if opts.fused == "on":
        counts["bsi_fused_matmul" if opts.mode == "matmul" else "bsi_fused"] = steps
    return only(**counts)


def run_auto_path(torch, fixed, moving):
    """Phase 4: the JAX package's default call, every axis ``"auto"``, at
    phantom1 at full depth: the race (on a fresh disk cache), the call on the
    winner, and a second resolve read from the disk file.  Returns the
    call's launch counts and a summary."""
    from repro_torch import RegistrationOptions
    from repro_torch.engine import autotune

    with tempfile.TemporaryDirectory(prefix="repro_torch_autotune_") as cache_dir:
        cache = os.path.join(cache_dir, "bsi_autotune.json")
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache
        try:
            out = _auto_path(torch, fixed, moving, autotune, cache, RegistrationOptions(
                mode="auto", impl="auto", grad_impl="auto", fused="auto"))
            # a fresh cache: the default's race may share its key with the above
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(cache_dir, "default.json")
            log_default_resolution(torch, autotune, tuple(fixed.shape))
            return out
        finally:
            del os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]


def log_default_resolution(torch, autotune, vol):
    """Phase 4: what ``RegistrationOptions()`` (SSD, ``fused="auto"``)
    resolves to on the card at ``vol``: the fused step's race against the
    unfused TTLI step, once."""
    from repro_torch import RegistrationOptions

    autotune._MEM_CACHE.clear()
    autotune.resolve_options.cache_clear()
    n_races = len(autotune.RACES)
    t0 = time.perf_counter()
    r = autotune.resolve_options(RegistrationOptions(), vol, torch.device("cuda"))
    race_s = time.perf_counter() - t0
    log(f"default options at {vol} (ssd): mode={r.mode} impl={r.impl} "
        f"grad_impl={r.grad_impl} fused={r.fused} ({r.fused_reason}); resolve "
        f"{race_s:.3f} s, {len(autotune.RACES) - n_races} race: "
        + ", ".join(f"{n} " + ("did not fit" if us is None else f"{us / 1e3:.3f} ms")
                    for n, us in autotune.RACES[-1].timings))
    assert (r.mode, r.impl, r.grad_impl) == ("ttli", "cuda", "cuda"), r
    assert "race" in r.fused_reason and len(autotune.RACES) == n_races + 1, r


def _auto_path(torch, fixed, moving, autotune, cache, opts):
    from repro_torch import ffd_register
    from repro_torch.core import metrics
    from repro_torch.kernels import ops

    device = torch.device("cuda")
    vol = tuple(fixed.shape)
    autotune.RACES.clear()
    autotune._MEM_CACHE.clear()
    autotune.resolve_options.cache_clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resolved = autotune.resolve_options(opts, vol, device)
    race_s = time.perf_counter() - t0
    race_peak = torch.cuda.max_memory_allocated() / 2**30
    races = list(autotune.RACES)
    log(f"auto: resolve {race_s:.3f} s (peak device memory {race_peak:.2f} GiB), "
        f"{len(races)} races")
    for race in races:
        log(f"  race {race.key[:120]}...: {race.seconds:.3f} s, winner {race.winner}")
        for name, us in race.timings:
            log(f"    {name:28s} " + ("did not fit" if us is None
                                    else f"{us / 1e3:10.3f} ms"))
    log(f"auto: resolved mode={resolved.mode} impl={resolved.impl} "
        f"grad_impl={resolved.grad_impl} fused={resolved.fused} "
        f"({resolved.fused_reason})")
    # on the card "auto" races the 12 kernel triples and no plain form
    timings = races[0].timings
    assert len(timings) == 12 and all(
        n.split("/")[1] == "cuda" and us for n, us in timings), timings
    assert resolved.impl == "cuda", resolved
    assert len(races) == 2 and "race" in resolved.fused_reason, races

    steps = opts.levels * (opts.iters + 1)
    expected = expected_launches(resolved, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = ffd_register(fixed, moving, options=opts)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    mae0 = metrics.mae(moving, fixed).item()
    mae1 = metrics.mae(res.warped, fixed).item()
    falls = level_falls(res)
    log(f"auto path: {res.seconds:.3f} s, peak device memory {peak:.2f} GiB; "
        f"losses {res.losses} (each level first -> last step {falls}); MAE "
        f"{mae0:.6f} -> {mae1:.6f}; launches {counts} (expected {expected})")
    assert counts == expected, (counts, expected)
    assert counts[f"bsi_{resolved.mode}"] > 0, counts  # the winner's forward kernel
    assert len(autotune.RACES) == len(races)  # the call raced nothing
    assert all(last < first for first, last in falls), falls
    assert mae1 < mae0, (mae0, mae1)

    autotune._MEM_CACHE.clear()
    autotune.resolve_options.cache_clear()
    t0 = time.perf_counter()
    again = autotune.resolve_options(opts, vol, device)
    hit_s = time.perf_counter() - t0
    with open(cache) as fh:
        entries = json.load(fh)["entries"]
    log(f"auto: second resolve from the disk file {hit_s * 1e3:.1f} ms, "
        f"{len(entries)} entries, no race: {len(autotune.RACES) == len(races)}")
    assert again == resolved and again.fused_reason == resolved.fused_reason
    assert len(autotune.RACES) == len(races) and len(entries) == 2, entries
    return counts, dict(
        race_s=race_s, race_peak_gib=race_peak, seconds=res.seconds, peak_gib=peak,
        mae=(mae0, mae1), resolved=(resolved.mode, resolved.impl, resolved.grad_impl,
                                    resolved.fused),
        races=[(race.seconds, race.timings) for race in races])


SERVE_ARCH = "gemma2-2b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 8160, 32  # 8160: not a multiple of 64


def flash_close(torch, out, ref, kind, v):
    """``(max |out - ref|, values more than one bf16 step apart)``; asserts
    float32 within 2e-5 (the sums run in another order).  bf16 against the
    rounding twin (``kind="twin"``, on exact-score inputs): within one bf16
    step, as the float32 values differ by the order of the sums of ``l`` and
    ``P V`` only; against ``plain`` (``kind="plain"``, float32 ``p``): one
    step and ``2^-8 max|v|``, the most that rounding ``p`` to bf16 moves an
    output.  ``kind="report"`` asserts nothing."""
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    err = diff.max().item()
    assert math.isfinite(err), err
    if out.dtype == torch.float32:
        assert kind == "report" or err <= 2e-5, err
        return err, 0
    step = 2.0**-7 * torch.maximum(o.abs(), r.abs()) + 1e-5
    far = int((diff > step).sum())
    if kind == "twin":
        assert far == 0, (kind, err, far)
    elif kind == "plain":
        bound = step + 2.0**-8 * v.float().abs().max()
        assert bool((diff <= bound).all()), (kind, err)
    return err, far


def exact_scores(torch, q, k):
    """q and k on the quarter-integers of [-4, 4] (exact in bf16): every
    partial sum of ``q . k`` is exact in float32, so the kernel's tensor
    cores and the twin's einsum give the same scores bit for bit."""
    return tuple(((4 * t.float()).round().clamp(-16, 16) / 4).to(t.dtype) for t in (q, k))


def check_flash(torch):
    """Phase 5: the flash-attention kernels against their plain version at
    gemma2-2b's layer (batch 4, 8160 tokens, 8 query and 4 key/value heads,
    head dim 256): bf16 (wgmma) for a global layer at softcap 50 and 0 and a
    local one (window 4096, softcap 50), float32 (mma.sync, 3xTF32) for a
    global layer at softcap 50 and 0, and a small non-causal MQA case at
    head dim 64 in float32; each timed beside its plain version and its
    bound, the softcap-0 layers beside ``scaled_dot_product_attention``
    (causal, GQA), the same function: bf16 as the library picks its backend,
    float32 on the backend ``launch.profile_flash.sdpa_f32`` pins (named on
    the line) and held to the kernel at 2e-5, the float32 limit.  bf16 is
    held to ``plain`` (float32 ``p``) on normal inputs at the derived bound,
    and on exact-score inputs to the rounding twin (``plain(...,
    p_dtype=bfloat16)``) at one bf16 step and to ``plain`` again; float32 to
    ``plain`` at 2e-5, two calls bit-equal.  Returns the kernels' rows (each
    the softcap-0 case, so that its ``ms`` and ``library_ms`` time one
    function; the float32 row also its ms at softcap 50) and every case."""
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.launch.bounds import (ATTENTION_LAYER, BF16_FLOP_PER_S,
                                           GEMMA_WINDOW, attention_bound,
                                           attention_fp32_bound, bound_ms)
    from repro_torch.launch.profile_flash import sdpa_f32

    H, KV, hd = (ATTENTION_LAYER[k] for k in ("heads", "kv_heads", "head_dim"))
    B, S = SERVE_BATCH, SERVE_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(5)

    def inputs(dtype, b=B, s=S, h=H, kv=KV, d=hd):
        return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                     for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))

    def twin(q, k, v, **kw):
        return flash_attention.plain(q, k, v, block=flash_attention.KEY_BLOCK,
                                     p_dtype=torch.bfloat16, **kw)

    cases = {}
    for name, dtype, window, cap in (("bf16 global", torch.bfloat16, 0, 50.0),
                                     ("bf16 local", torch.bfloat16, GEMMA_WINDOW, 50.0),
                                     ("fp32 global", torch.float32, 0, 50.0),
                                     ("bf16 global softcap 0", torch.bfloat16, 0, 0.0),
                                     ("fp32 global softcap 0", torch.float32, 0, 0.0)):
        q, k, v = inputs(dtype)
        kw = dict(window=window, softcap=cap)
        out = ops.flash_attention(q, k, v, **kw)
        ref = flash_attention.plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err, far = flash_close(torch, out, ref, "plain", v)
        if dtype == torch.bfloat16:
            b, f = attention_bound(S, **ATTENTION_LAYER, window=window, batch=B)
            b_ms, b_by = bound_ms(b, f, BF16_FLOP_PER_S)
            beside = "bf16"
        else:
            # one dense TF32 product; the kernel's own three beside, and the
            # float32 CUDA cores' time for the same flops
            fb = attention_fp32_bound(S, **ATTENTION_LAYER, window=window, batch=B)
            b, f, b_ms, b_by = fb["bytes"], fb["flops"], fb["ms"], fb["by"]
            beside = (f"one dense TF32 product; the kernel's three TF32 products "
                      f"{fb['work_tf32_ms']:.4f} ms, the fp32 CUDA cores "
                      f"{fb['fp32_ms']:.4f} ms")
            assert torch.equal(out, ops.flash_attention(q, k, v, **kw))  # two calls
        ms = cuda_ms(torch, lambda: ops.flash_attention(q, k, v, **kw))
        plain_ms = cuda_ms(torch, lambda: flash_attention.plain(q, k, v, **kw), reps=3)
        cases[name] = dict(err=err, far=far, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, tflops=f / ms / 1e9)
        log(f"flash_attention {name} ({B}, {S}, {H}|{KV}, {hd}), window {window}, "
            f"softcap {cap:g}: max |kernel - plain| {err:.3e} ({far} values more than "
            f"one bf16 step apart); kernel {ms:.3f} ms ({f / ms / 1e9:.2f} TFLOP/s), "
            f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, {f / 1e12:.4f} "
            f"TFLOP, {b / 1e6:.1f} MB; {beside})")
        if cap == 0.0 and dtype == torch.float32:
            sdpa, backend = sdpa_f32(q, k, v)
            lib_err = (out - sdpa()).abs().max().item()
            library_ms = cuda_ms(torch, sdpa, reps=5)
            cases[name].update(library_ms=library_ms, library_err=lib_err,
                               library_backend=backend)
            log(f"flash_attention {name}: scaled_dot_product_attention float32 (causal, "
                f"key/value heads repeated, {backend} backend) {library_ms:.4f} ms, the "
                f"kernel {ms / library_ms:.2f}x that; max |kernel - sdpa| {lib_err:.3e} "
                "(limit 2e-5)")
            assert math.isfinite(lib_err) and lib_err <= 2e-5, lib_err
        elif cap == 0.0:
            library_ms, lib_err = sdpa_yardstick(torch, q, k, v, out)
            cases[name].update(library_ms=library_ms, library_err=lib_err)
            log(f"flash_attention {name}: scaled_dot_product_attention (causal, GQA) "
                f"{library_ms:.4f} ms, the kernel {ms / library_ms:.2f}x that; max "
                f"|kernel - sdpa| {lib_err:.3e} (limit 5e-2)")
        if dtype == torch.bfloat16:
            # the twin on these normal inputs: reported (its scores differ in
            # the last bits, so a few p round to the other bf16 neighbour)
            t_err, t_far = flash_close(torch, out, twin(q, k, v, **kw), "report", v)
            q, k = exact_scores(torch, q, k)
            out = ops.flash_attention(q, k, v, **kw)
            x_err, _ = flash_close(torch, out, twin(q, k, v, **kw), "twin", v)
            xp_err, xp_far = flash_close(torch, out, flash_attention.plain(q, k, v, **kw),
                                         "plain", v)
            cases[name].update(twin_err=x_err, exact_plain_err=xp_err,
                               exact_plain_far=xp_far, normal_twin_err=t_err,
                               normal_twin_far=t_far)
            log(f"flash_attention {name}, exact-score inputs: max |kernel - twin| "
                f"{x_err:.3e} (0 values more than one bf16 step apart), max |kernel - "
                f"plain| {xp_err:.3e} ({xp_far} more than one step, all within one "
                f"step + 2^-8 max|v|); normal inputs: max |kernel - twin| {t_err:.3e}, "
                f"{t_far} values more than one step apart")
        del q, k, v, out, ref

    q, k, v = inputs(torch.float32, b=2, s=1000, h=8, kv=1, d=64)
    out = ops.flash_attention(q, k, v, causal=False, softcap=30.0)
    err, _ = flash_close(torch, out, flash_attention.plain(q, k, v, causal=False,
                                                           softcap=30.0), "plain", v)
    log(f"flash_attention fp32 (2, 1000, 8|1, 64), not causal, softcap 30: max "
        f"|kernel - plain| {err:.3e} (limit 2e-5)")
    # the rows: the global layer at softcap 0, the function the library call
    # computes, so that ms and library_ms compare like with like; the float32
    # kernel's launches are those of the float32 serving comparison
    rows = []
    for name, source, dtype in (("flash_attention", "flash_attention_sm90.cu", "bf16"),
                                ("flash_attention_f32", "flash_attention.cu", "fp32")):
        g = cases[f"{dtype} global softcap 0"]
        rows.append(dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{source}",
                         replaces="src/repro/kernels/flash_attention.py:90",
                         max_abs_err=g["err"], ms=g["ms"], plain_ms=g["plain_ms"],
                         bound_ms=g["bound_ms"], bound_by=g["bound_by"],
                         library_ms=g["library_ms"], count="flash_attention"))
    rows[1]["more"] = dict(ms_softcap_50=cases["fp32 global"]["ms"],
                           plain_ms_softcap_50=cases["fp32 global"]["plain_ms"],
                           library_backend=cases["fp32 global softcap 0"]["library_backend"])
    return rows, cases


def sdpa_yardstick(torch, q, k, v, out):
    """``(ms, max |out - library|)`` of ``scaled_dot_product_attention``
    (causal, GQA) on the kernel's inputs, ``out`` the kernel's output at
    softcap 0 and no window."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    lib = sdpa().transpose(1, 2)
    torch.cuda.synchronize()
    # the library rounds its probabilities to bf16 for PV: a yardstick of
    # the function (the bf16 tolerance of tests/test_kernels_flash.py), not
    # a reference of the kernel's rounding
    lib_err = (out.float() - lib.float()).abs().max().item()
    assert math.isfinite(lib_err) and lib_err <= 5e-2, lib_err
    return cuda_ms(torch, sdpa), lib_err


def run_serve_path(torch):
    """Phase 6: the port's ``generate`` at gemma2-2b's full width and depth
    (26 layers, the port's own init, seed 0) on the card: batch 4, prompts
    of 8160 tokens from a seeded generator, 32 greedy tokens, bf16 weights
    and cache; cold, then warm, each with the launch counts set to 0 just
    before and read just after.  Returns the counts, the float32 masters and
    a summary."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate, make_generate_steps
    from repro_torch.models import model as M

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    model = M.init_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                            device="cuda")
    max_len = SERVE_PROMPT + SERVE_GEN + 1
    torch.cuda.reset_peak_memory_stats()
    steps = make_generate_steps(cfg, model, max_len)
    prefill, decode = steps
    runs = {}
    for name in ("cold", "warm"):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill({"tokens": prompts})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        tok = torch.argmax(logits, -1)[:, None]
        t1 = time.perf_counter()
        for _ in range(SERVE_GEN):
            step_logits, cache = decode(cache, tok)
            tok = torch.argmax(step_logits[:, -1], -1)[:, None]
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t1
        counts = ops.launch_counts()
        assert counts == only(flash_attention=cfg.num_layers), counts
        assert torch.isfinite(logits).all() and torch.isfinite(step_logits).all()
        total = t_prefill + t_decode
        runs[name] = dict(prefill_s=t_prefill, decode_ms_per_step=t_decode / SERVE_GEN * 1e3,
                          total_s=total, tokens_per_s=SERVE_BATCH * SERVE_GEN / total,
                          prefill_tokens_per_s=SERVE_BATCH * SERVE_PROMPT / t_prefill)
        log(f"serve {name}: prefill {t_prefill:.3f} s "
            f"({SERVE_BATCH * SERVE_PROMPT / t_prefill:.0f} prompt tokens/s), decode "
            f"{t_decode / SERVE_GEN * 1e3:.2f} ms/step over {SERVE_GEN} steps, "
            f"{SERVE_BATCH * SERVE_GEN / total:.1f} generated tokens/s over the call; "
            f"launches {counts}")
        del logits, cache, step_logits
    peak = torch.cuda.max_memory_allocated() / 2**30
    # generate itself, on the same steps: the same tokens as the timed loop's
    ops.reset_launch_counts()
    toks, cache = generate(cfg, model, prompts, max_len, SERVE_GEN, steps=steps)
    counts = ops.launch_counts()
    assert counts == only(flash_attention=cfg.num_layers), counts
    assert toks.shape == (SERVE_BATCH, SERVE_GEN) and cache["pos"] == max_len - 1
    log(f"serve: gemma2-2b, {n_params / 1e9:.3f} B parameters (init {init_s:.2f} s), "
        f"batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_GEN} tokens, bf16 cache; "
        f"peak device memory {peak:.2f} GiB; generate's launches {counts}; tokens "
        f"{toks[0, :8].tolist()}")
    del steps, prefill, decode, cache
    return counts, model, dict(runs=runs, peak_gib=peak, params=n_params)


def compare_serve_paths(torch, model):
    """Phase 7: at full width and depth, batch 1, an 8160-token prompt and 4
    decode steps, the kernel path against the plain path (the same model
    with the kernels' plain version in their place).  In float32 (weights
    and cache): the prefill logits and each step's logits within 1e-4 of
    the largest, the greedy picks equal.  In bf16 (weights and cache): the
    kernel path's logits within twice the bf16 plain path's own gap to the
    float32 plain logits, at each step (the rule of
    ``tests/test_torch_serve.py``).  The decode steps are fed the prompt's
    own next 4 tokens (teacher forcing), so that each step attends with
    another query: with random weights greedy decoding repeats one token."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.training.steps import make_decode_step, make_prefill_step

    n_dec = 4
    base = get_config(SERVE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, base.vocab_size, (1, SERVE_PROMPT + n_dec), generator=gen,
                           device="cuda")

    def run(dtype, plain):
        """Per-step logits (float32), greedy picks and seconds; the launch
        counts asserted: the layers' flash kernels, or none on the plain path."""
        cfg = dataclasses.replace(base, dtype=dtype, kv_cache_dtype=dtype)
        prefill = make_prefill_step(cfg, model, SERVE_PROMPT + n_dec + 1)
        decode = make_decode_step(cfg, model)
        ops.reset_launch_counts()
        with mock.patch.object(ops, "flash_attention", flash_attention.plain) if plain \
                else contextlib.nullcontext():
            t0 = time.perf_counter()
            logits, cache = prefill({"tokens": tokens[:, :SERVE_PROMPT]})
            out, picks = [logits.float()], [torch.argmax(logits, -1)]
            for i in range(n_dec):
                logits, cache = decode(cache, tokens[:, SERVE_PROMPT + i][:, None])
                out.append(logits[:, -1].float())
                picks.append(torch.argmax(logits[:, -1], -1))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        expected = only() if plain else only(flash_attention=cfg.num_layers)
        assert counts == expected, counts
        return out, torch.stack(picks, 1), seconds, counts

    kern, kern_picks, kern_s, fp32_counts = run("float32", plain=False)
    plain, plain_picks, plain_s, _ = run("float32", plain=True)
    rel = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(kern, plain)]
    log(f"fp32 kernel vs plain path, gemma2-2b full depth, prompt {SERVE_PROMPT}, "
        f"{n_dec} decode steps fed the prompt's next tokens: logits max |diff| / max "
        f"|logit| per step {['%.2e' % r for r in rel]} (limit 1e-4); greedy picks "
        f"kernel {kern_picks.tolist()} plain {plain_picks.tolist()}; "
        f"{kern_s:.3f} s vs {plain_s:.3f} s")
    assert all(math.isfinite(r) and r <= 1e-4 for r in rel), rel
    assert torch.equal(kern_picks, plain_picks)

    kern16, _, kern16_s, _ = run("bfloat16", plain=False)
    plain16, _, plain16_s, _ = run("bfloat16", plain=True)
    errs = [(a - c).abs().max().item() for a, c in zip(kern16, plain)]
    gaps = [(b - c).abs().max().item() for b, c in zip(plain16, plain)]
    log(f"bf16 kernel vs plain path, same prompt and steps: max |logits - fp32 plain| "
        f"per step, kernel path {['%.3e' % e for e in errs]}, bf16 plain path "
        f"{['%.3e' % g for g in gaps]} (limit twice the latter); {kern16_s:.3f} s vs "
        f"{plain16_s:.3f} s")
    assert all(math.isfinite(e) and 0 < g and e <= 2 * g for e, g in zip(errs, gaps)), (
        errs, gaps)
    return dict(rel=rel, kernel_s=kern_s, plain_s=plain_s, bf16_err=errs, bf16_gap=gaps,
                bf16_kernel_s=kern16_s, bf16_plain_s=plain16_s, fp32_counts=fp32_counts)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import PAPER_VOLUMES, make_pair
    from repro_torch.kernels.build import load_library, sass_counts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; device count {torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; cudnn.allow_tf32=False")

    lib = load_library()
    log(f"build: {lib.info.seconds:.2f} s ({lib.info.path.name})")
    for line in lib.info.ptxas:
        log(f"  ptxas {line}")
    # the bf16 flash kernel on the tensor cores: wgmma in its SASS, no spills
    hgmma = sass_counts(lib.info.path, "flash_sm90_kernel", "HGMMA")
    head_dims = (re.search(r"ILi(\d+)E", fn).group(1) for fn in hgmma)
    log("flash_attention_bf16 SASS: " + ", ".join(
        f"hd {hd} {n} HGMMA" for hd, n in zip(head_dims, hgmma.values())))
    assert len(hgmma) == 5 and all(hgmma.values()), hgmma
    assert all("0/0 B spill" in ln for ln in lib.info.ptxas
               if "flash_sm90_kernel" in ln and "registers" in ln), lib.info.ptxas
    # the float32 flash kernel on the tensor cores too: mma.sync TF32 (HMMA)
    hmma = sass_counts(lib.info.path, "flash_tf32_kernel", "HMMA")
    head_dims = (re.search(r"ILi(\d+)E", fn).group(1) for fn in hmma)
    log("flash_attention_f32 SASS: " + ", ".join(
        f"hd {hd} {n} HMMA" for hd, n in zip(head_dims, hmma.values())))
    assert len(hmma) == 5 and all(hmma.values()), hmma
    t0 = time.perf_counter()
    stage_libs = nmi_stage_builds()
    log(f"nmi measurement builds ({', '.join(NMI_STAGES.values())}): "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    fixed, moving, _ = make_pair(PAPER_VOLUMES["phantom1"], seed=0)
    log(f"make_pair(phantom1 {tuple(fixed.shape)}): {time.perf_counter() - t0:.1f} s")

    rows = check_kernels(torch, fixed, moving, lib, stage_libs)
    rows += check_matmul_kernels(torch, fixed, moving, lib, stage_libs)
    rows += check_forward_forms(torch, fixed, lib)
    counts = run_main_path(torch, fixed, moving)
    compare_paths(torch, fixed, moving)
    nmi_counts, nmi_call = run_multimodal(torch, fixed, moving)
    ncc_counts = compare_multimodal_paths(torch, fixed, moving)
    lncc_counts, lncc_call = run_lncc_path(torch, fixed, moving)
    matmul_counts = compare_matmul_paths(torch, fixed, moving)
    form_counts, form_calls = run_forward_form_paths(torch, fixed, moving)
    auto_counts, auto_call = run_auto_path(torch, fixed, moving)
    del fixed, moving
    torch.cuda.empty_cache()  # the NMI backward's ~44 GiB stay cached otherwise
    flash_rows, flash_call = check_flash(torch)
    rows += flash_rows
    serve_counts, model, serve_call = run_serve_path(torch)
    serve_compare = compare_serve_paths(torch, model)
    # each kernel's launches in the run of its own path: SSD, NMI, NCC, the
    # LNCC matrix form at full depth, and the iters=5 paths of the others
    path_counts = {"bsi_fused_stats": nmi_counts, "bsi_fused_nmi": nmi_counts,
                   "bsi_fused_ncc": ncc_counts, "bsi_matmul": lncc_counts,
                   "bsi_adjoint_matmul": lncc_counts,
                   "bsi_fused_lncc_matmul": lncc_counts,
                   "bsi_fused_lncc": matmul_counts["lncc"],
                   "bsi_fused_matmul": matmul_counts["ssd_matmul"],
                   "bsi_fused_stats_matmul": matmul_counts["ncc_matmul"],
                   "bsi_fused_ncc_matmul": matmul_counts["ncc_matmul"],
                   "bsi_fused_nmi_matmul": matmul_counts["nmi_matmul"],
                   "bsi_separable": form_counts["separable"],
                   "bsi_tt": form_counts["tt"],
                   "flash_attention": serve_counts,
                   "flash_attention_f32": serve_compare["fp32_counts"]}
    for r in rows:
        r["launches"] = path_counts.get(r["name"], counts)[r.get("count", r["name"])]
        assert r["launches"] > 0, r
    log(f"nmi call at phantom1: {nmi_call}")
    log("nmi kernel at phantom1: " + "; ".join(f"{r['name']}: {r['nmi']}" for r in rows
                                                if "nmi" in r))
    log(f"lncc matmul call at phantom1: {lncc_call}")
    for mode, call in form_calls.items():
        log(f"{mode} call at phantom1: {call}")
    log(f"auto call at phantom1: {auto_call}; launches {auto_counts}")
    log(f"flash_attention at gemma2-2b's layer: {flash_call}")
    log(f"serve call: {serve_call}")
    log(f"serve paths, kernel vs plain: {serve_compare}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{**{k: r[k] for k in keys}, **r.get("more", {})}
                                  for r in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
