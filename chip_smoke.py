#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and hold every
kernel against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases; any failure raises and the script exits nonzero:

1. the card's name and power limit (nvidia-smi) and the device count;
2. build the kernels from ``src/repro_torch/csrc`` with nvcc, the nmi
   measurement builds and the main pair beside it (build seconds,
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
   ``fused="on"``.  Then the single-pair workflow beyond the defaults
   (``check_jvp``, ``run_workflow_paths``, ``compare_workflow_paths``):
   ``torch.func.jvp`` through the forward kernel against the plain form's;
   ``affine_register`` with its defaults (SSD, Adam, 60 steps), cold and
   warm; ``ffd_register`` of the affine warp with ``transform="velocity",
   regularizer="bending", optimizer="lbfgs", stop=ConvergenceConfig()`` at
   full depth, cold and warm (steps per level, losses, MAE, peak memory,
   whether the two calls' grids are bit-equal, the least Jacobian
   determinant of the field, asserted > 0); Gauss-Newton with the bending
   energy at ``iters=5``, its forward and adjoint launches asserted equal
   to their count (``gauss_newton_launches``: each CG iteration one forward
   on the tangent and one adjoint, the primal linearised once a step); the
   kernels against the plain path at ``iters=5`` for velocity + bending +
   Adam, L-BFGS, Gauss-Newton and Adam under ``stop=`` (losses at 1e-4,
   ``steps`` equal); a small pair with velocity, bending, L-BFGS and
   ``stop``, card against CPU;
1b. compute_dtype="bfloat16", run right after phase 4's main path
   (``check_reduced_forward``, ``run_reduced_path``): the bf16 forward
   kernels ``bsi_ttli_bf16`` and ``bsi_separable_bf16`` at phantom1, tile
   5^3, 3 channels, on a bf16 grid against their plain versions (every value
   within one bf16 step plus the float32 kernels' 1e-5 of the largest
   value, asserted; how many differ, how many by more than a step; two
   calls bit-equal), timed beside the float32 kernel, the 0.0812 ms bound
   and ``conv_transpose3d`` in bf16; then ``ffd_register`` of the main
   path's pair with ``compute_dtype="bfloat16"``, ``ttli / cuda / cuda``,
   ``fused="off"``, ``lr=0.02``, beside the same float32 call (seconds,
   peak memory above the call's start; one call each, the kernels having
   run in the checks before), its launches asserted (the level loops'
   forwards ``bsi_ttli_bf16``, as many as float32's less the final warp's,
   which stays one float32 ``bsi_ttli`` as in the JAX package; the
   adjoint's as float32's), a float32 warp, the JAX package's bf16 bounds
   against float32 (final loss < 1.1x + 1e-4, warp MAE < 5e-3) and this
   card's (1e-2 relative, 1e-4), the per-level losses within 1e-3 relative
   of the plain bf16 path's; ``mode="separable"`` in bf16 counted; the
   share of zeros in one step's bf16 displacement cotangent (printed); a
   small bf16 pair (40 x 32 x 24) card against CPU at 1e-4;
1c. the bf16 fused level step, right after phase 1b
   (``check_reduced_fused_kernels``, ``run_reduced_fused_path``): the five
   fused variants' bf16 kernels (lerp form, bf16 ``phi`` and ``moving``,
   float32 ``fixed``) at phantom1 against their plain versions (ssd, stats,
   ncc on the main pair; nmi at 32 bins and lncc at window 9 on the
   remapped pair; the float32 rows' tolerances; two calls bit-equal;
   registers, no spills, blocks an SM) and ``bsi_adjoint`` on a bf16
   cotangent, asserted bit-equal to the float32 kernel on the widened
   cotangent, each timed beside its float32 kernel, its plain version and
   its bound; then ``ffd_register`` with ``compute_dtype="bfloat16",
   fused="on", lr=0.02`` (``ttli / cuda / cuda``) beside the float32 fused
   call and phase 1b's bf16 unfused one, its launches asserted (a step one
   ``bsi_fused_bf16``, one ``bsi_ttli_bf16`` and one ``bsi_adjoint_bf16``;
   the final warp one float32 ``bsi_ttli``), phase 1b's bounds against
   float32, per-level losses within 1e-3 relative of the plain bf16 fused
   path's; the bf16 fused ncc, nmi and lncc steps at ``iters=5``, counted,
   within 1e-2 of float32's; and ``fused="auto"`` under bf16 raced on a
   fresh cache (its key ``|cd=bfloat16|``);
1d. the bf16 matrix and TT forms, right after phase 1c
   (``check_reduced_matrix_kernels``, ``run_reduced_matrix_path``): at
   phantom1, ``bsi_tt_bf16`` against its plain version bit for bit;
   ``bsi_matmul_bf16`` within one bf16 step plus 1e-5 of the largest value
   of plain and bit-equal to the float32 kernel on the widened grid with
   the bf16 basis's fragments, rounded once; ``bsi_adjoint_matmul_bf16``
   bit-equal to the float32 kernel on the widened cotangent; the five fused
   variants' bf16 kernels in the matrix form (as phase 1c's lerp-form
   rows); each with two calls bit-equal, registers (no spills, asserted),
   blocks an SM, timed beside its float32 kernel, plain version, bound and
   library call.  Then ``ffd_register(compute_dtype="bfloat16",
   mode="matmul", impl="cuda", grad_impl="matmul", lr=0.02)`` with
   ``fused="off"`` and ``"on"`` beside float32, its launches asserted (the
   final warp one float32 ``bsi_matmul``), phase 1b's bounds against
   float32, per-level losses within 1e-3 of the plain bf16 path's;
   ``mode="tt"`` in bf16 at full depth, counted, at the same bounds; the
   matrix form's fused ncc, nmi and lncc steps in bf16 at ``iters=5``
   within 1e-2 of float32's; and all-``"auto"`` under bf16 raced on a
   fresh cache (the four forms);
1e. compute_dtype="float16", right after phase 1d: phases 1b, 1c and 1d's
   checks and paths, the same functions, on the 16 fp16 kernels
   (``run_reduced_phases``), each reduced call beside the float32 call of
   phases 1b-1d, not run again.  Every kernel check is held as under bf16
   (``bsi_tt_f16`` bit for bit, ``bsi_matmul_f16`` to the float32 kernel's
   bits with the fp16 fragments, both adjoints to the float32 kernels' on
   ``g.float()``, the others within one fp16 step plus 1e-5 or at 1e-5
   relative), as are the launches and the per-level losses against the
   plain fp16 paths (1e-3) and the small pair card against CPU (1e-4).
   Printed, not asserted: each fp16 registration's final loss and warp
   against float32, and the share of zeros in one step's fp16
   displacement cotangent at phantom1 (the JAX package's fp16 gradient
   underflows there, the port copies it, and the fp16 registration stays
   near its start; ROADMAP queue 3);
4c. batched and served registration: ``register_batch`` of two phantom1
   pairs (seeds 0 and 1, made on the host while the earlier phases run)
   with ``fused="on"``, cold then warm (seconds, ``compiled``, peak memory,
   launches asserted twice a solo call's), each pair bit-equal to a solo
   ``ffd_register``, and again under ``stop=`` (``steps`` equal, launches the
   solo calls' sum); the ``RegistrationScheduler`` on a stream of phantom1
   (hard), phantom1 against itself (easy), phantom1 seed 1 and porcine1,
   two lanes, chunks of 4, ``lr=0.02`` (see ``run_stream``): latencies,
   makespan, pairs/s; a lane recycled, one stage per level and shape, every
   result bit-equal to its solo call, the launches the solo calls' sum; the
   load generator ``launch/serve_registration.py --smoke``; a small batch,
   card against CPU, each grid within 1e-4 or the CPU's own one-ulp spread;
4d. sharded registration on a one-rank ``torch.distributed`` mesh, NCCL on
   the card (``engine.shard``; see ``run_mesh_paths``): ``register_batch(...,
   mesh=)`` of phase 4c's two pairs, ``fused="on"``, warm and under
   ``stop=``, each asserted bit-equal to phase 4c's unsharded run with the
   same launches; ``sharded_pipeline``'s outputs asserted ``DTensor``s on
   ``Shard(0)`` and their gather timed; the scheduler with ``mesh=`` on
   phase 4c's stream, each result and the launches asserted equal to the
   unsharded stream's; seconds beside phase 4c's and peak memory;
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
   float32 serving path's of phase 6; the ``bsi_ttli`` and ``bsi_adjoint``
   rows add their launches on phase 4's velocity and Gauss-Newton paths and
   on phase 4c's warm batch and stream, and with ``bsi_fused`` on phase 4d's
   sharded batch and stream),
   the nvidia-smi line, and the result line.

Float32 convolutions and matrix products are pinned to full fp32
(``allow_tf32 = False``) so the library yardsticks compute in fp32 too.
"""

import concurrent.futures
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
    return occ


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


def reduced_ulps(torch, out, ref, f32_gap=1e-5):
    """``out`` against ``ref``, both of a reduced dtype (bf16, fp16), each a
    float32 value rounded once: ``(worst, beyond, differ)``.  ``worst`` is
    the largest ``|out - ref|`` over its bound, one step of the dtype at the
    larger magnitude (``core.bspline.reduced_step``) plus ``f32_gap`` of the
    largest value, the most the two float32 values may differ before
    rounding (the float32 kernels' tolerance); ``worst <= 1`` holds every
    value within one step of the other's rounding.  ``beyond``: values more
    than one step apart (only near zero, where the float32 gap exceeds a
    step); ``differ``: values that differ at all."""
    from repro_torch.core.bspline import reduced_step

    a, b = out.float(), ref.float()
    step = reduced_step(torch.maximum(a.abs(), b.abs()), out.dtype)
    diff = (a - b).abs()
    worst = (diff / (step + f32_gap * b.abs().max())).max().item()
    return worst, int((diff > step).sum().item()), int((out != ref).sum().item())


def reduced_yardstick(torch, phi, vol):
    """``conv_transpose3d`` in ``phi``'s reduced dtype computing the forward
    BSI of ``phi`` cropped to ``vol``, channels last (cuDNN; its rounding is
    its own, so it is timed, not compared)."""
    import torch.nn.functional as F

    c = phi.shape[3]
    K = conv_kernel(torch, TILE, c, phi.device).to(phi.dtype)
    phi_cf = phi.permute(3, 0, 1, 2).unsqueeze(0).contiguous()
    (dx, dy, dz), (X, Y, Z) = TILE, vol

    def forward():
        full = F.conv_transpose3d(phi_cf, K, stride=TILE, groups=c)
        return full[0, :, 3 * dx:3 * dx + X, 3 * dy:3 * dy + Y, 3 * dz:3 * dz + Z]

    return lambda: forward().permute(1, 2, 3, 0)


def reduced_adjoint_yardstick(torch, g, tile):
    """``conv3d`` in ``g``'s reduced dtype computing the adjoint of the
    cotangent ``g`` (cuDNN; a result of the dtype, so it is timed, not
    compared)."""
    import torch.nn.functional as F

    X, Y, Z, c = g.shape
    full = [-(-s // d) * d for s, d in zip((X, Y, Z), tile)]
    K = conv_kernel(torch, tile, c, g.device).to(g.dtype)
    g_cf = torch.zeros([1, c] + full, dtype=g.dtype, device=g.device)
    g_cf[0, :, :X, :Y, :Z] = g.permute(3, 0, 1, 2)
    return lambda: F.conv3d(g_cf, K, stride=tile, padding=tuple(3 * d for d in tile),
                            groups=c)[0].permute(1, 2, 3, 0)


def ptxas_occupancy(lib, symbol, smem):
    """The ptxas line of the one kernel named by ``symbol`` (asserted: no
    spills) and its resident blocks an SM at ``smem`` bytes a block of 256
    threads (``launch/profile_forward.py``)."""
    from repro_torch.launch.profile_forward import kernel_occupancy

    occ = kernel_occupancy(lib, symbol, smem, None)
    assert "0/0 B spill" in occ["registers"], occ["registers"]
    return occ["registers"], occ["blocks_per_sm"]


def reduced_row(torch, rows, name, err, call, call32, plain, bound, replaces, source,
                library_ms=None, **more):
    """A reduced dtype's kernel's row of the kernels line: ``call`` (the
    kernel), ``call32`` (its float32 kernel on the float32 inputs) and
    ``plain`` timed; ``call`` counted once under ``name`` before
    (asserted)."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    call()
    assert ops.launch_counts()[name] == 1, (name, ops.launch_counts())
    b_ms, b_by = bound
    r = dict(name=name, route="cuda", source=source, replaces=replaces,
             max_abs_err=err, ms=cuda_ms(torch, call),
             plain_ms=cuda_ms(torch, plain, reps=3), bound_ms=b_ms, bound_by=b_by,
             library_ms=library_ms,
             more=dict(float32_kernel_ms=cuda_ms(torch, call32), **more))
    log(f"{name}: kernel {r['ms']:.4f} ms (float32 kernel "
        f"{r['more']['float32_kernel_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), library "
        f"{'-' if library_ms is None else format(library_ms, '.4f')} ms")
    rows.append(r)


def same_twice(torch, call):
    """Two calls of ``call`` bit-equal."""
    a, b = call(), call()
    torch.cuda.synchronize()
    return torch.equal(a, b)


def dtype_suffix(dtype):
    """The kernels' name suffix of ``dtype``: ``f32``, ``bf16``, ``f16``."""
    from repro_torch.kernels.bsi_ttli import ENTRY_SUFFIX

    return ENTRY_SUFFIX[dtype]


FUSED_SRC, FUSED_REP = "src/repro_torch/csrc/bsi_fused.cu", "src/repro/kernels/bsi_fused.py:291"
# the mangled element type in the adjoint stream kernel's instantiation
MANGLED = {"bf16": "13__nv_bfloat16", "f16": "6__half"}


def reduced_grid(torch, fixed, dtype, seed):
    """A seeded float32 grid of |values| ~2.5 voxels at phantom1, tile 5^3,
    and the same rounded to ``dtype``."""
    from repro_torch.core import ffd

    gshape = ffd.grid_shape_for_volume(tuple(fixed.shape), TILE)
    gen = torch.Generator(device=fixed.device).manual_seed(seed)
    phi32 = torch.randn(gshape + (3,), generator=gen, device=fixed.device) * 2.5
    return phi32, phi32.to(dtype)


def reduced_fused_inputs(torch, fixed, moving, dtype):
    """Phases 1c-1e: the float32 grid of the reduced fused rows (seed 6),
    the reduced cotangent's float32 source, and the grid, moving volume,
    cotangent and remapped moving volume in ``dtype``."""
    from repro_torch.core import ffd

    dev = fixed.device
    vol = tuple(fixed.shape)
    gshape = ffd.grid_shape_for_volume(vol, TILE)
    gen = torch.Generator(device=dev).manual_seed(6)
    phi32 = torch.randn(gshape + (3,), generator=gen, device=dev) * 1.0
    g32 = torch.randn(vol + (3,), generator=gen, device=dev) * 1e-3
    return (phi32, g32, phi32.to(dtype), moving.to(dtype), g32.to(dtype),
            remap(moving).to(dtype))


def check_reduced_fused_variants(torch, fixed, moving, lib, form, rows, dtype):
    """Phases 1c-1e: the five fused variants' kernels of the reduced
    ``dtype`` in displacement form ``form`` at phantom1, tile 5^3, on a
    ``phi`` and ``moving`` of the dtype and a float32 ``fixed`` (ssd, stats
    and ncc on the main path's pair, nmi at 32 bins and lncc at window 9 on
    the multi-modal pair) against their plain versions on the same inputs:
    the sums at 1e-5 relative, stats' min, max and count exact, the nmi
    histogram at 1e-5 of its largest cell and its loss at 1e-5, lncc's count
    exact.  Two calls of each bit-equal, registers with no spills
    (asserted), shared memory and blocks an SM; each timed beside its
    float32 kernel on the float32 inputs, its plain version and its bound
    (``launch/bounds.py``: 2-byte ``phi`` and ``moving``; the matrix form's
    ssd, stats and ncc with their 0.516 ms floor of unfused instructions
    beside).  Appends the rows to ``rows``."""
    from repro_torch.kernels import bsi_fused, ops
    from repro_torch.launch.bounds import bound_ms, kernel_bounds, nmi_bound, unfused_floor_ms

    vol = tuple(fixed.shape)
    phi32, _, phi, mov, _, rem = reduced_fused_inputs(torch, fixed, moving, dtype)
    rem32 = remap(moving)
    n = moving.numel()
    sx = dtype_suffix(dtype)
    f = bsi_fused.DISP_FORMS.index(form)
    mm = form == "matmul"
    key = f"_matmul_{sx}" if mm else f"_{sx}"
    bounds = {k: bound_ms(*v) for k, v in kernel_bounds(vol, TILE, 3).items()}
    floor = dict(unfused_floor_ms=unfused_floor_ms(vol)) if mm else {}
    replaces = FUSED_REP + (" (disp_form='matmul', :87-89)" if mm else "")
    kw = dict(disp_form=form)

    def name(kind):
        return ops._fused_name(kind, form, dtype)

    def row(nm, err, call, call32, plain, bound, **more):
        reduced_row(torch, rows, nm, err, call, call32, plain, bound, replaces, FUSED_SRC,
                    **more)

    # --- the ssd, stats and ncc walks on the main path's pair
    out = ops.fused_ssd_loss(phi, mov, fixed, TILE, **kw)
    ref = bsi_fused.plain(phi, mov, fixed, TILE, **kw) / n
    err = abs(out.item() - ref.item())
    rel = err / abs(ref.item())
    log(f"{name('ssd')}: kernel {out.item():.9g} plain {ref.item():.9g} relative "
        f"{rel:.3e} (limit 1e-5); float32 kernel on the float32 inputs "
        f"{ops.fused_ssd_loss(phi32, moving, fixed, TILE, **kw).item():.9g}")
    assert math.isfinite(rel) and rel <= 1e-5, rel
    log_walk(torch, lib, name("ssd"), lambda: ops.fused_ssd_loss(phi, mov, fixed, TILE, **kw),
             vol)
    row(name("ssd"), err, lambda: ops.fused_ssd_loss(phi, mov, fixed, TILE, **kw),
        lambda: ops.fused_ssd_loss(phi32, moving, fixed, TILE, **kw),
        lambda: bsi_fused.plain(phi, mov, fixed, TILE, **kw),
        bounds[f"bsi_fused_ssd{key}"], **floor)

    out = ops.fused_stats(phi, mov, TILE, **kw)
    st = bsi_fused.plain_stats(phi, mov, TILE, **kw)
    rel = abs(out[0].item() - st[0].item()) / abs(st[0].item())
    log(f"{name('stats')}: kernel {out.tolist()} plain {st.tolist()}; sum relative "
        f"{rel:.3e} (limit 1e-5); min, max, count exact: {torch.equal(out[1:], st[1:])}")
    assert torch.equal(out[1:], st[1:]) and out[3].item() == n, (out, st)
    assert math.isfinite(rel) and rel <= 1e-5, rel
    log_walk(torch, lib, name("stats"), lambda: ops.fused_stats(phi, mov, TILE, **kw), vol)
    row(name("stats"), (out - st).abs().max().item(),
        lambda: ops.fused_stats(phi, mov, TILE, **kw),
        lambda: ops.fused_stats(phi32, moving, TILE, **kw),
        lambda: bsi_fused.plain_stats(phi, mov, TILE, **kw),
        bounds[f"bsi_fused_stats{key}"], **floor)

    scal = torch.stack([st[0] / n, fixed.mean()])
    out = ops.fused_ncc_moments(phi, mov, fixed, scal, TILE, **kw)
    mom = bsi_fused.plain_ncc(phi, mov, fixed, scal, TILE, **kw)
    err = (out - mom).abs().max().item()
    rel = err / mom.abs().max().item()
    log(f"{name('ncc')}: moments kernel {out.tolist()} plain {mom.tolist()}; "
        f"relative {rel:.3e} (limit 1e-5)")
    assert math.isfinite(rel) and rel <= 1e-5, rel
    log_walk(torch, lib, name("ncc"),
             lambda: ops.fused_ncc_moments(phi, mov, fixed, scal, TILE, **kw), vol)
    row(name("ncc"), err, lambda: ops.fused_ncc_moments(phi, mov, fixed, scal, TILE, **kw),
        lambda: ops.fused_ncc_moments(phi32, moving, fixed, scal, TILE, **kw),
        lambda: bsi_fused.plain_ncc(phi, mov, fixed, scal, TILE, **kw),
        bounds[f"bsi_fused_ncc{key}"], **floor)

    # --- nmi (32 bins) and lncc (window 9) on the multi-modal pair
    st = bsi_fused.plain_stats(phi, rem, TILE, **kw)
    scal = torch.stack([st[1], st[2], fixed.min(), fixed.max()])
    nk = dict(bins=32, sigma=0.5 / 31, eps=1e-8, **kw)  # nmi()'s defaults
    out = ops.fused_nmi_histogram(phi, rem, fixed, scal, TILE, **nk)
    ref = bsi_fused.plain_nmi(phi, rem, fixed, scal, TILE, **nk)
    err = (out - ref).abs().max().item()
    rel_cell = err / ref.abs().max().item()
    spec = ("nmi", 32, 0.5, 1e-8)
    loss = ops.fused_similarity_loss(phi, rem, fixed, TILE, sim_spec=spec, **kw).item()
    loss_ref = ops.two_pass_loss(spec, phi, rem, fixed, TILE, **plain_passes(), **kw).item()
    loss_rel = abs(loss - loss_ref) / abs(loss_ref)
    again = same_twice(torch, lambda: ops.fused_nmi_histogram(phi, rem, fixed, scal, TILE,
                                                              **nk))
    blocks = bsi_fused.block_tiles(TILE, form, bsi_fused.nmi_smem_bytes(32))
    smem = bsi_fused._disp_smem_bytes(TILE, blocks, form) + bsi_fused.nmi_smem_bytes(32)
    line, per_sm = ptxas_occupancy(lib, f"bsi_fused_nmi_{sx}_kernelILi{f}ELi32EE", smem)
    support, evaluated, products = nmi_work(torch, phi, rem, fixed, scal, 32, 0.5 / 31, form)
    nb = nmi_bound(vol, TILE, 32, evaluated=evaluated, products=products, suffix=f"_{sx}")
    log(f"{name('nmi')}: histogram max |kernel - plain| {err:.3e}, relative to the "
        f"largest cell {rel_cell:.3e} (limit 1e-5); loss kernel {loss:.9g} plain "
        f"{loss_ref:.9g} relative {loss_rel:.3e} (limit 1e-5); two calls bit-equal: "
        f"{again}; {line}; {smem} B of shared memory a block, {per_sm} blocks an SM; "
        f"bound {nb['ms']:.4f} ms ({nb['by']}, {nb['form']}) from {evaluated} weights "
        f"and {products} non-zero products (support +-{support})")
    assert math.isfinite(rel_cell) and rel_cell <= 1e-5, rel_cell
    assert math.isfinite(loss_rel) and loss_rel <= 1e-5 and again, (loss_rel, again)
    row(name("nmi"), err, lambda: ops.fused_nmi_histogram(phi, rem, fixed, scal, TILE, **nk),
        lambda: ops.fused_nmi_histogram(phi32, rem32, fixed, scal, TILE, **nk),
        lambda: bsi_fused.plain_nmi(phi, rem, fixed, scal, TILE, **nk), (nb["ms"], nb["by"]),
        bound_form=nb["form"], blocks_per_sm=per_sm)

    lk = dict(window=9, eps=1e-5, **kw)
    out = ops.fused_lncc(phi, rem, fixed, TILE, **lk)
    ref = bsi_fused.plain_lncc(phi, rem, fixed, TILE, **lk)
    err = abs(out[0].item() - ref[0].item())
    rel = err / abs(ref[0].item())
    npos = math.prod(s - 8 for s in vol)
    again = same_twice(torch, lambda: ops.fused_lncc(phi, rem, fixed, TILE, **lk))
    own, _ = bsi_fused.lncc_blocks(TILE, 9, form, vol)
    smem = bsi_fused._lncc_smem_bytes(TILE, own, 9, form)
    line, per_sm = ptxas_occupancy(lib, f"bsi_fused_lncc_{sx}_kernelILi{f}ELi9EE", smem)
    log(f"{name('lncc')}: sum cc kernel {out[0].item():.9g} plain "
        f"{ref[0].item():.9g} relative {rel:.3e} (limit 1e-5); count "
        f"{out[1].item():.0f} (VALID positions {npos}); two calls bit-equal: {again}; "
        f"{line}; column {own} tiles, {smem} B of shared memory a block, {per_sm} blocks "
        "an SM")
    assert math.isfinite(rel) and rel <= 1e-5 and again, (rel, again)
    assert out[1].item() == ref[1].item() == npos, (out, ref)
    row(name("lncc"), err, lambda: ops.fused_lncc(phi, rem, fixed, TILE, **lk),
        lambda: ops.fused_lncc(phi32, rem32, fixed, TILE, **lk),
        lambda: bsi_fused.plain_lncc(phi, rem, fixed, TILE, **lk),
        bounds[f"bsi_fused_lncc{key}"], blocks_per_sm=per_sm)


def check_reduced_forward(torch, fixed, lib, dtype):
    """Phases 1b (a) and 1e: the TTLI and separable forward kernels of the
    reduced ``dtype`` at phantom1, tile 5^3, 3 channels, against their plain
    versions on the same grid of the dtype: every value within one step of
    the dtype plus 1e-5 of the largest value (asserted: the float32 sums of
    kernel and plain may differ that much before their one rounding), how
    many differ at all, two calls bit-equal (asserted), registers with no
    spills; each timed beside the float32 kernel on the float32 grid, the
    bound and ``conv_transpose3d`` in the dtype."""
    from repro_torch.kernels import bsi_separable, bsi_ttli, ops
    from repro_torch.launch.bounds import bound_ms, kernel_bounds

    vol = tuple(fixed.shape)
    sx = f"_{dtype_suffix(dtype)}"
    phi32, phi = reduced_grid(torch, fixed, dtype, seed=5)
    # the same function for both kernels, so timed once (cuDNN's reduced
    # transposed conv is slow: 3 calls after one warm-up)
    library_ms = cuda_ms(torch, reduced_yardstick(torch, phi, vol), reps=3, warmup=1)
    bounds = {k: bound_ms(*v) for k, v in kernel_bounds(vol, TILE, 3).items()}
    rows = []
    for stem, module, kernel, replaces in (
            ("bsi_ttli", bsi_ttli, ops.bsi_ttli, "src/repro/kernels/bsi_ttli.py:72"),
            ("bsi_separable", bsi_separable, ops.bsi_separable,
             "src/repro/kernels/bsi_separable.py:70")):
        name = stem + sx
        ops.reset_launch_counts()
        out, again = kernel(phi, TILE, vol), kernel(phi, TILE, vol)
        assert ops.launch_counts()[name] == 2, ops.launch_counts()
        ref = module.plain(phi, TILE, vol)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == vol + (3,), out.dtype
        worst, beyond, differ = reduced_ulps(torch, out, ref)
        same = torch.equal(out, again)
        err = (out.float() - ref.float()).abs().max().item()
        f32_err = (out.float() - module.plain(phi32, TILE, vol)).abs().max().item()
        log(f"{name}: max |kernel - plain| {err:.3e}; against one step + 1e-5 of the "
            f"largest value {worst:.3f} (limit 1); {differ} of {out.numel()} values "
            f"differ, {beyond} by more than one step; two calls bit-equal: {same}; "
            f"max |kernel - float32 plain on the float32 grid| {f32_err:.3e}")
        assert math.isfinite(worst) and worst <= 1.0 and same, (worst, same)
        del out, again, ref
        occ = log_forward_occupancy(lib, name, vol)
        reduced_row(torch, rows, name, err, lambda k=kernel: k(phi, TILE, vol),
                    lambda k=kernel: k(phi32, TILE, vol),
                    lambda m=module: m.plain(phi, TILE, vol), bounds[name], replaces,
                    f"src/repro_torch/csrc/{stem}.cu", library_ms=library_ms,
                    values_differing=differ, values_beyond_one_step=beyond,
                    worst_over_bound=worst, blocks_per_sm=occ["blocks_per_sm"])
    return rows


def check_reduced_fused_kernels(torch, fixed, moving, lib, dtype):
    """Phases 1c (a) and 1e: the kernels of the reduced ``dtype``'s fused
    level step at phantom1, tile 5^3, against their plain versions on the
    same inputs: ``bsi_adjoint`` on a cotangent of the dtype, bit-equal to
    the float32 kernel on the widened cotangent and at 1e-5 relative of its
    plain version, two calls bit-equal, registers with no spills
    (asserted), shared memory and blocks an SM, timed beside the float32
    kernel, its plain version, its bound and ``conv3d`` in the dtype; then
    the five fused variants in the lerp form
    (:func:`check_reduced_fused_variants`)."""
    from repro_torch.core import ffd
    from repro_torch.kernels import bsi_adjoint, ops
    from repro_torch.launch.bounds import bound_ms, kernel_bounds
    from repro_torch.launch.profile_adjoint import kernel_occupancy as adjoint_occupancy

    dev = fixed.device
    vol = tuple(fixed.shape)
    sx = dtype_suffix(dtype)
    gshape = ffd.grid_shape_for_volume(vol, TILE)
    _, g32, _, _, g, _ = reduced_fused_inputs(torch, fixed, moving, dtype)
    bounds = {k: bound_ms(*v) for k, v in kernel_bounds(vol, TILE, 3).items()}
    rows = []

    # --- bsi_adjoint on a cotangent of the dtype
    log(f"the {sx} cotangent of the adjoint rows: {(g == 0).float().mean().item():.4f} of "
        f"its values zero, "
        f"{(g.float().abs() < torch.finfo(dtype).smallest_normal).float().mean().item():.4f}"
        " subnormal or zero")
    out, out32 = ops.bsi_adjoint(g, TILE, gshape), ops.bsi_adjoint(g.float(), TILE, gshape)
    ref = bsi_adjoint.plain(g, TILE, gshape)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    bits = torch.equal(out, out32)
    again = same_twice(torch, lambda: ops.bsi_adjoint(g, TILE, gshape))
    geo = bsi_adjoint.stream_blocks(TILE, 3, vol, bsi_adjoint.card_sms(dev))
    (line, per_sm), = (v for k, v in adjoint_occupancy(lib, TILE, 3, vol).items()
                       if f"ILi3ELi5E{MANGLED[sx]}" in k)
    log(f"bsi_adjoint_{sx}: out {out.dtype}; bit-equal to the float32 kernel on "
        f"g.float(): {bits}; max |kernel - plain| {err:.3e}, relative {rel:.3e} (limit "
        f"1e-5); two calls bit-equal: {again}; {line}; {geo.smem} B of shared memory a "
        f"block (the float32 kernel's), {per_sm} blocks an SM")
    assert out.dtype == torch.float32 and bits and again, (bits, again)
    assert math.isfinite(rel) and rel <= 1e-5, rel
    del out, out32, ref
    # the cast the backward would make before a float32 kernel: the
    # cotangent widened to float32 (270 MB read, 539 MB written at phantom1)
    widen_ms = cuda_ms(torch, lambda: g.float())
    reduced_row(torch, rows, f"bsi_adjoint_{sx}", err,
                lambda: ops.bsi_adjoint(g, TILE, gshape),
                lambda: ops.bsi_adjoint(g32, TILE, gshape),
                lambda: bsi_adjoint.plain(g, TILE, gshape),
                bounds[f"bsi_adjoint_separable_{sx}"], "src/repro/kernels/bsi_adjoint.py:125",
                "src/repro_torch/csrc/bsi_adjoint.cu",
                library_ms=cuda_ms(torch, reduced_adjoint_yardstick(torch, g, TILE), reps=3,
                                   warmup=1),
                bit_equal_to_float32_kernel=bits, widening_cast_ms=widen_ms,
                blocks_per_sm=per_sm)
    log(f"bsi_adjoint_{sx}: the cotangent's widening cast it replaces {widen_ms:.4f} ms")

    check_reduced_fused_variants(torch, fixed, moving, lib, "lerp", rows, dtype)
    return rows


def check_reduced_matrix_kernels(torch, fixed, moving, lib, dtype):
    """Phases 1d (a) and 1e: the matrix and TT forms' kernels of the reduced
    ``dtype`` at phantom1, tile 5^3, 3 channels, against their plain
    versions on the same inputs: ``bsi_tt`` bit for bit; ``bsi_matmul``
    within one step of the dtype plus 1e-5 of the largest value and
    bit-equal to the float32 kernel on the widened grid with the dtype's
    basis fragments, rounded once; ``bsi_adjoint_matmul`` bit-equal to the
    float32 kernel on the widened cotangent and at 1e-5 relative of its
    plain version; the five fused variants in the matrix form
    (:func:`check_reduced_fused_variants`).  Two calls of each bit-equal,
    registers with no spills (asserted), shared memory and blocks an SM;
    each timed beside its float32 kernel, its plain version, its bound and,
    for the forwards and the adjoint, the library call (``conv_transpose3d``
    and ``conv3d`` in the dtype)."""
    from repro_torch.core import ffd
    from repro_torch.device import resident_blocks
    from repro_torch.kernels import bsi_adjoint, bsi_matmul, bsi_tt, ops
    from repro_torch.launch.bounds import bound_ms, kernel_bounds, unfused_floor_ms

    dev = fixed.device
    vol = tuple(fixed.shape)
    sx = dtype_suffix(dtype)
    gshape = ffd.grid_shape_for_volume(vol, TILE)
    phi32, phi = reduced_grid(torch, fixed, dtype, seed=7)
    bounds = {k: bound_ms(*v) for k, v in kernel_bounds(vol, TILE, 3).items()}
    library_ms = cuda_ms(torch, reduced_yardstick(torch, phi, vol), reps=3, warmup=1)
    rows = []

    # --- bsi_tt: bit for bit its plain version
    out, again = ops.bsi_tt(phi, TILE, vol), ops.bsi_tt(phi, TILE, vol)
    ref = bsi_tt.plain(phi, TILE, vol)
    torch.cuda.synchronize()
    bits, same = torch.equal(out, ref), torch.equal(out, again)
    symbol, smem, grid = bsi_tt.occupancy_key(TILE, 3, vol, bsi_adjoint.card_sms(dev),
                                              dtype=dtype)
    line, per_sm = ptxas_occupancy(lib, symbol, smem)
    log(f"bsi_tt_{sx}: out {out.dtype}; equal to plain bit for bit: {bits}; two calls "
        f"bit-equal: {same}; {line}; {smem} B of shared memory a block, {per_sm} blocks "
        f"an SM, grid {grid}")
    assert out.dtype == dtype and bits and same, (bits, same)
    del out, again, ref
    reduced_row(torch, rows, f"bsi_tt_{sx}", 0.0, lambda: ops.bsi_tt(phi, TILE, vol),
                lambda: ops.bsi_tt(phi32, TILE, vol), lambda: bsi_tt.plain(phi, TILE, vol),
                bounds[f"bsi_tt_{sx}"], "src/repro/kernels/bsi_tt.py:58",
                "src/repro_torch/csrc/bsi_tt.cu", library_ms=library_ms,
                unfused_floor_ms=unfused_floor_ms(vol), blocks_per_sm=per_sm)

    # --- bsi_matmul: one step of plain; the float32 kernel's hi products on
    # the widened grid, rounded once
    out, again = ops.bsi_matmul(phi, TILE, vol), ops.bsi_matmul(phi, TILE, vol)
    ref = bsi_matmul.plain(phi, TILE, vol)
    frag = bsi_matmul.basis_fragments
    bsi_matmul.basis_fragments = lambda t, d, dt=torch.float32: frag(t, d, dtype)
    try:
        wide = ops.bsi_matmul(phi.float(), TILE, vol).to(dtype)
    finally:
        bsi_matmul.basis_fragments = frag
    torch.cuda.synchronize()
    worst, beyond, differ = reduced_ulps(torch, out, ref)
    bits, same = torch.equal(out, wide), torch.equal(out, again)
    err = (out.float() - ref.float()).abs().max().item()
    symbol, smem, grid = bsi_matmul.occupancy_key(TILE, 3, vol, bsi_adjoint.card_sms(dev),
                                                  dtype=dtype)
    line, per_sm = ptxas_occupancy(lib, symbol, smem)
    log(f"bsi_matmul_{sx}: max |kernel - plain| {err:.3e}; against one step + 1e-5 of the "
        f"largest value {worst:.3f} (limit 1); {differ} of {out.numel()} values differ, "
        f"{beyond} by more than one step; bit-equal to {sx} of the float32 kernel on "
        f"phi.float() with the {sx} fragments: {bits}; two calls bit-equal: {same}; "
        f"{line}; {smem} B of shared memory a block, {per_sm} blocks an SM, grid {grid}")
    assert out.dtype == dtype and math.isfinite(worst) and worst <= 1.0
    assert bits and same, (bits, same)
    del out, again, ref, wide
    reduced_row(torch, rows, f"bsi_matmul_{sx}", err, lambda: ops.bsi_matmul(phi, TILE, vol),
                lambda: ops.bsi_matmul(phi32, TILE, vol),
                lambda: bsi_matmul.plain(phi, TILE, vol), bounds[f"bsi_matmul_{sx}"],
                "src/repro/kernels/bsi_matmul.py:91", "src/repro_torch/csrc/bsi_matmul.cu",
                library_ms=library_ms, values_differing=differ,
                values_beyond_one_step=beyond, worst_over_bound=worst,
                bit_equal_to_float32_kernel=bits, blocks_per_sm=per_sm)

    # --- bsi_adjoint_matmul: the float32 kernel on g.float(), bit for bit
    _, g32, _, _, g, _ = reduced_fused_inputs(torch, fixed, moving, dtype)
    out = ops.bsi_adjoint_matmul(g, TILE, gshape)
    out32 = ops.bsi_adjoint_matmul(g.float(), TILE, gshape)
    ref = bsi_adjoint.plain_matmul(g, TILE, gshape)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    bits = torch.equal(out, out32)
    again = same_twice(torch, lambda: ops.bsi_adjoint_matmul(g, TILE, gshape))
    geo = bsi_adjoint.matmul_blocks(TILE, 3, vol)
    regs = [ln for ln in lib.info.ptxas if "registers" in ln
            and f"adjoint_matmul_box_{sx}_kernelILi{geo.cols}E" in ln]
    assert len(regs) == 1 and "0/0 B spill" in regs[0], regs
    per_sm = resident_blocks(int(re.search(r"(\d+) registers", regs[0]).group(1)),
                             geo.smem, 2 * geo.cols)
    log(f"bsi_adjoint_matmul_{sx}: out {out.dtype}; bit-equal to the float32 kernel on "
        f"g.float(): {bits}; max |kernel - plain| {err:.3e}, relative {rel:.3e} (limit "
        f"1e-5); two calls bit-equal: {again}; {regs[0]}; {geo.smem} B of shared memory a "
        f"block (the float32 kernel's), {per_sm} blocks an SM")
    assert out.dtype == torch.float32 and bits and again, (bits, again)
    assert math.isfinite(rel) and rel <= 1e-5, rel
    del out, out32, ref
    widen_ms = cuda_ms(torch, lambda: g.float())
    reduced_row(torch, rows, f"bsi_adjoint_matmul_{sx}", err,
                lambda: ops.bsi_adjoint_matmul(g, TILE, gshape),
                lambda: ops.bsi_adjoint_matmul(g32, TILE, gshape),
                lambda: bsi_adjoint.plain_matmul(g, TILE, gshape),
                bounds[f"bsi_adjoint_matmul_{sx}"], "src/repro/kernels/bsi_adjoint.py:194",
                "src/repro_torch/csrc/bsi_adjoint.cu",
                library_ms=cuda_ms(torch, reduced_adjoint_yardstick(torch, g, TILE), reps=3,
                                   warmup=1),
                bit_equal_to_float32_kernel=bits, widening_cast_ms=widen_ms,
                blocks_per_sm=per_sm)
    log(f"bsi_adjoint_matmul_{sx}: the cotangent's widening cast it replaces "
        f"{widen_ms:.4f} ms")

    check_reduced_fused_variants(torch, fixed, moving, lib, "matmul", rows, dtype)
    return rows


def counted_call(torch, label, fixed, moving, opts, want=None):
    """``ffd_register(fixed, moving, options=opts)``, its launches asserted
    equal to ``want`` where given: the result, its launches, and its
    seconds and peak memory above the call's start."""
    from repro_torch import ffd_register
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    res = ffd_register(fixed, moving, options=opts)
    got = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    log(f"{label}: {res.seconds:.3f} s, {peak:.2f} GiB above the call's start; losses "
        f"{res.losses}; launches { {k: v for k, v in got.items() if v} }")
    assert want is None or got == want, (label, got, want)
    return res, got, dict(seconds=res.seconds, peak_gib=peak)


def float32_twin(torch, twins, label, fixed, moving, opts, want=None):
    """The float32 call ``label`` that a reduced call is held against: run
    and counted (:func:`counted_call`) the first time and kept in
    ``twins``, so that phase 1e's fp16 calls share phases 1b-1d's."""
    if label not in twins:
        twins[label] = counted_call(torch, f"float32 {label}", fixed, moving, opts, want)
    return twins[label]


def held(dtype):
    """Whether the reduced ``dtype``'s registrations at phantom1 are held to
    float32's (bf16), or their distance printed only (fp16: the JAX
    package's fp16 cotangent underflows there, the port copies it, and the
    registration barely leaves its start; ROADMAP queue 3)."""
    return dtype_suffix(dtype) == "bf16"


def against_float32(torch, fixed, moving, label, res, res32, dtype):
    """A reduced call's result ``res`` against its float32 twin ``res32``:
    a finite float32 warp and grid (asserted); the final loss's distance and
    the warp's MAE from float32's, held under bf16 (:func:`held`) to the JAX
    package's bounds (final loss < 1.1x + 1e-4, warp MAE < 5e-3), which a
    path that never optimised would also meet at phantom1, and so to limits
    set from the H100's readings (final loss within 1e-2 relative, measured
    6e-4; warp MAE < 1e-4, measured 5.5e-6); printed under fp16."""
    from repro_torch.core import metrics

    assert res.warped.dtype == res.params.dtype == torch.float32
    assert torch.isfinite(res.warped).all() and torch.isfinite(res.params).all()
    mae = (res.warped - res32.warped).abs().mean().item()
    rel = abs(res.losses[-1] - res32.losses[-1]) / abs(res32.losses[-1])
    mae0, mae1 = metrics.mae(moving, fixed).item(), metrics.mae(res.warped, fixed).item()
    log(f"{label}: final loss {res.losses[-1]:.6e} vs float32 {res32.losses[-1]:.6e}, "
        f"relative {rel:.3e}; warp MAE against float32 {mae:.3e} ("
        + ("limits 1.1x + 1e-4 and 1e-2 relative, 5e-3 and 1e-4" if held(dtype)
           else "printed, not held") + f"); MAE to fixed {mae0:.6f} -> {mae1:.6f}")
    if held(dtype):
        assert res.losses[-1] < 1.1 * res32.losses[-1] + 1e-4, (res.losses, res32.losses)
        assert mae < 5e-3 and rel < 1e-2 and mae < 1e-4, (mae, rel)
    return dict(losses=res.losses, float32_losses=res32.losses,
                final_loss_rel_vs_float32=rel, warp_mae_vs_float32=mae, mae=(mae0, mae1))


def plain_ssd(phi, mov, fix, tile, *, sim_spec, disp_form="lerp"):
    """The fused SSD forward on the ssd kernel's plain version."""
    from repro_torch.kernels import bsi_fused

    assert sim_spec == ("ssd",), sim_spec
    return bsi_fused.plain(phi, mov, fix, tile, disp_form=disp_form) / mov.numel()


def against_plain(torch, fixed, moving, label, res, opts):
    """``opts``' plain path (``impl="torch"``, no launch, asserted; a fused
    step's forward on the ssd kernel's plain version): the per-level losses
    of the kernel path's result ``res`` within 1e-3 relative of it
    (asserted)."""
    from repro_torch import ffd_register
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    real = ops.fused_similarity_loss
    if opts.fused == "on":
        ops.fused_similarity_loss = plain_ssd
    try:
        plain = ffd_register(fixed, moving, options=opts.replace(impl="torch",
                                                                 grad_impl="torch"))
    finally:
        ops.fused_similarity_loss = real
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    rel = max(abs(a - b) / abs(b) for a, b in zip(res.losses, plain.losses))
    log(f"{label}: kernels {res.losses} plain {plain.losses} max relative {rel:.3e} "
        f"(limit 1e-3); {res.seconds:.3f} s vs {plain.seconds:.3f} s")
    assert rel <= 1e-3, (label, rel)
    return dict(seconds=plain.seconds, losses=plain.losses, max_rel_vs_kernels=rel)


def multimodal_steps(torch, fixed, moving, dtype, twins, base, form):
    """Phases 1c-1e: the fused ncc, nmi (the remapped pair) and lncc steps of
    the reduced ``dtype`` in displacement form ``form`` at ``iters=5``,
    counted, each level's loss within 1e-2 relative of the float32 call's
    (held as :func:`held` says, else printed).  Returns their launches and
    a summary."""
    sx = f"_{dtype_suffix(dtype)}"
    fwd, adj = (("bsi_ttli", "bsi_adjoint") if form == "lerp"
                else ("bsi_matmul", "bsi_adjoint_matmul"))
    mm = "_matmul" if form == "matmul" else ""
    rem = remap(moving)
    counts, calls = {}, {}
    for sim, mov, kinds in (("ncc", moving, ("stats", "ncc")), ("nmi", rem, ("stats", "nmi")),
                            ("lncc", rem, ("lncc",))):
        o32 = base.replace(similarity=sim, iters=5, fused="on")
        n = o32.levels * (o32.iters + 1)
        a32, _, _ = float32_twin(torch, twins, f"{sim} {form} iters=5", fixed, mov, o32)
        want = only(**{fwd: 1, fwd + sx: n, adj + sx: n},
                    **{f"bsi_fused_{k}{mm}{sx}": n for k in kinds})
        a16, counts[sim], c16 = counted_call(torch, f"{sx[1:]} fused {sim} {form} iters=5",
                                             fixed, mov, o32.replace(compute_dtype=dtype),
                                             want)
        rel = max(abs(a - b) / abs(b) for a, b in zip(a16.losses, a32.losses))
        log(f"{sx[1:]} fused {sim} {form} iters=5: losses {a16.losses} vs float32 "
            f"{a32.losses}, max relative {rel:.3e} "
            + ("(limit 1e-2)" if held(dtype) else "(printed, not held)"))
        assert all(math.isfinite(x) for x in a16.losses), (sim, a16.losses)
        assert not held(dtype) or rel < 1e-2, (sim, rel)
        calls[f"{sim}_{form}_iters5"] = dict(c16, losses=a16.losses, float32_losses=a32.losses,
                                             max_rel_vs_float32=rel)
    return counts, calls


def run_reduced_path(torch, fixed, moving, dtype, twins):
    """Phases 1b (b) and 1e: ``ffd_register`` of the main path's pair in the
    reduced ``dtype``, ``ttli / cuda / cuda`` unfused at ``lr=0.02`` (at 0.5
    the coarse level makes no progress at phantom1), beside the same
    float32 call (:func:`float32_twin`), each counted: the level loops'
    forwards all of the dtype, the adjoints on the cotangent of the dtype,
    as many as float32's, the final full-resolution warp one float32
    ``bsi_ttli`` as in the JAX package; held to float32
    (:func:`against_float32`) and to the plain path of the dtype
    (:func:`against_plain`); then ``mode="separable"`` in the dtype,
    counted; the share of zeros in one step's displacement cotangent
    (:func:`cotangent_share`); a small pair (40 x 32 x 24) card against CPU,
    per-level losses at 1e-4.  Returns each counted path's launches and a
    summary."""
    from repro_torch import RegistrationOptions, ffd_register, make_pair

    sx = dtype_suffix(dtype)
    opts32 = RegistrationOptions(mode="ttli", impl="cuda", grad_impl="cuda", fused="off",
                                 lr=0.02)
    opts = opts32.replace(compute_dtype=dtype)
    steps = opts32.levels * (opts32.iters + 1)
    r32, _, c32 = float32_twin(torch, twins, "ttli fused=off", fixed, moving, opts32,
                               only(bsi_ttli=steps + 1, bsi_adjoint=steps))
    want = only(**{f"bsi_ttli_{sx}": steps, "bsi_ttli": 1, f"bsi_adjoint_{sx}": steps})
    res, counts_ttli, c16 = counted_call(torch, f"{sx} ttli fused=off", fixed, moving, opts,
                                         want)
    counts = {"ttli": counts_ttli}
    calls = {"ttli": dict(c16, float32=c32,
                          **against_float32(torch, fixed, moving, f"{sx} ttli fused=off", res,
                                            r32, dtype),
                          plain=against_plain(torch, fixed, moving,
                                              f"{sx} ttli fused=off", res, opts))}

    want = only(**{f"bsi_separable_{sx}": steps, "bsi_separable": 1,
                   f"bsi_adjoint_{sx}": steps})
    sep, counts["separable"], c = counted_call(torch, f"{sx} separable", fixed, moving,
                                               opts.replace(mode="separable"), want)
    calls["separable"] = dict(c, losses=sep.losses)
    calls["cotangent"] = cotangent_share(torch, fixed, moving, dtype)

    f, m, _ = make_pair((40, 32, 24), seed=0, device="cpu")
    small = RegistrationOptions(levels=2, iters=5, fused="off", compute_dtype=dtype)
    card = ffd_register(f, m, options=small, device=torch.device("cuda"))
    host = ffd_register(f, m, options=small, device="cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card.losses, host.losses))
    mae = (card.warped.cpu() - host.warped).abs().mean().item()
    log(f"{sx} small pair (40, 32, 24) card vs CPU: losses {card.losses} vs {host.losses}, "
        f"max relative {rel:.3e} (limit 1e-4); warp MAE {mae:.3e}")
    assert rel <= 1e-4, rel
    calls["small_card_vs_cpu"] = dict(max_rel=rel, warp_mae=mae)
    return counts, calls


def cotangent_share(torch, fixed, moving, dtype):
    """The displacement cotangent that one step of the level loss of the
    reduced ``dtype`` hands its adjoint at phantom1 (SSD, the separable
    form, a seeded grid of 0.5 voxel): its share of exact zeros and of
    subnormals, and the float32 run's largest cotangent beside it (printed,
    not asserted: fp16's least subnormal is 5.96e-8, and the JAX package's
    fp16 cotangent underflows so)."""
    from repro_torch.core import ffd, interpolate
    from repro_torch.engine.batch import ffd_level_loss

    gshape = ffd.grid_shape_for_volume(tuple(fixed.shape), TILE)
    gen = torch.Generator(device=fixed.device).manual_seed(9)
    phi = torch.randn(gshape + (3,), generator=gen, device=fixed.device) * 0.5
    seen, real = [], interpolate.bsi_adjoint
    normal = torch.finfo(dtype).smallest_normal

    def spy(ct, *args, **kwargs):
        seen.append((ct.dtype, (ct == 0).float().mean().item(),
                     (ct.float().abs() < normal).float().mean().item(),
                     ct.float().abs().max().item()))
        return real(ct, *args, **kwargs)

    interpolate.bsi_adjoint = spy
    try:
        for cd in (dtype, None):
            p = phi.clone().requires_grad_(True)
            ffd_level_loss(fixed, moving, tile=TILE, bending_weight=0.0, mode="separable",
                           impl="cuda", grad_impl="cuda", compute_dtype=cd)(p).backward()
    finally:
        interpolate.bsi_adjoint = real
    (dt, zero, sub, top), (_, zero32, _, top32) = seen
    log(f"{dtype_suffix(dtype)} displacement cotangent at phantom1 ({dt}): {zero:.4f} of "
        f"its entries exactly 0, {sub:.4f} subnormal or 0, largest {top:.3e}; float32's "
        f"largest {top32:.3e}, {zero32:.4f} zero")
    return dict(zero_share=zero, subnormal_or_zero_share=sub, largest=top,
                float32_largest=top32, float32_zero_share=zero32)


def run_reduced_fused_path(torch, fixed, moving, dtype, twins, unfused):
    """Phases 1c (b) and 1e: ``ffd_register`` of the main path's pair with
    ``fused="on", lr=0.02`` in the reduced ``dtype``, ``ttli / cuda /
    cuda``, beside the same float32 fused call and the unfused call of the
    dtype (``unfused``, :func:`run_reduced_path`'s summary; seconds, peak
    memory above the call's start).  Asserts the launches (a step: one
    ``bsi_fused`` of the dtype, the backward's recomputed field one
    ``bsi_ttli`` of the dtype and its cotangent one ``bsi_adjoint`` of the
    dtype; the final warp one float32 ``bsi_ttli``, as in the JAX package);
    held to float32 (:func:`against_float32`) and to the plain fused path
    of the dtype (:func:`against_plain`); then the fused ncc, nmi and lncc
    steps at ``iters=5`` (:func:`multimodal_steps`); and ``fused="auto"``
    in the dtype raced once on a fresh disk cache.  Returns each counted
    path's launches and a summary."""
    from repro_torch import RegistrationOptions
    from repro_torch.engine import autotune

    sx = dtype_suffix(dtype)
    opts32 = RegistrationOptions(mode="ttli", impl="cuda", grad_impl="cuda", fused="on",
                                 lr=0.02)
    opts = opts32.replace(compute_dtype=dtype)
    steps = opts32.levels * (opts32.iters + 1)
    r32, _, c32 = float32_twin(torch, twins, "ttli fused=on", fixed, moving, opts32,
                               only(bsi_fused=steps, bsi_ttli=steps + 1, bsi_adjoint=steps))
    want = only(**{f"bsi_fused_{sx}": steps, f"bsi_ttli_{sx}": steps, "bsi_ttli": 1,
                   f"bsi_adjoint_{sx}": steps})
    res, fused_counts, c16 = counted_call(torch, f"{sx} ttli fused=on", fixed, moving, opts,
                                          want)
    log(f"{sx} fused path: {c16['seconds']:.3f} s vs {sx} unfused {unfused['seconds']:.3f} s "
        f"and float32 fused {c32['seconds']:.3f} s; peak {c16['peak_gib']:.2f} GiB vs "
        f"{unfused['peak_gib']:.2f} and {c32['peak_gib']:.2f} GiB")
    counts = {"fused": fused_counts}
    calls = {"fused": dict(c16, float32=c32, unfused=dict(seconds=unfused["seconds"]),
                           **against_float32(torch, fixed, moving, f"{sx} ttli fused=on", res,
                                             r32, dtype),
                           plain=against_plain(torch, fixed, moving, f"{sx} ttli fused=on",
                                               res, opts))}
    mm_counts, mm_calls = multimodal_steps(torch, fixed, moving, dtype, twins, opts32, "lerp")
    counts.update(mm_counts)
    calls.update(mm_calls)

    winner = log_fused_resolution(
        torch, tuple(fixed.shape), f"{sx} (ttli / cuda / cuda, lr=0.02)", mode="ttli",
        impl="cuda", grad_impl="cuda", lr=0.02, compute_dtype=dtype)
    race = autotune.RACES[-1]
    assert f"|cd={str(dtype).removeprefix('torch.')}|" in race.key, race.key
    calls["auto_fused"] = dict(fused=winner, race_seconds=race.seconds,
                               timings_us=dict(race.timings))
    return counts, calls


def run_reduced_matrix_path(torch, fixed, moving, dtype, twins):
    """Phases 1d (b)-(e) and 1e: ``ffd_register`` of the main path's pair in
    the matrix form in the reduced ``dtype``, ``mode="matmul", impl="cuda",
    grad_impl="matmul", lr=0.02``, with ``fused="off"`` and ``"on"``, each
    beside the same float32 call (:func:`float32_twin`), its launches
    asserted (unfused: a step one ``bsi_matmul`` and one
    ``bsi_adjoint_matmul`` of the dtype; fused also one ``bsi_fused_matmul``
    of the dtype, the backward's field recomputed by ``bsi_matmul``; the
    final warp one float32 ``bsi_matmul`` as in the JAX package), held to
    float32 (:func:`against_float32`) and to the plain path of the dtype
    (:func:`against_plain`).  Then (c) ``mode="tt"`` unfused at full depth,
    counted, held to float32 likewise; (d) the fused ncc, nmi and lncc steps
    in the matrix form at ``iters=5`` (:func:`multimodal_steps`); (e)
    all-``"auto"`` in the dtype on a fresh disk cache: the race of the four
    forms' kernels, its winner and seconds.  Returns each counted path's
    launches and a summary."""
    from repro_torch import RegistrationOptions
    from repro_torch.engine import autotune

    sx = dtype_suffix(dtype)
    cd = str(dtype).removeprefix("torch.")
    base = RegistrationOptions(mode="matmul", impl="cuda", grad_impl="matmul", lr=0.02)
    steps = base.levels * (base.iters + 1)
    counts, calls = {}, {}

    # (b) the matrix form, unfused and fused
    for fused in ("off", "on"):
        o32 = base.replace(fused=fused)
        label = f"matmul fused={fused}"
        extra32 = dict(bsi_fused_matmul=steps) if fused == "on" else {}
        extra = {f"bsi_fused_matmul_{sx}": steps} if fused == "on" else {}
        r32, _, c32 = float32_twin(
            torch, twins, label, fixed, moving, o32,
            only(bsi_matmul=steps + 1, bsi_adjoint_matmul=steps, **extra32))
        want = only(**{f"bsi_matmul_{sx}": steps, "bsi_matmul": 1,
                       f"bsi_adjoint_matmul_{sx}": steps}, **extra)
        o16 = o32.replace(compute_dtype=dtype)
        res, counts[f"matmul_{fused}"], c16 = counted_call(torch, f"{sx} {label}", fixed,
                                                           moving, o16, want)
        calls[f"matmul_{fused}"] = dict(
            c16, float32=c32,
            **against_float32(torch, fixed, moving, f"{sx} {label}", res, r32, dtype),
            plain=against_plain(torch, fixed, moving, f"{sx} {label}", res, o16))

    # (c) the TT form, unfused, at full depth
    o32 = base.replace(mode="tt", grad_impl="cuda", fused="off")
    r32, _, c32 = float32_twin(torch, twins, "tt", fixed, moving, o32,
                               only(bsi_tt=steps + 1, bsi_adjoint=steps))
    want = only(**{f"bsi_tt_{sx}": steps, "bsi_tt": 1, f"bsi_adjoint_{sx}": steps})
    res, counts["tt"], c16 = counted_call(torch, f"{sx} tt", fixed, moving,
                                          o32.replace(compute_dtype=dtype), want)
    calls["tt"] = dict(c16, float32=c32,
                       **against_float32(torch, fixed, moving, f"{sx} TT form", res, r32,
                                         dtype))

    # (d) the matrix form's fused ncc, nmi and lncc steps at iters=5
    mm_counts, mm_calls = multimodal_steps(torch, fixed, moving, dtype, twins, base, "matmul")
    counts.update({f"{k}_matmul": v for k, v in mm_counts.items()})
    calls.update(mm_calls)

    # (e) all-"auto" in the dtype: the four forms raced on a fresh disk cache
    opts = RegistrationOptions(mode="auto", impl="auto", grad_impl="auto", fused="auto",
                               compute_dtype=dtype)
    with tempfile.TemporaryDirectory(prefix="repro_torch_autotune_") as cache_dir:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(cache_dir, f"{sx}.json")
        try:
            autotune._MEM_CACHE.clear()
            autotune.resolve_options.cache_clear()
            n_races = len(autotune.RACES)
            t0 = time.perf_counter()
            r = autotune.resolve_options(opts, tuple(fixed.shape), torch.device("cuda"))
            race_s = time.perf_counter() - t0
        finally:
            del os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
    races = autotune.RACES[n_races:]
    forms = {name.split("/")[0] for name, _ in races[0].timings}
    log(f"{sx} all-auto at {tuple(fixed.shape)}: mode={r.mode} impl={r.impl} "
        f"grad_impl={r.grad_impl} fused={r.fused} ({r.fused_reason}); resolve "
        f"{race_s:.3f} s, {len(races)} races ("
        + "; ".join(f"{race.seconds:.3f} s: " + ", ".join(
            f"{nm} " + ("did not fit" if us is None else f"{us / 1e3:.3f} ms")
            for nm, us in race.timings) for race in races) + ")")
    assert forms == {"ttli", "separable", "tt", "matmul"}, forms
    assert all(f"|cd={cd}|" in race.key for race in races), races
    assert r.impl == "cuda" and r.grad_impl != "autograd", r
    calls["auto"] = dict(resolved=(r.mode, r.impl, r.grad_impl, r.fused), race_s=race_s,
                         races=[(race.seconds, race.timings) for race in races])
    return counts, calls


def run_reduced_phases(torch, fixed, moving, lib, dtype, twins):
    """Phases 1b-1d under bf16 and phase 1e under fp16: each reduced
    dtype's forward kernels and unfused path (1b), its fused level step
    (1c) and its matrix and TT forms (1d), the float32 calls shared through
    ``twins``.  Returns the kernels' rows, each counted path's launches and
    a summary of the calls."""
    sx = dtype_suffix(dtype)
    names = ("1b", "1c", "1d") if dtype == torch.bfloat16 else ("1e",) * 3
    start = t0 = time.perf_counter()
    rows = check_reduced_forward(torch, fixed, lib, dtype)
    counts, calls = run_reduced_path(torch, fixed, moving, dtype, twins)
    log(f"phase {names[0]} ({sx} forward and unfused path): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows += check_reduced_fused_kernels(torch, fixed, moving, lib, dtype)
    c, k = run_reduced_fused_path(torch, fixed, moving, dtype, twins, calls["ttli"])
    counts.update(c)
    calls.update(k)
    log(f"phase {names[1]} ({sx} fused level step): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows += check_reduced_matrix_kernels(torch, fixed, moving, lib, dtype)
    c, k = run_reduced_matrix_path(torch, fixed, moving, dtype, twins)
    counts.update(c)
    calls.update(k)
    log(f"phase {names[2]} ({sx} matrix and TT forms): {time.perf_counter() - t0:.1f} s; "
        f"{sx} in all {time.perf_counter() - start:.1f} s")
    return rows, counts, calls


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


def gauss_newton_launches(opts, cg_iters=10):
    """``bsi_ttli`` and ``bsi_adjoint`` launches of a Gauss-Newton
    ``ffd_register`` on the kernels: per level one value-and-grad, then per
    step the linearisation (one forward), ``cg_iters`` products ``J^T J v``
    (the forward on the tangent, then the adjoint), the LM trial (forward)
    and a value-and-grad; one forward more for the final warp."""
    per_step_fwd = 1 + cg_iters + 1 + 1
    per_step_adj = cg_iters + 1
    return (opts.levels * (1 + opts.iters * per_step_fwd) + 1,
            opts.levels * (1 + opts.iters * per_step_adj))


def check_jvp(torch, fixed):
    """Phase 4b: ``torch.func.jvp`` through the analytic BSI on the kernel
    (two ``bsi_ttli`` launches: the grid and the tangent) against the plain
    TTLI form's JVP at phantom1, 1e-5 of the largest value."""
    from repro_torch.core import ffd
    from repro_torch.kernels import ops

    vol = tuple(fixed.shape)
    gen = torch.Generator(device=fixed.device).manual_seed(1)
    gshape = ffd.grid_shape_for_volume(vol, TILE) + (3,)
    phi = torch.randn(gshape, generator=gen, device=fixed.device)
    tangent = torch.randn(gshape, generator=gen, device=fixed.device)

    def field(impl, grad_impl):
        return lambda p: ffd.dense_field(p, TILE, vol, mode="ttli", impl=impl,
                                         grad_impl=grad_impl)

    ops.reset_launch_counts()
    _, jv = torch.func.jvp(field("cuda", "cuda"), (phi,), (tangent,))
    counts = ops.launch_counts()
    _, ref = torch.func.jvp(field("torch", "autograd"), (phi,), (tangent,))
    rel = ((jv - ref).abs().max() / ref.abs().max()).item()
    log(f"jvp through the kernel at {vol}: relative to the plain form's {rel:.3e} "
        f"(limit 1e-5); launches {counts}")
    assert counts == only(bsi_ttli=2), counts
    assert rel <= 1e-5, rel


def run_workflow_paths(torch, fixed, moving):
    """Phase 4b: the single-pair workflow beyond the defaults at phantom1.
    ``affine_register`` (SSD, Adam, 60 steps) cold and warm; then
    ``ffd_register`` of its warp with the velocity transform, the bending
    energy, L-BFGS and early stopping at full depth, cold and warm, its
    field's least Jacobian determinant; Gauss-Newton with the bending energy
    at ``iters=5``, its launches counted exactly.  Returns the launch counts
    of both paths and a summary."""
    from repro_torch import (ConvergenceConfig, RegistrationOptions, affine_register,
                             ffd_register, jacobian_determinant)
    from repro_torch.core import metrics
    from repro_torch.core.transform import dense_displacement
    from repro_torch.kernels import ops

    vol = tuple(fixed.shape)
    out = {}
    mae0 = metrics.mae(moving, fixed).item()
    ssd0 = ((moving - fixed) ** 2).mean().item()
    for label in ("cold", "warm"):
        aff = affine_register(fixed, moving)
        mae = metrics.mae(aff.warped, fixed).item()
        log(f"affine ({label}): {aff.seconds:.3f} s, losses {aff.losses} (SSD at theta "
            f"= 0: {ssd0:.6f}), MAE {mae0:.6f} -> {mae:.6f}, theta "
            f"{aff.params.cpu().numpy().round(5).tolist()}")
        out[f"affine_{label}_s"] = aff.seconds
    assert aff.losses[-1] < ssd0 and torch.isfinite(aff.params).all()
    out.update(affine_losses=aff.losses, affine_mae=(mae0, mae))

    opts = RegistrationOptions(transform="velocity", regularizer="bending",
                               optimizer="lbfgs", stop=ConvergenceConfig())
    runs = []
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = ffd_register(fixed, aff.warped, options=opts)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs.append(res)
        mae = metrics.mae(res.warped, fixed).item()
        log(f"velocity + bending + lbfgs + stop ({label}): {res.seconds:.3f} s, steps "
            f"{res.steps}, losses {res.losses} (each level first -> last step "
            f"{level_falls(res)}), MAE {mae0:.6f} -> {mae:.6f} (after affine "
            f"{out['affine_mae'][1]:.6f}), peak device memory {peak:.2f} GiB, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        out[f"velocity_{label}_s"] = res.seconds
        assert counts["bsi_ttli"] > 0 and counts["bsi_adjoint"] > 0, counts
        assert counts == only(bsi_ttli=counts["bsi_ttli"],
                              bsi_adjoint=counts["bsi_adjoint"]), counts
        assert peak < 80, peak
    bit_equal = torch.equal(runs[0].params, runs[1].params)
    log(f"velocity: the two calls' grids bit-equal: {bit_equal}; max |diff| "
        f"{(runs[0].params - runs[1].params).abs().max().item():.3e}")
    with torch.no_grad():
        disp = dense_displacement(opts.transform, res.params, TILE, vol, mode="ttli",
                                  impl="cuda", grad_impl="cuda")
        jmin = jacobian_determinant(disp).min().item()
        del disp
    log(f"velocity: least Jacobian determinant of the returned field {jmin:.6f}")
    assert jmin > 0, jmin
    assert all(math.isfinite(x) for x in res.losses) and mae < mae0, (mae0, mae)
    vel_counts = counts
    out.update(velocity_steps=res.steps, velocity_losses=res.losses, velocity_peak_gib=peak,
               velocity_mae=mae, velocity_jmin=jmin, velocity_bit_equal=bit_equal,
               velocity_counts={k: v for k, v in counts.items() if v})
    del runs, res

    gn = RegistrationOptions(optimizer="gauss_newton", regularizer="bending", iters=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = ffd_register(fixed, moving, options=gn)
    gn_counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    fwd, adj = gauss_newton_launches(gn)
    vg_only = gn.levels * (gn.iters + 1) + 1
    log(f"gauss_newton + bending iters=5: {res.seconds:.3f} s, losses {res.losses}, "
        f"peak device memory {peak:.2f} GiB, launches "
        f"{ {k: v for k, v in gn_counts.items() if v} } (expected bsi_ttli {fwd}, "
        f"bsi_adjoint {adj}; the value-and-grads alone {vg_only})")
    assert gn_counts == only(bsi_ttli=fwd, bsi_adjoint=adj), gn_counts
    assert gn_counts["bsi_ttli"] > vg_only
    out.update(gn_s=res.seconds, gn_losses=res.losses, gn_peak_gib=peak,
               gn_counts={k: v for k, v in gn_counts.items() if v})
    return vel_counts, gn_counts, out


def compare_workflow_paths(torch, fixed, moving):
    """Phase 4b: the kernels against the plain path at ``iters=5`` for
    velocity + bending + Adam, L-BFGS, Gauss-Newton and Adam under
    ``stop=``: the kernel runs launch the forward and adjoint kernels, the
    plain runs none, per-level losses at 1e-4 and ``steps`` equal; then a small
    pair with velocity, bending, L-BFGS and ``stop``, the card against the
    CPU."""
    from repro_torch import ConvergenceConfig, RegistrationOptions, ffd_register, make_pair
    from repro_torch.kernels import ops

    paths = {"velocity-bending-adam": dict(transform="velocity", regularizer="bending"),
             "lbfgs": dict(optimizer="lbfgs"),
             "gauss_newton": dict(optimizer="gauss_newton"),
             "adam-stop": dict(stop=ConvergenceConfig(tol=1e-3, patience=2))}
    for name, fields in paths.items():
        ops.reset_launch_counts()
        kern = ffd_register(fixed, moving, options=RegistrationOptions(
            iters=5, fused="off", **fields))
        counts = ops.launch_counts()
        # the race of "auto" may pick any forward form; each runs a kernel
        forward = sum(counts[k] for k in ("bsi_ttli", "bsi_separable", "bsi_tt",
                                          "bsi_matmul"))
        adjoint = counts["bsi_adjoint"] + counts["bsi_adjoint_matmul"]
        assert forward > 0 and adjoint > 0, (name, counts)
        ops.reset_launch_counts()
        plain = ffd_register(fixed, moving, options=RegistrationOptions(
            iters=5, impl="torch", grad_impl="torch", fused="off", **fields))
        assert not any(ops.launch_counts().values()), ops.launch_counts()
        rel = max(abs(a - b) / abs(b) for a, b in zip(kern.losses, plain.losses))
        log(f"{name} iters=5: kernels {kern.losses} steps {kern.steps}, plain "
            f"{plain.losses} steps {plain.steps}, max relative {rel:.3e} (limit 1e-4); "
            f"{kern.seconds:.3f} s vs {plain.seconds:.3f} s; kernel launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        assert rel <= 1e-4 and kern.steps == plain.steps, (rel, kern.steps, plain.steps)

    f, m, _ = make_pair((28, 24, 20), seed=0, device="cpu")
    opts = RegistrationOptions(iters=10, transform="velocity", regularizer="bending",
                               optimizer="lbfgs",
                               stop=ConvergenceConfig(tol=5e-2, patience=1))
    card = ffd_register(f, m, options=opts)
    host = ffd_register(f, m, options=opts, device="cpu")
    err = (card.params.cpu() - host.params).abs().max().item()
    log(f"small pair, velocity + bending + lbfgs + stop: card {card.losses} steps "
        f"{card.steps}, cpu {host.losses} steps {host.steps}, params max |diff| "
        f"{err:.3e}")
    assert card.steps == host.steps
    assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(card.losses, host.losses))


def sum_counts(counts):
    """The kernel-wise sum of launch-count dicts."""
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def solo_runs(torch, pairs, opts):
    """Solo ``ffd_register`` calls of ``pairs`` under ``opts``, each with its
    launch counts."""
    from repro_torch import ffd_register
    from repro_torch.kernels import ops

    runs = []
    for f, m in pairs:
        ops.reset_launch_counts()
        res = ffd_register(f, m, options=opts)
        runs.append((res, ops.launch_counts()))
    return runs


def bit_equal(torch, warped, params, losses, steps, solo):
    """Whether a batched or served result equals a solo ``ffd_register`` bit
    for bit (``steps`` too under ``stop``)."""
    return (torch.equal(warped, solo.warped) and torch.equal(params, solo.params)
            and [float(x) for x in losses] == solo.losses
            and (steps is None or list(steps) == solo.steps))


def run_batch_paths(torch, pairs):
    """Phase 4c (a): ``register_batch`` of two phantom1 pairs at full width,
    ``fused="on"``, cold then warm (``compiled`` True then False), its
    seconds, peak memory and launch counts (asserted: twice a solo call's);
    each pair's ``warped``, ``params`` and ``losses`` bit-equal to a solo
    ``ffd_register``; then under ``stop=``, ``steps`` equal and the launches
    the solo calls' sum.  Returns the warm run's counts, a summary, and the
    warm and stop runs with their counts (phase 4d holds the sharded runs to
    them)."""
    from repro_torch import ConvergenceConfig, RegistrationOptions, register_batch
    from repro_torch.kernels import ops

    fixed = torch.stack([f for f, _ in pairs])
    moving = torch.stack([m for _, m in pairs])
    gib = (fixed.numel() + moving.numel()) * 4 / 2**30
    out = {}
    opts = RegistrationOptions(fused="on")
    for label, cold in (("cold", True), ("warm", False)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**30
        ops.reset_launch_counts()
        res = register_batch(fixed, moving, options=opts)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        expected = sum_counts([expected_launches(opts, opts.levels * (opts.iters + 1))] * 2)
        log(f"register_batch B=2 phantom1 ({gib:.2f} GiB of inputs), fused='on' "
            f"({label}): {res.seconds:.3f} s, compiled {res.compiled}, peak device memory "
            f"{peak:.2f} GiB ({peak - base:.2f} above the {base:.2f} GiB allocated before "
            f"the call), losses {res.losses.tolist()}, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        assert res.compiled is cold, res.compiled
        assert counts == expected, (counts, expected)
        out[f"{label}_s"], out[f"{label}_peak_gib"] = res.seconds, peak
        out[f"{label}_call_gib"] = peak - base
    batch_counts = counts
    solo = solo_runs(torch, pairs, opts)
    same = [bit_equal(torch, res.warped[b], res.params[b], res.losses[b], None, s)
            for b, (s, _) in enumerate(solo)]
    log(f"register_batch vs solo ffd_register: bit-equal {same}; solo "
        f"{[round(s.seconds, 3) for s, _ in solo]} s")
    assert all(same), same
    out.update(solo_s=[s.seconds for s, _ in solo], losses=res.losses.tolist())
    runs = dict(fixed=(res, counts))

    sopts = RegistrationOptions(fused="on", stop=ConvergenceConfig(tol=1e-3, patience=5))
    ops.reset_launch_counts()
    res = register_batch(fixed, moving, options=sopts)
    counts = ops.launch_counts()
    solo = solo_runs(torch, pairs, sopts)
    expected = sum_counts([expected_launches(sopts, sum(n + 1 for n in s.steps))
                           for s, _ in solo])
    same = [bit_equal(torch, res.warped[b], res.params[b], res.losses[b],
                      res.steps[b].tolist(), s) for b, (s, _) in enumerate(solo)]
    log(f"register_batch stop=(1e-3, 5): {res.seconds:.3f} s, steps {res.steps.tolist()} "
        f"(solo {[s.steps for s, _ in solo]}), losses {res.losses.tolist()}, bit-equal "
        f"{same}, launches "
        f"{ {k: v for k, v in counts.items() if v} } (expected "
        f"{ {k: v for k, v in expected.items() if v} })")
    assert all(same), same
    assert counts == expected == sum_counts([c for _, c in solo]), (counts, expected)
    out.update(stop_s=res.seconds, stop_steps=res.steps.tolist())
    runs["stop"] = (res, counts)
    return batch_counts, out, runs


def run_stream(torch, requests):
    """Phase 4c (b): the scheduler on a stream of Table 2 shapes, two lanes,
    chunks of 4, ``fused="on"``, ``lr=0.02`` and
    ``stop=ConvergenceConfig(tol=1e-3, patience=3)``: every request
    submitted at once and driven by ``run_until_idle``.  At the default
    ``lr=0.5`` no Adam step of phantom1's coarse level beats the start, so
    every pair would stop after ``patience`` steps and none would be hard;
    at 0.02 the hard pairs run their 40 steps a level and the easy one
    (moving = fixed) retires after 3, freeing its lane mid-flight.
    Asserted: all complete, a lane recycled, one stage per level and shape,
    each result bit-equal to a solo ``ffd_register`` (steps too), and the
    stream's launches the solo calls' sum (a retired or empty lane launches
    nothing).  Returns the stream's counts, a summary and the results."""
    from repro_torch import ConvergenceConfig, RegistrationOptions, RegistrationScheduler
    from repro_torch.kernels import ops

    opts = RegistrationOptions(fused="on", lr=0.02,
                               stop=ConvergenceConfig(tol=1e-3, patience=3))
    sched = RegistrationScheduler(opts, lanes=2, chunk=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [sched.submit(f, m) for f, m in requests]
    sched.run_until_idle()
    torch.cuda.synchronize()
    makespan = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    results = [h.result() for h in handles]
    stats = sched.stats
    log(f"stream of {len(requests)} (phantom1 hard, phantom1 easy, phantom1, porcine1), "
        f"lanes 2, chunk 4: makespan {makespan:.3f} s, {len(requests) / makespan:.3f} "
        f"pairs/s, latencies {[round(r.seconds, 3) for r in results]} s, steps "
        f"{[r.steps for r in results]}, recycled {[r.recycled for r in results]}, peak "
        f"device memory {peak:.2f} GiB, {stats}")
    solo = solo_runs(torch, requests, opts)
    same = [bit_equal(torch, r.warped, r.params, r.losses, r.steps, s)
            for r, (s, _) in zip(results, solo)]
    solo_counts = sum_counts([c for _, c in solo])
    solo_s = [s.seconds for s, _ in solo]
    log(f"stream vs solo ffd_register: bit-equal {same}; solo "
        f"{[round(x, 3) for x in solo_s]} s, sum {sum(solo_s):.3f} s (makespan / sum {makespan / sum(solo_s):.3f}); "
        f"launches {counts == solo_counts} ({ {k: v for k, v in counts.items() if v} })")
    assert stats.completed == len(requests) and stats.recycled >= 1, stats
    assert stats.compiles == opts.levels * 2, stats
    assert all(same), same
    assert counts == solo_counts, (counts, solo_counts)
    return counts, dict(makespan_s=makespan, pairs_per_s=len(requests) / makespan,
                        latencies_s=[r.seconds for r in results],
                        steps=[r.steps for r in results], peak_gib=peak,
                        solo_s=solo_s, recycled=stats.recycled,
                        chunks=stats.chunks), results


def check_batch_small(torch):
    """Phase 4c (c): the launcher's smoke run on the card, and a small batch
    (B = 2 at 28x24x20) on the card against the CPU: losses within 1e-4,
    each pair's grid within 1e-4 or, where the CPU path itself moves more
    when the moving volume is nudged by one ulp (up or down), within that
    spread (Adam divides each gradient entry by its own magnitude, so
    entries near its eps carry rounding into the step)."""
    from repro_torch import RegistrationOptions, make_pair, register_batch
    from repro_torch.launch import serve_registration

    t0 = time.perf_counter()
    smoke = serve_registration.main(["--smoke"])
    log(f"serve_registration --smoke: {time.perf_counter() - t0:.2f} s, launches "
        f"{smoke['counts']}")
    pairs = [make_pair((28, 24, 20), seed=s, device="cpu")[:2] for s in (0, 1)]
    fixed = torch.stack([f for f, _ in pairs])
    moving = torch.stack([m for _, m in pairs])
    opts = RegistrationOptions(iters=5, fused="on")
    card = register_batch(fixed, moving, options=opts)
    host = register_batch(fixed, moving, options=opts, device="cpu")
    spread = torch.zeros(len(pairs))
    for end in (float("inf"), float("-inf")):
        nudged = register_batch(fixed, torch.nextafter(moving, torch.tensor(end)),
                                options=opts, device="cpu")
        spread = torch.maximum(spread, (nudged.params - host.params).abs().amax((1, 2, 3, 4)))
    err = (card.params.cpu() - host.params).abs().amax((1, 2, 3, 4))
    lerr = ((card.losses.cpu() - host.losses).abs() / host.losses.abs()).max().item()
    log(f"small batch: card {card.losses.tolist()} cpu {host.losses.tolist()}, params max "
        f"|diff| per pair {err.tolist()} (limit 1e-4, or the CPU's own one-ulp spread "
        f"{spread.tolist()}), losses relative {lerr:.3e} (limit 1e-4)")
    assert (err <= torch.clamp(spread, min=1e-4)).all() and lerr <= 1e-4, (err, spread, lerr)


def same_result(torch, a, b):
    """Whether two registration results are equal bit for bit."""
    steps = (a.steps is None and b.steps is None) or (
        torch.equal(torch.as_tensor(a.steps), torch.as_tensor(b.steps)))
    return (torch.equal(a.warped, b.warped) and torch.equal(a.params, b.params)
            and torch.equal(torch.as_tensor(a.losses), torch.as_tensor(b.losses))
            and steps)


def run_mesh_paths(torch, pairs, runs, requests, stream_results, stream_counts):
    """Phase 4d: sharded registration on a one-rank mesh, NCCL on the card
    (``engine.shard``): ``register_batch(..., mesh=)`` of phase 4c's two
    phantom1 pairs, ``fused="on"``, warm and under ``stop=``, each result
    and its launches asserted equal to phase 4c's unsharded run (reused, not
    re-run); ``sharded_pipeline``'s outputs asserted ``DTensor``s sharded on
    dimension 0, their gather (``full_tensor``, an NCCL all-gather) timed
    with CUDA events; the scheduler with ``mesh=`` on phase 4c's stream,
    each served result and the launches asserted equal to the unsharded
    stream's.  Returns the launch counts and a summary."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch import ConvergenceConfig, RegistrationOptions, RegistrationScheduler
    from repro_torch import register_batch
    from repro_torch.engine import make_registration_mesh, sharded_pipeline
    from repro_torch.engine.autotune import resolve_options
    from repro_torch.kernels import ops

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # no network: loopback only
    t0 = time.perf_counter()
    mesh = make_registration_mesh()
    one = torch.ones(1, device="cuda")
    dist.all_reduce(one, group=mesh.get_group())  # NCCL's communicator comes up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # DTensor's first gather pays its one-time set-up; the timed calls do not
    tiny = DTensor.from_local(one, mesh, (Shard(0),), run_check=False).full_tensor()
    torch.cuda.synchronize()
    log(f"mesh: {mesh}, backend {dist.get_backend()}, world {dist.get_world_size()}, "
        f"first all-reduce {one.item()}; bring-up: NCCL {t1 - t0:.2f} s, DTensor's "
        f"first gather {time.perf_counter() - t1:.2f} s")
    assert dist.get_backend() == "nccl" and mesh.size() == 1 and one.item() == 1.0
    assert torch.equal(tiny, one)
    fixed = torch.stack([f for f, _ in pairs])
    moving = torch.stack([m for _, m in pairs])
    out, counts_out = {}, {}
    stop = ConvergenceConfig(tol=1e-3, patience=5)
    for label, opts in (("fixed", RegistrationOptions(fused="on")),
                        ("stop", RegistrationOptions(fused="on", stop=stop))):
        base, base_counts = runs[label]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() / 2**30
        ops.reset_launch_counts()
        res = register_batch(fixed, moving, options=opts, mesh=mesh)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        same = same_result(torch, res, base)
        log(f"register_batch mesh=1 rank, {label}: {res.seconds:.3f} s (unsharded "
            f"{base.seconds:.3f} s), peak device memory {peak:.2f} GiB ({peak - before:.2f} "
            f"above the {before:.2f} GiB allocated before the call), steps "
            f"{None if res.steps is None else res.steps.tolist()}, bit-equal to "
            f"unsharded {same}, launches {counts == base_counts} "
            f"({ {k: v for k, v in counts.items() if v} })")
        assert same and counts == base_counts, (same, counts, base_counts)
        out[f"{label}_s"], out[f"{label}_peak_gib"] = res.seconds, peak
        out[f"{label}_call_gib"] = peak - before
        out[f"{label}_unsharded_s"] = base.seconds
        counts_out[label] = counts
        del res

    sopts = resolve_options(RegistrationOptions(fused="on", stop=stop),
                            tuple(fixed.shape[1:]), "cuda")
    shards = sharded_pipeline(fixed, moving, options=sopts, mesh=mesh)
    assert all(isinstance(t, DTensor) and t.placements == (Shard(0),)
               and t.to_local().shape[0] == 2 for t in shards), shards
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    gathered = [t.full_tensor() for t in shards]
    end.record()
    end.synchronize()
    gather_ms = start.elapsed_time(end)
    base = runs["stop"][0]
    same = (torch.equal(gathered[0], base.warped) and torch.equal(gathered[1], base.params)
            and torch.equal(gathered[2], base.losses)
            and torch.equal(gathered[3].cpu(), base.steps))
    mb = sum(g.numel() * g.element_size() for g in gathered) / 1e6
    log(f"sharded_pipeline: {[type(t).__name__ for t in shards]}, placements "
        f"{shards[0].placements}, local rows {shards[0].to_local().shape[0]}; gather "
        f"(full_tensor, NCCL) {gather_ms:.3f} ms device time for {mb:.1f} MB, bit-equal "
        f"{same}")
    assert same
    out["gather_ms"], out["gather_mb"] = gather_ms, mb
    del shards, gathered

    sched = RegistrationScheduler(RegistrationOptions(fused="on", lr=0.02,
                                                      stop=ConvergenceConfig(tol=1e-3,
                                                                             patience=3)),
                                  lanes=2, chunk=4, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [sched.submit(f, m) for f, m in requests]
    sched.run_until_idle()
    torch.cuda.synchronize()
    makespan = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    results = [h.result() for h in handles]
    same = [same_result(torch, r, b) and r.recycled == b.recycled
            for r, b in zip(results, stream_results)]
    log(f"stream mesh=1 rank: makespan {makespan:.3f} s, latencies "
        f"{[round(r.seconds, 3) for r in results]} s, peak device memory {peak:.2f} GiB, "
        f"{sched.stats}; bit-equal to unsharded {same}, launches "
        f"{counts == stream_counts}")
    assert all(same) and counts == stream_counts, (same, counts, stream_counts)
    assert sched.stats.recycled >= 1, sched.stats
    out.update(stream_makespan_s=makespan, stream_peak_gib=peak,
               stream_chunks=sched.stats.chunks)
    counts_out["stream"] = counts
    dist.destroy_process_group()
    return counts_out, out


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

    # the nmi measurement builds and the main pair (numpy on the host) run
    # beside the main build
    side = concurrent.futures.ThreadPoolExecutor(2)
    stage_future = side.submit(nmi_stage_builds)
    pair_future = side.submit(make_pair, PAPER_VOLUMES["phantom1"], seed=0)
    lib = load_library()
    log(f"build: {lib.info.seconds:.2f} s ({lib.info.path.name}; the measurement builds "
        "beside it)")
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
    stage_libs = stage_future.result()
    log(f"nmi measurement builds ({', '.join(NMI_STAGES.values())}): done "
        f"{time.perf_counter() - t_start:.2f} s after the start")

    # phase 4c's other pairs, made on the host meanwhile (numpy, then the
    # plain warp on the CPU)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    extra_pairs = pool.submit(lambda: [
        make_pair(PAPER_VOLUMES[name], seed=seed, device="cpu")[:2]
        for name, seed in (("phantom1", 1), ("porcine1", 0))])
    fixed, moving, _ = pair_future.result()
    side.shutdown()
    log(f"make_pair(phantom1 {tuple(fixed.shape)}): done {time.perf_counter() - t_start:.1f} "
        "s after the start")

    rows = check_kernels(torch, fixed, moving, lib, stage_libs)
    rows += check_matmul_kernels(torch, fixed, moving, lib, stage_libs)
    rows += check_forward_forms(torch, fixed, lib)
    counts = run_main_path(torch, fixed, moving)
    # phases 1b-1d (bf16) and 1e (fp16): one harness, the float32 calls
    # that each reduced call is held against run once, in phase 1b-1d
    twins, reduced = {}, {}
    for dtype in (torch.bfloat16, torch.float16):
        dt_rows, dt_counts, dt_calls = run_reduced_phases(torch, fixed, moving, lib, dtype,
                                                          twins)
        rows += dt_rows
        reduced[dtype_suffix(dtype)] = (dt_counts, dt_calls)
    del twins
    compare_paths(torch, fixed, moving)
    nmi_counts, nmi_call = run_multimodal(torch, fixed, moving)
    ncc_counts = compare_multimodal_paths(torch, fixed, moving)
    lncc_counts, lncc_call = run_lncc_path(torch, fixed, moving)
    matmul_counts = compare_matmul_paths(torch, fixed, moving)
    form_counts, form_calls = run_forward_form_paths(torch, fixed, moving)
    auto_counts, auto_call = run_auto_path(torch, fixed, moving)
    check_jvp(torch, fixed)
    vel_counts, gn_counts, workflow = run_workflow_paths(torch, fixed, moving)
    compare_workflow_paths(torch, fixed, moving)
    t0 = time.perf_counter()
    (f1, m1), (f2, m2) = ((f.cuda(), m.cuda()) for f, m in extra_pairs.result())
    pool.shutdown()
    batch_counts, batch_call, batch_runs = run_batch_paths(torch, [(fixed, moving),
                                                                   (f1, m1)])
    requests = [(fixed, moving), (fixed, fixed), (f1, m1), (f2, m2)]
    stream_counts, stream_call, stream_results = run_stream(torch, requests)
    check_batch_small(torch)
    phase_4c = time.perf_counter() - t0
    log(f"phase 4c: {phase_4c:.1f} s")
    t0 = time.perf_counter()
    mesh_counts, mesh_call = run_mesh_paths(torch, [(fixed, moving), (f1, m1)], batch_runs,
                                            requests, stream_results, stream_counts)
    log(f"phase 4d: {time.perf_counter() - t0:.1f} s (phase 4c {phase_4c:.1f} s)")
    del fixed, moving, f1, m1, f2, m2, batch_runs, stream_results, requests
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
    # the reduced dtypes' kernels: each in the counted path that runs it
    for sx, (c, _) in reduced.items():
        path_counts.update({
            f"bsi_ttli_{sx}": c["ttli"], f"bsi_separable_{sx}": c["separable"],
            f"bsi_adjoint_{sx}": c["fused"], f"bsi_fused_{sx}": c["fused"],
            f"bsi_tt_{sx}": c["tt"], f"bsi_matmul_{sx}": c["matmul_off"],
            f"bsi_adjoint_matmul_{sx}": c["matmul_off"],
            f"bsi_fused_matmul_{sx}": c["matmul_on"],
            **{f"bsi_fused_{k}{mm}_{sx}": c[f"{sim}{mm}"] for mm in ("", "_matmul")
               for sim, ks in (("ncc", ("stats", "ncc")), ("nmi", ("nmi",)),
                               ("lncc", ("lncc",))) for k in ks}})
    for r in rows:
        r["launches"] = path_counts.get(r["name"], counts)[r.get("count", r["name"])]
        assert r["launches"] > 0, r
        if r["name"] in ("bsi_ttli", "bsi_adjoint"):
            # the same kernels' launches on the velocity + L-BFGS path and
            # on the Gauss-Newton path (phase 4b)
            r["more"] = dict(r.get("more", {}), launches_velocity_lbfgs=vel_counts[
                r["name"]], launches_gauss_newton=gn_counts[r["name"]],
                launches_batch=batch_counts[r["name"]],
                launches_serve=stream_counts[r["name"]])
        if r["name"] in ("bsi_ttli", "bsi_adjoint", "bsi_fused"):
            # and on the sharded batch and stream (phase 4d)
            r["more"] = dict(r.get("more", {}),
                             launches_batch_mesh=mesh_counts["fixed"][r["name"]],
                             launches_serve_mesh=mesh_counts["stream"][r["name"]])
    log(f"nmi call at phantom1: {nmi_call}")
    log("nmi kernel at phantom1: " + "; ".join(f"{r['name']}: {r['nmi']}" for r in rows
                                                if "nmi" in r))
    log(f"lncc matmul call at phantom1: {lncc_call}")
    for mode, call in form_calls.items():
        log(f"{mode} call at phantom1: {call}")
    log(f"auto call at phantom1: {auto_call}; launches {auto_counts}")
    for sx, (_, calls) in reduced.items():
        log(f"{sx} calls at phantom1 (phases {'1b-1d' if sx == 'bf16' else '1e'}): {calls}")
    log(f"workflow at phantom1: {workflow}")
    log(f"register_batch at phantom1: {batch_call}")
    log(f"stream: {stream_call}")
    log(f"sharded (phase 4d): {mesh_call}")
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
