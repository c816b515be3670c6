#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and hold every
kernel against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases; any failure raises and the script exits nonzero:

1. the card's name and power limit (nvidia-smi) and the device count;
2. build the kernels from ``src/repro_torch/csrc`` with nvcc (build seconds,
   registers and spills from ``-Xptxas -v``);
3. each kernel at the shapes of the paper's phantom1 volume (512, 228, 385),
   tile 5^3, 3 channels: compared with its plain version, and timed with CUDA
   events beside the plain version, its byte/operation bound and, where one
   PyTorch call computes the same function, that call.  The stats, ncc and
   nmi kernels run on the multi-modal pair of phase 4;
4. the paths, each with the launch counts set to 0 just before and read just
   after: ``ffd_register`` with the default options (the fused SSD, TTLI and
   adjoint kernels) on ``make_pair(phantom1, seed=0)``; the same pair at
   ``iters=5`` on the kernels and on the plain path, whose per-level losses
   must agree to 1e-4, and a small pair on the card against the CPU.  Then
   the multi-modal path: the moving volume remapped by ``(1 - v)^1.5`` and
   registered with ``similarity="nmi"`` (the stats, nmi, TTLI and adjoint
   kernels), scored by the MAE of the original moving volume warped by the
   recovered field, beside an SSD run on the same pair; the NCC and NMI
   paths at ``iters=5`` on the kernels and on the plain path; and a small
   remapped pair with NMI on the card against the CPU;
5. one JSON line of the kernels, the nvidia-smi line, and the result line.

Float32 convolutions and matrix products are pinned to full fp32
(``allow_tf32 = False``) so the library yardsticks compute in fp32 too.
"""

import json
import math
import subprocess
import sys
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


def remap(v):
    """Monotone-decreasing intensity remap: a synthetic second modality."""
    return (1.0 - v) ** 1.5


def check_kernels(torch, fixed, moving):
    """Phase 3: every kernel against its plain version at phantom1 shapes."""
    import torch.nn.functional as F

    from repro_torch.core import ffd
    from repro_torch.kernels import bsi_adjoint, bsi_fused, bsi_ttli, ops
    from repro_torch.launch.bounds import bound_ms, kernel_bounds

    dev = fixed.device
    vol = tuple(fixed.shape)
    gshape = ffd.grid_shape_for_volume(vol, TILE)
    gen = torch.Generator(device=dev).manual_seed(0)
    phi = torch.randn(gshape + (3,), generator=gen, device=dev) * 2.5
    g = torch.randn(vol + (3,), generator=gen, device=dev) * 1e-3
    X, Y, Z = vol
    tx, ty, tz = (n - 3 for n in gshape)
    dx, dy, dz = TILE
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
    K = conv_kernel(torch, TILE, 3, dev)
    phi_cf = phi.permute(3, 0, 1, 2).unsqueeze(0).contiguous()

    def library_fwd():
        full = F.conv_transpose3d(phi_cf, K, stride=TILE, groups=3)
        return full[0, :, 3 * dx:3 * dx + X, 3 * dy:3 * dy + Y, 3 * dz:3 * dz + Z]

    lib_err = (library_fwd().permute(1, 2, 3, 0) - ref).abs().max().item()
    log(f"bsi_ttli: library yardstick (conv_transpose3d) max |diff| = {lib_err:.3e}")
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
    g_cf = torch.zeros((1, 3, tx * dx, ty * dy, tz * dz), device=dev)
    g_cf[0, :, :X, :Y, :Z] = g.permute(3, 0, 1, 2)

    def library_adj():
        return F.conv3d(g_cf, K, stride=TILE, padding=tuple(3 * d for d in TILE),
                        groups=3)

    lib_err = (library_adj()[0].permute(1, 2, 3, 0) - ref).abs().max().item()
    log(f"bsi_adjoint: library yardstick (conv3d) max |diff| = {lib_err:.3e}")
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
    b_ms, b_by = bounds["bsi_fused_stats"]
    rows.append(dict(
        name="bsi_fused_stats", route="cuda", source="src/repro_torch/csrc/bsi_fused.cu",
        replaces="src/repro/kernels/bsi_fused.py:291", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.fused_stats(phi_f, rem, TILE)),
        plain_ms=cuda_ms(torch, lambda: bsi_fused.plain_stats(phi_f, rem, TILE), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))

    plain_passes = dict(stats=bsi_fused.plain_stats, ncc_moments=bsi_fused.plain_ncc,
                        nmi_histogram=bsi_fused.plain_nmi)

    def loss_check(name, spec):
        """The two-pass loss on the kernels against the same finish on the
        plain versions, 1e-5 relative."""
        out = ops.fused_similarity_loss(phi_f, rem, fixed, TILE, sim_spec=spec).item()
        ref = ops.two_pass_loss(spec, phi_f, rem, fixed, TILE, **plain_passes).item()
        rel = abs(out - ref) / abs(ref)
        log(f"{name}: loss kernel {out:.9g} plain {ref:.9g} relative {rel:.3e} "
            "(limit 1e-5)")
        assert math.isfinite(rel) and rel <= 1e-5, rel
        return abs(out - ref)

    scal = torch.stack([ref[0] / n, fixed.mean()])
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
    b_ms, b_by = bounds["bsi_fused_nmi"]
    rows.append(dict(
        name="bsi_fused_nmi", route="cuda", source="src/repro_torch/csrc/bsi_fused.cu",
        replaces="src/repro/kernels/bsi_fused.py:291", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.fused_nmi_histogram(phi_f, rem, fixed, scal, TILE,
                                                          **kw)),
        plain_ms=cuda_ms(torch, lambda: bsi_fused.plain_nmi(phi_f, rem, fixed, scal,
                                                            TILE, **kw), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for r in rows:
        log(f"{r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{'-' if r['library_ms'] is None else format(r['library_ms'], '.4f')} ms")
    return rows


def run_main_path(torch, fixed, moving):
    """Phase 4: the port's ffd_register on the kernels, counted."""
    from repro_torch import RegistrationOptions, ffd_register
    from repro_torch.kernels import ops

    opts = RegistrationOptions()
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
    expected = {"bsi_ttli": steps + 1 + 4, "bsi_adjoint": steps, "bsi_fused": steps,
                "bsi_fused_stats": 0, "bsi_fused_ncc": 0, "bsi_fused_nmi": 0}
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

    kern = ffd_register(fixed, moving, options=RegistrationOptions(iters=5))
    ops.reset_launch_counts()
    plain = ffd_register(fixed, moving, options=RegistrationOptions(
        iters=5, impl="torch", grad_impl="torch", fused="off"))
    assert not any(ops.launch_counts().values()), ops.launch_counts()  # plain ops only
    rel = max(abs(a - b) / abs(b) for a, b in zip(kern.losses, plain.losses))
    log(f"iters=5: kernels {kern.losses} plain {plain.losses} max relative {rel:.3e} "
        f"(limit 1e-4); {kern.seconds:.3f} s vs {plain.seconds:.3f} s")
    assert rel <= 1e-4, rel

    f, m, _ = make_pair((28, 24, 20), seed=0, device="cpu")
    opts = RegistrationOptions(iters=5)
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
    opts = RegistrationOptions(similarity="nmi")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = ffd_register(fixed, rem, options=opts, measure_bsi_time=True)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = opts.levels * (opts.iters + 1)
    expected = {"bsi_ttli": steps + 1 + 4, "bsi_adjoint": steps, "bsi_fused": 0,
                "bsi_fused_stats": steps, "bsi_fused_ncc": 0, "bsi_fused_nmi": steps}
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
    ssd = ffd_register(fixed, rem, options=RegistrationOptions())
    mae_ssd = recovered_mae(ssd.params)
    log(f"nmi path: MAE of the recovered warp, pre-registration {mae0:.6f}, nmi "
        f"{mae_nmi:.6f}, ssd on the same remapped pair {mae_ssd:.6f} "
        f"({ssd.seconds:.3f} s)")
    assert mae_nmi < mae0, (mae0, mae_nmi)
    return counts, dict(seconds=res.seconds, peak_gib=peak)


def compare_multimodal_paths(torch, fixed, moving):
    """Phase 4: NCC and NMI at iters=5 on the kernels and on the plain path,
    and a small remapped pair with NMI on the card against the CPU."""
    from repro_torch import RegistrationOptions, ffd_register, make_pair
    from repro_torch.kernels import ops

    rem = remap(moving)
    counts = {}
    for sim in ("ncc", "nmi"):
        ops.reset_launch_counts()
        kern = ffd_register(fixed, rem, options=RegistrationOptions(iters=5,
                                                                   similarity=sim))
        counts[sim] = ops.launch_counts()
        steps = 2 * (5 + 1)
        expected = {"bsi_ttli": steps + 1, "bsi_adjoint": steps, "bsi_fused": 0,
                    "bsi_fused_stats": steps,
                    "bsi_fused_ncc": steps if sim == "ncc" else 0,
                    "bsi_fused_nmi": steps if sim == "nmi" else 0}
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
    opts = RegistrationOptions(iters=5, similarity="nmi")
    card = ffd_register(f, remap(m), options=opts)
    host = ffd_register(f, remap(m), options=opts, device="cpu")
    err = (card.params.cpu() - host.params).abs().max().item()
    log(f"small remapped pair, nmi: card {card.losses} cpu {host.losses}, "
        f"params max |diff| {err:.3e}")
    assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(card.losses, host.losses))
    return counts["ncc"]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import PAPER_VOLUMES, make_pair
    from repro_torch.kernels.build import load_library

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

    t0 = time.perf_counter()
    fixed, moving, _ = make_pair(PAPER_VOLUMES["phantom1"], seed=0)
    log(f"make_pair(phantom1 {tuple(fixed.shape)}): {time.perf_counter() - t0:.1f} s")

    rows = check_kernels(torch, fixed, moving)
    counts = run_main_path(torch, fixed, moving)
    compare_paths(torch, fixed, moving)
    nmi_counts, nmi_call = run_multimodal(torch, fixed, moving)
    ncc_counts = compare_multimodal_paths(torch, fixed, moving)
    # each kernel's launches in the run of its own path: SSD, NMI, NCC
    path_counts = {"bsi_fused_stats": nmi_counts, "bsi_fused_nmi": nmi_counts,
                   "bsi_fused_ncc": ncc_counts}
    for r in rows:
        r["launches"] = path_counts.get(r["name"], counts)[r["name"]]
        assert r["launches"] > 0, r
    log(f"nmi call at phantom1: {nmi_call}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
