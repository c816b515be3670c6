"""Where the time of the float32 flash-attention kernel goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_flash [--batch B]
        [--seq S] [--softcaps C ...] [--reps N] [--split] [--against LIB]
        [--mma-rate]

At gemma2-2b's global attention layer (``launch/bounds.py:ATTENTION_LAYER``:
8 query and 4 key/value heads, head dim 256, causal; by default batch 4 and
8160 tokens, the serving cell's prefill) on float32 q, k and v from a seeded
generator, for each softcap (default 50 and 0): the kernel's milliseconds a
call through ``ops.flash_attention`` (CUDA events), its largest difference
from ``kernels.flash_attention.plain`` (asserted within 2e-5) and from
``scaled_dot_product_attention`` in float32 at softcap 0 (its backend pinned
and named, :func:`sdpa_f32`), whether two calls are bit-equal, the bound
(``launch/bounds.py:attention_fp32_bound``), the kernel's registers and
spills (``-Xptxas -v``), its tensor-core instructions and its SASS opcode mix
(``cuobjdump -sass``).  ``--split`` builds the kernels again with each part
of :data:`SKIPS` left out of the float32 kernel (``-DREPRO_FLASH_SKIP``:
measurement builds, ``build.load_library(defines)``, all in parallel) and
times each in turns with the full one, twice.  ``--against LIB`` times the
float32 entry of another build of the kernels (a parent commit's library) in
turns with this one's on the same inputs (theirs, ours, ours, theirs) and
gives the largest difference of the two outputs.  ``--mma-rate`` builds and
runs ``launch/mma_rate.cu``, the tensor cores' rate through ``mma.sync``
alone and with other instructions beside.  The last line is one JSON object
with the numbers.  Needs a CUDA device; there is no CPU path.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.device import card_name
from repro_torch.kernels import build, flash_attention, ops
from repro_torch.kernels.build import load_library
from repro_torch.launch.bounds import ATTENTION_LAYER, SERVE_BATCH, SERVE_SEQ
from repro_torch.launch.bounds import attention_fp32_bound
from repro_torch.launch.profile_adjoint import cuda_ms

__all__ = ["SKIPS", "launcher", "main", "mma_rate", "sass_mix", "sdpa_f32", "split_times"]

# the parts left out in the measurement builds (csrc/flash_attention.cu:
# REPRO_FLASH_SKIP): 1 the K and V staging (the tiles are not loaded), 2 the
# product Q K^T (each score a value of the staged K), 4 the softcap and the
# online softmax (p the raw score, no max, sum or correction), 8 the product
# P V; 15 all four, the kernel's skeleton
SKIPS = {"no staging": 1, "no QK^T": 2, "no softmax": 4, "no PV": 8, "skeleton": 15}
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_void_p]


def _bind(path):
    """The ``flash_attention_f32`` entry of the library at ``path``."""
    fn = ctypes.CDLL(str(path)).flash_attention_f32
    fn.argtypes, fn.restype = _ARGS, ctypes.c_int
    return fn


def sass_mix(path, head_dim=256, top=16) -> dict:
    """``{opcode: n}``: the ``top`` most frequent SASS opcodes (modifiers
    dropped) of the float32 kernel at ``head_dim`` in the library at
    ``path``, by ``cuobjdump -sass``: the instructions a launch issues are
    these, in the proportions of its unrolled loops."""
    cuobjdump = str(Path(build.nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(path)], check=True, capture_output=True,
                          text=True).stdout
    counts, inside = {}, False
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            inside = "flash_tf32_kernel" in m.group(1) and f"ILi{head_dim}E" in m.group(1)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1])[:top])


def launcher(fn, q, k, v, out, softcap):
    """A call of the float32 entry ``fn`` on ``(q, k, v) -> out`` (causal, no
    window) on the current stream, as ``kernels.flash_attention.launch``
    makes it."""
    B, S, H, hd = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, k.shape[2],
            hd, 1, 0, flash_attention.scale_of(hd), float(softcap))

    def call():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash_attention_f32 launch failed: cudaError_t {rc}")
    return call


def sdpa_f32(q, k, v):
    """``(call, backend)``: float32 ``scaled_dot_product_attention`` (causal)
    on the kernel's inputs, as a yardstick: the key and value heads repeated
    to the query heads' once, outside the call, and the backend pinned to the
    first of memory-efficient attention and the math backend that takes the
    call (flash attention and cuDNN take no float32)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(rep, dim=2).transpose(1, 2) for t in (k, v))
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True).transpose(1, 2)
        try:
            call()
        except RuntimeError:
            continue
        return call, backend.name
    raise RuntimeError("no scaled_dot_product_attention backend takes float32")


def mma_rate() -> list:
    """The lines ``launch/mma_rate.cu`` prints, built into the build root."""
    src = Path(__file__).resolve().parent / "mma_rate.cu"
    exe = build.BUILD_ROOT / "mma_rate"
    exe.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(exe), str(src)], check=True, capture_output=True, text=True)
    return subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                          timeout=120).stdout.strip().splitlines()


def split_times(inputs, softcap, reps) -> dict:
    """``{label: [ms, ms]}``: the float32 kernel as built (``full``) and each
    measurement build of :data:`SKIPS`, timed in turns, twice."""
    with ThreadPoolExecutor(len(SKIPS)) as pool:
        built = list(pool.map(lambda s: load_library((f"REPRO_FLASH_SKIP={s}",)),
                              SKIPS.values()))
    fns = {"full": load_library().flash_attention_f32,
           **{k: lib.flash_attention_f32 for k, lib in zip(SKIPS, built)}}
    out = torch.empty_like(inputs[0])
    calls = {k: launcher(fn, *inputs, out, softcap) for k, fn in fns.items()}
    times = {k: [] for k in calls}
    for _ in range(2):
        for k, call in calls.items():
            times[k].append(cuda_ms(call, reps))
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=SERVE_BATCH)
    ap.add_argument("--seq", type=int, default=SERVE_SEQ)
    ap.add_argument("--softcaps", type=float, nargs="+", default=[50.0, 0.0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--split", action="store_true",
                    help="time the kernel with each part left out (at the first softcap)")
    ap.add_argument("--against", metavar="LIB",
                    help="time LIB's float32 entry in turns with this build's")
    ap.add_argument("--mma-rate", action="store_true",
                    help="measure the tensor cores' rate through mma.sync alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    H, KV, hd = (ATTENTION_LAYER[k] for k in ("heads", "kv_heads", "head_dim"))
    B, S = args.batch, args.seq
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    card = card_name()
    lib = load_library()
    ptxas = tuple(ln for ln in lib.info.ptxas if "flash_tf32_kernel" in ln)
    sass = {op: build.sass_counts(lib.info.path, "flash_tf32_kernel", op)
            for op in ("HMMA", "HGMMA", "FFMA")}
    fb = attention_fp32_bound(S, **ATTENTION_LAYER, batch=B)
    print(f"card: {card}; float32 q, k, v ({B}, {S}, {H}|{KV}, {hd}), causal; "
          f"bound {fb['ms']:.4f} ms ({fb['by']}: {fb['flops'] / 1e12:.4f} TFLOP as one "
          f"dense TF32 product, {fb['bytes'] / 1e6:.1f} MB), the three TF32 products "
          f"{fb['work_tf32_ms']:.4f} ms, the fp32 CUDA cores {fb['fp32_ms']:.4f} ms")
    for line in ptxas:
        print(f"  ptxas {line}")
    print("  SASS: " + "; ".join(f"{op} " + ", ".join(
        f"hd {re.search(r'ILi(\d+)E', f).group(1)} {n}" for f, n in c.items())
        for op, c in sass.items()))
    mix = sass_mix(lib.info.path, hd)
    print(f"  SASS opcodes at hd {hd}: " + ", ".join(f"{op} {n}" for op, n in mix.items()))
    result = {"card": card, "shape": [B, S, H, KV, hd], "bound": fb, "ptxas": ptxas,
              "sass": sass, "sass_mix": mix}
    for cap in args.softcaps:
        call = lambda: ops.flash_attention(q, k, v, softcap=cap)  # noqa: E731
        a, b = call(), call()
        ref = flash_attention.plain(q, k, v, softcap=cap)
        err = (a - ref).abs().max().item()
        rep = dict(ms=cuda_ms(call, args.reps), err=err, bit_equal=bool(torch.equal(a, b)),
                   plain_ms=cuda_ms(lambda: flash_attention.plain(q, k, v, softcap=cap),
                                    reps=1, warmup=0))
        msg = ""
        if cap == 0.0:
            sdpa, backend = sdpa_f32(q, k, v)
            lib_err = (a - sdpa()).abs().max().item()
            rep.update(library_ms=cuda_ms(sdpa, 3, warmup=1), library_err=lib_err,
                       library_backend=backend)
            msg = (f"; scaled_dot_product_attention float32 ({backend} backend) "
                   f"{rep['library_ms']:.3f} ms, max |kernel - sdpa| {lib_err:.3e}")
        print(f"softcap {cap:g}: kernel {rep['ms']:.4f} ms "
              f"({fb['flops'] / rep['ms'] / 1e9:.2f} TFLOP/s, bound {fb['ms']:.4f} ms); "
              f"max |kernel - plain| {err:.3e} (limit 2e-5); two calls bit-equal "
              f"{rep['bit_equal']}; plain {rep['plain_ms']:.3f} ms{msg}")
        if args.against:
            other = torch.empty_like(q)
            theirs = launcher(_bind(args.against), q, k, v, other, cap)
            ours = lambda: ops.flash_attention(q, k, v, softcap=cap)  # noqa: E731
            turns = [cuda_ms(f, args.reps) for f in (theirs, ours, ours, theirs)]
            theirs()
            rep.update(against=args.against, turns=turns,
                       against_diff=(a - other).abs().max().item())
            print(f"  against {args.against}: theirs, ours, ours, theirs "
                  f"{', '.join(f'{t:.4f}' for t in turns)} ms; max |ours - theirs| "
                  f"{rep['against_diff']:.3e}")
        result[f"softcap {cap:g}"] = rep
        assert err <= 2e-5, (cap, err)
    if args.mma_rate:
        result["mma_rate"] = mma_rate()
        for line in result["mma_rate"]:
            print(f"  mma.sync: {line}")
    if args.split:
        result["split"] = split_times((q, k, v), args.softcaps[0], args.reps)
        for k_, ms in result["split"].items():
            print(f"  split at softcap {args.softcaps[0]:g}, {k_}: "
                  f"{', '.join(f'{t:.4f}' for t in ms)} ms")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
