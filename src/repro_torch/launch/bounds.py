"""The least time an H100 could take for each BSI kernel of the JAX package.

    PYTHONPATH=src python -m repro_torch.launch.bounds [--shape X Y Z] [--tile D D D]
        [--bins B] [--batch B] [--seq S]

For a volume and tile (default: the paper's phantom1, 512 x 228 x 385, tile
5^3, 3 channels) it counts, from the shapes alone, the bytes each kernel must
move (each input read once, each output written once) and the float32
operations the function it computes needs: the least among the forms that
compute it (the forward BSI's four forms and the two adjoints each compute
one function, so a form's own cost, such as the 64 multiply-adds per output
of the TT and matrix forms, is not its bound), and prints the larger of bytes / 3.35 TB/s and
operations / 67 TFLOP/s (H100 SXM fp32 outside the tensor cores) with which
of the two bounds it; and the same for gemma2-2b's global and local
attention layers (989 TFLOP/s bf16 on the tensor cores) at ``--batch``
prompts of ``--seq`` tokens, and in float32 (:func:`attention_fp32_bound`:
one dense TF32 product at 495 TFLOP/s, the kernel's three TF32 products and
the float32 CUDA cores' time printed beside).  The fused NMI kernel's histogram is also
bound by the least of its forms (:func:`nmi_bound`): one dense product on
the tensor cores (495 TFLOP/s TF32) or the products of the non-zero Parzen
weights only, the weights at the bins it evaluates; and its work as the
kernel does it, three TF32 products, is printed beside.  The TT and matrix
forms that round as their plain versions, each product and sum apart
(``bsi_tt`` and the fused matrix-form ssd, stats and ncc), are printed with
their own floor beside: their fp32 instructions issued at one warp
instruction a clock on each scheduler (:func:`unfused_floor_ms`).
``chip_smoke.py`` uses the same counts for the ported kernels.  Pure
arithmetic: it needs no card.
"""

from __future__ import annotations

import argparse

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_FLOP_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
PHANTOM1 = (512, 228, 385)
# gemma2-2b's attention layer (src/repro_torch/configs/gemma2_2b.py): 8 query
# heads, 4 key/value heads, head dim 256, causal; global layers attend to
# every earlier token, local ones to a 4096-token window.  The serving
# cell's prefill: 4 prompts of 8160 tokens.
ATTENTION_LAYER = dict(heads=8, kv_heads=4, head_dim=256, causal=True)
GEMMA_WINDOW = 4096
SERVE_BATCH, SERVE_SEQ = 4, 8160
# a Parzen weight: subtract, divide, square, scale, exp, its share of the
# row sum and its normalising divide
NMI_WEIGHT_OPS = 7
H100_SMS, SCHEDULERS_PER_SM = 132, 4
SM_CLOCK_HZ = 1.98e9  # the SM clock under load of the cards measured (nvidia-smi)
# the TT and matrix forms unfused: a product and a sum for each of 64 terms
# and 3 channels, a voxel
UNFUSED_INSTRUCTIONS = 2 * 64 * 3

__all__ = ["attention_bound", "attention_fp32_bound", "attention_pairs", "kernel_bounds",
           "bound_ms", "matmul_tf32_ms", "nmi_bound", "unfused_floor_ms"]


def bound_ms(bytes_moved, flops, flop_per_s=FP32_FLOP_PER_S, tf32_flops=0):
    """``(ms, "bytes" | "operations")``: the larger of the bytes' time and
    the operations' (``flops`` at ``flop_per_s``; ``tf32_flops`` on the
    tensor cores, whose time may overlap the other pipes')."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / flop_per_s, tf32_flops / TF32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_pairs(seq, *, causal, window=0) -> int:
    """The (query, key) pairs over ``seq`` positions that the mask keeps:
    causal ``k <= q``; a window ``k > q - window`` (0: none)."""
    total = 0
    for q in range(seq):
        lo = max(0, q - window + 1) if window > 0 else 0
        total += (q + 1 if causal else seq) - lo
    return total


def attention_bound(seq, *, heads, kv_heads, head_dim, causal, window=0, batch=1,
                    itemsize=2):
    """``(bytes, flops)`` of one attention layer over ``batch`` sequences of
    ``seq`` tokens: q, k, v read and the output written once; ``QK^T`` and
    ``PV`` at 2 flops per multiply-add for each pair of
    :func:`attention_pairs`."""
    moved = itemsize * batch * seq * head_dim * (2 * heads + 2 * kv_heads)
    pairs = attention_pairs(seq, causal=causal, window=window)
    return moved, 4 * head_dim * heads * batch * pairs


def attention_fp32_bound(seq, *, heads, kv_heads, head_dim, causal, window=0,
                         batch=1) -> dict:
    """The float32 attention layer's bound, as the nmi kernel's: its two
    products as one dense TF32 product on the tensor cores (the flops of
    :func:`attention_bound` at 495 TFLOP/s) against the float32 q, k, v and
    output read and written once.  Returns ``ms`` and ``by`` (``"bytes"`` or
    ``"operations"``), ``bytes`` and ``flops``, and beside them
    ``work_tf32_ms``, the three TF32 products of the kernel's 3xTF32 split
    at 495 TFLOP/s (the work it does rather than a bound), and
    ``fp32_ms``, the flops on the float32 CUDA cores at 67 TFLOP/s (the
    floor of a kernel without the tensor cores)."""
    moved, flops = attention_bound(seq, heads=heads, kv_heads=kv_heads, head_dim=head_dim,
                                   causal=causal, window=window, batch=batch, itemsize=4)
    ms, by = bound_ms(moved, 0, tf32_flops=flops)
    return dict(ms=ms, by=by, bytes=moved, flops=flops,
                work_tf32_ms=3 * flops / TF32_FLOP_PER_S * 1e3,
                fp32_ms=flops / FP32_FLOP_PER_S * 1e3)


def nmi_bound(vol_shape, tile, bins=32, *, evaluated=None, products=None, channels=3,
              support=8) -> dict:
    """The fused NMI kernel's bound, the least over the forms that compute
    its function.  Each form moves the bytes of :func:`kernel_bounds`'
    ``bsi_fused_nmi`` and does its displacement, sample and normalisation,
    and 7 fp32 operations for each Parzen weight evaluated (``evaluated`` of
    them over both volumes; default ``2 min(bins, 2 support + 1)`` a voxel,
    the most at the half-width ``support`` of
    ``kernels.bsi_fused.nmi_support``, 8 at the default sigma).  Its
    histogram is either one dense ``(bins, V) . (V, bins)`` product on the
    tensor cores (``2 bins^2`` flops a voxel at 495 TFLOP/s TF32, beside the
    fp32 pipes) or the multiply-adds of the non-zero weight pairs only
    (``products`` of them, counted from the data; default ``min(bins, 2
    support + 1)^2`` a voxel) on the fp32 pipes.

    Returns ``ms``, ``by`` (``"bytes"`` or ``"operations"``) and ``form``
    (``"dense TF32"`` or ``"non-zero fp32"``) of the least form, each
    form's ``(ms, by)``, the counts, and ``work_tf32_ms``: the three TF32
    products of the kernel's 3xTF32 split at 495 TFLOP/s, the work it does
    rather than a bound."""
    vox = vol_shape[0] * vol_shape[1] * vol_shape[2]
    moved, old = kernel_bounds(vol_shape, tile, channels, bins)["bsi_fused_nmi"]
    width = min(bins, 2 * support + 1)
    evaluated = 2 * width * vox if evaluated is None else evaluated
    products = width * width * vox if products is None else products
    # kernel_bounds' count less its weights (2 bins a voxel) and histogram
    rest = (old - (2 * NMI_WEIGHT_OPS * bins + 2 * bins * bins) * vox
            + NMI_WEIGHT_OPS * evaluated)
    dense_tf32 = 2 * bins * bins * vox
    forms = {"dense TF32": bound_ms(moved, rest, tf32_flops=dense_tf32),
             "non-zero fp32": bound_ms(moved, rest + 2 * products)}
    form = min(forms, key=lambda k: forms[k][0])
    return dict(ms=forms[form][0], by=forms[form][1], form=form, forms=forms,
                bytes=moved, fp32_flops=rest, dense_tf32_flops=dense_tf32,
                products=products, evaluated=evaluated,
                work_tf32_ms=3 * dense_tf32 / TF32_FLOP_PER_S * 1e3)


def unfused_floor_ms(vol_shape) -> float:
    """The least time of the TT and matrix forms rounded as their plain
    versions, no multiply-add fused: :data:`UNFUSED_INSTRUCTIONS` fp32
    instructions a voxel, each voxel's own, at one warp instruction a clock
    on each scheduler of the H100's SMs at :data:`SM_CLOCK_HZ`.  Not a bound
    of the function (another form needs less): the floor of the form that
    keeps the plain version's bits."""
    vox = vol_shape[0] * vol_shape[1] * vol_shape[2]
    return vox * UNFUSED_INSTRUCTIONS / 32 / (H100_SMS * SCHEDULERS_PER_SM) / SM_CLOCK_HZ * 1e3


def matmul_tf32_ms(vol_shape, tile, channels=3, max_columns=48) -> tuple:
    """``(mma, GFLOP, ms)``: the matrix-form kernel's own three TF32
    products (``csrc/bsi_matmul.cu``) at 495 TFLOP/s: m16n8k8 ``mma.sync``
    over ``d^3`` padded to whole m16 tiles, each unit's ``zt * c`` columns
    padded to whole n8 tiles, 8 k-steps, 3 products each; ``zt`` as
    ``kernels.bsi_matmul.matmul_blocks`` takes it where the staging fits
    (``max_columns // c`` z tiles)."""
    dx, dy, dz = tile
    tx, ty, tz = (-(-s // d) for s, d in zip(vol_shape, tile))
    zt = min(tz, max(1, max_columns // channels))
    n_tiles = sum(-(-min(zt, tz - k) * channels // 8) for k in range(0, tz, zt))
    mma = tx * ty * n_tiles * -(-dx * dy * dz // 16) * 8 * 3
    flops = mma * 2 * 16 * 8 * 8
    return mma, flops / 1e9, flops / TF32_FLOP_PER_S * 1e3


def kernel_bounds(vol_shape, tile, channels=3, bins=32, window=9) -> dict:
    """``name -> (bytes, flops)`` for the BSI kernels at ``vol_shape``;
    ``bins`` is the NMI histogram width, ``window`` the LNCC window."""
    X, Y, Z = vol_shape
    dx, dy, dz = tile
    tx, ty, tz = (-(-s // d) for s, d in zip(vol_shape, tile))
    nx, ny, nz = tx + 3, ty + 3, tz + 3
    c = channels
    vox = X * Y * Z
    grid_b = 4 * nx * ny * nz * c
    field_b = 4 * vox * c
    vol_b = 4 * vox
    # the staged lerp DAG: x stage on (X, ty+3, tz+3), y on (X, Y, tz+3),
    # z on (X, Y, Z); 3 lerps of 2 flops each per value and channel
    ttli = 2 * 3 * c * (X * (ty + 3) * (tz + 3) + X * Y * (tz + 3) + vox)
    # separable sweeps: 4 multiply-adds per value of each stage
    separable = 2 * 4 * c * (X * (ty + 3) * (tz + 3) + X * Y * (tz + 3) + vox)
    # the adjoint's sweeps: 4*d multiply-adds per intermediate value
    adjoint = 2 * 4 * c * (X * Y * nz * dz + X * ny * nz * dy + nx * ny * nz * dx)
    dense64 = 2 * 64 * c * vox  # a 64-term weighted sum per voxel and channel
    sample_score = 30 * vox  # clamp, 8 taps, 7 lerps, squared difference
    ncc_score = 8 * vox  # two centrings, three multiply-adds
    # per voxel: both intensities normalised (2 ops each); per volume and bin a
    # Parzen weight; the bins^2 multiply-adds of the histogram
    nmi_score = (4 + 2 * NMI_WEIGHT_OPS * bins + 2 * bins * bins) * vox
    # per voxel: three products, five separable box sums of `window` adds per
    # axis, and the local cc (about a dozen ops)
    lncc_score = (3 + 5 * 3 * window + 12) * vox
    # the fused variants: (bytes, operations besides the displacement's)
    fused = {
        "ssd": (grid_b + 2 * vol_b + 4, sample_score),
        "stats": (grid_b + vol_b + 16, sample_score),
        "ncc": (grid_b + 2 * vol_b + 8 + 12, sample_score + ncc_score),
        "nmi": (grid_b + 2 * vol_b + 16 + 4 * bins + 4 * bins * bins,
                sample_score + nmi_score),
        "lncc": (grid_b + 2 * vol_b + 8, sample_score + lncc_score),
    }
    # every form of one function is bound by the least work among them
    forward = min(ttli, separable, dense64)
    backward = min(adjoint, dense64)
    # the matrix form's displacement also reads the (d^3, 64) basis
    basis_b = 4 * 64 * dx * dy * dz
    return {
        "bsi_ttli": (grid_b + field_b, forward),
        "bsi_adjoint_separable": (field_b + grid_b, backward),
        **{f"bsi_fused_{k}": (b, forward + f) for k, (b, f) in fused.items()},
        **{f"bsi_fused_{k}_matmul": (b + basis_b, forward + f)
           for k, (b, f) in fused.items()},
        "bsi_matmul": (grid_b + field_b, forward),
        "bsi_adjoint_matmul": (field_b + grid_b, backward),
        "bsi_separable": (grid_b + field_b, forward),
        "bsi_tt": (grid_b + field_b, forward),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, default=PHANTOM1)
    ap.add_argument("--tile", type=int, nargs=3, default=(5, 5, 5))
    ap.add_argument("--channels", type=int, default=3)
    ap.add_argument("--bins", type=int, default=32, help="NMI histogram width")
    ap.add_argument("--batch", type=int, default=SERVE_BATCH, help="attention batch")
    ap.add_argument("--seq", type=int, default=SERVE_SEQ, help="attention sequence length")
    args = ap.parse_args(argv)
    print(f"volume {tuple(args.shape)}, tile {tuple(args.tile)}, "
          f"{args.channels} channels, {args.bins} NMI bins; H100 SXM 3.35 TB/s, "
          "67 TFLOP/s fp32")
    bounds = kernel_bounds(args.shape, args.tile, args.channels, args.bins)
    for name, (b, f) in bounds.items():
        ms, by = bound_ms(b, f)
        print(f"{name:24s} {b / 1e6:9.1f} MB {f / 1e9:8.2f} GFLOP  "
              f"bound {ms:.4f} ms ({by})")
    nb = nmi_bound(args.shape, args.tile, args.bins, channels=args.channels)
    print(f"{'bsi_fused_nmi (least)':24s} {nb['bytes'] / 1e6:9.1f} MB "
          f"{nb['fp32_flops'] / 1e9:8.2f} GFLOP  bound {nb['ms']:.4f} ms ({nb['by']}, "
          f"{nb['form']}); the weights at 2 x {min(args.bins, 17)} bins a voxel (the "
          "default sigma), the histogram by the least of: " + ", ".join(
              f"{k} {ms:.4f} ms" for k, (ms, _) in nb["forms"].items())
          + f" (at most {nb['products'] / 1e9:.2f} G non-zero pairs); the kernel's "
          f"three TF32 products {nb['work_tf32_ms']:.4f} ms")
    floor = unfused_floor_ms(args.shape)
    print(f"{'bsi_tt, fused *_matmul':24s} the form unfused: {UNFUSED_INSTRUCTIONS} fp32 "
          f"instructions a voxel, {floor:.4f} ms at one warp instruction a clock a "
          f"scheduler, {H100_SMS} SMs, {SM_CLOCK_HZ / 1e9:.2f} GHz")
    mma, gflop, ms = matmul_tf32_ms(args.shape, args.tile, args.channels)
    print(f"{'bsi_matmul (own work)':24s} three TF32 products: {mma / 1e6:.2f} M "
          f"mma.sync m16n8k8, {gflop:.2f} GFLOP, {ms:.4f} ms at 495 TFLOP/s")
    for layer, window in (("global", 0), ("local", GEMMA_WINDOW)):
        b, f = attention_bound(args.seq, **ATTENTION_LAYER, window=window,
                               batch=args.batch)
        ms, by = bound_ms(b, f, BF16_FLOP_PER_S)
        pairs = attention_pairs(args.seq, causal=True, window=window)
        print(f"{'flash_attention ' + layer:24s} {b / 1e6:9.1f} MB {f / 1e9:8.2f} GFLOP  "
              f"bound {ms:.4f} ms ({by}); gemma2-2b {layer} layer {ATTENTION_LAYER}, "
              f"window {window}, batch {args.batch}, sequence {args.seq}, {pairs} pairs "
              "per head, bf16, 989 TFLOP/s")
        fb = attention_fp32_bound(args.seq, **ATTENTION_LAYER, window=window,
                                  batch=args.batch)
        print(f"{'  float32':24s} {fb['bytes'] / 1e6:9.1f} MB {fb['flops'] / 1e9:8.2f} GFLOP  "
              f"bound {fb['ms']:.4f} ms ({fb['by']}, one dense TF32 product at 495 "
              f"TFLOP/s); the kernel's three TF32 products {fb['work_tf32_ms']:.4f} ms; "
              f"on the fp32 CUDA cores {fb['fp32_ms']:.4f} ms")

if __name__ == "__main__":
    main()
