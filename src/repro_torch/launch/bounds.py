"""The least time an H100 could take for each BSI kernel of the JAX package.

    PYTHONPATH=src python -m repro_torch.launch.bounds [--shape X Y Z] [--tile D D D]

For a volume and tile (default: the paper's phantom1, 512 x 228 x 385, tile
5^3, 3 channels) it counts, from the shapes alone, the bytes each kernel must
move (each input read once, each output written once) and the float32
operations its algorithm does, and prints the larger of bytes / 3.35 TB/s and
operations / 67 TFLOP/s (H100 SXM fp32 outside the tensor cores) with which
of the two bounds it.  ``chip_smoke.py`` uses the same counts for the
ported kernels.  Pure arithmetic: it needs no card.
"""

from __future__ import annotations

import argparse

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
PHANTOM1 = (512, 228, 385)

__all__ = ["kernel_bounds", "bound_ms"]


def bound_ms(bytes_moved, flops):
    """``(ms, "bytes" | "operations")``: the larger of the two times."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bounds(vol_shape, tile, channels=3) -> dict:
    """``name -> (bytes, flops)`` for the BSI kernels at ``vol_shape``."""
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
    return {
        "bsi_ttli": (grid_b + field_b, ttli),
        "bsi_adjoint_separable": (field_b + grid_b, adjoint),
        "bsi_fused_ssd": (grid_b + 2 * vol_b + 4, ttli + sample_score),
        "bsi_fused_stats": (grid_b + vol_b + 16, ttli + sample_score),
        "bsi_matmul": (grid_b + field_b, dense64),
        "bsi_adjoint_matmul": (field_b + grid_b, dense64),
        "bsi_separable": (grid_b + field_b, separable),
        "bsi_tt": (grid_b + field_b, dense64),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, default=PHANTOM1)
    ap.add_argument("--tile", type=int, nargs=3, default=(5, 5, 5))
    ap.add_argument("--channels", type=int, default=3)
    args = ap.parse_args(argv)
    print(f"volume {tuple(args.shape)}, tile {tuple(args.tile)}, "
          f"{args.channels} channels; H100 SXM 3.35 TB/s, 67 TFLOP/s fp32")
    for name, (b, f) in kernel_bounds(args.shape, args.tile, args.channels).items():
        ms, by = bound_ms(b, f)
        print(f"{name:24s} {b / 1e6:9.1f} MB {f / 1e9:8.2f} GFLOP  "
              f"bound {ms:.4f} ms ({by})")


if __name__ == "__main__":
    main()
