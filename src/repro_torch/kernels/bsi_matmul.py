"""Forward BSI in the matrix form: the CUDA kernel's launch and its plain version.

The kernel (``csrc/bsi_matmul.cu``) replaces the JAX package's Pallas kernel
``repro/kernels/bsi_matmul.py:bsi_matmul_pallas``.  A thread block owns a
block of tiles and stages its control window and the ``(d^3, 64)`` Kronecker
basis in shared memory; each output value is the 64-term sum
``sum_k B[v, k] * window[tile + (l, m, n)]`` in the order
``k = (l*4 + m)*4 + n``, and only the voxels inside the volume are written.
:func:`plain` is the same sum in tensor ops, term by term in that order;
``kernels.ops.bsi_matmul`` picks between the two by the tensor's device.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.bspline import basis_matrix
from repro_torch.kernels.build import load_library
from repro_torch.kernels.bsi_ttli import check_smem

__all__ = ["basis", "block_tiles", "check_blocks", "launch", "plain", "smem_bytes"]


@functools.lru_cache(maxsize=None)
def basis(tile, device) -> torch.Tensor:
    """The ``(d^3, 64)`` float32 basis on ``device`` (float64, cast once)."""
    return basis_matrix(tile, torch.float32, device).contiguous()


def block_tiles(tile) -> tuple:
    """Tiles per thread block: 4 x 4 x 16, so a block of 256 threads owns
    3 (tile, channel) pairs each at 3 channels, whatever the tile."""
    return (4, 4, 16)


def smem_bytes(tile, blocks, channels) -> int:
    """Shared memory of a block: the basis and the control window."""
    (dx, dy, dz), (bx, by, bz) = tile, blocks
    return 4 * (64 * dx * dy * dz + (bx + 3) * (by + 3) * (bz + 3) * channels)


def check_blocks(tile, blocks, channels):
    """Raise if a block's basis and window exceed what a block may use."""
    check_smem(f"the matmul kernel at tile {tile}", smem_bytes(tile, blocks, channels))


def launch(phi, out, tile):
    """Launch the kernel on the current stream: ``phi`` -> ``out`` (cropped);
    raises if its blocks do not fit."""
    nx, ny, nz, c = phi.shape
    X, Y, Z, _ = out.shape
    blocks = block_tiles(tile)
    check_blocks(tile, blocks, c)
    lib = load_library()
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        rc = lib.bsi_matmul_f32(
            phi.data_ptr(), basis(tile, phi.device).data_ptr(), out.data_ptr(),
            nx, ny, nz, c, *tile, X, Y, Z, *blocks, stream)
    if rc:
        raise RuntimeError(f"bsi_matmul kernel launch failed: cudaError_t {rc}")


def plain(phi, tile, vol_shape):
    """The kernel's function in tensor ops, cropped to ``vol_shape``: the 64
    terms ``B[v, k] * window[k]`` added one at a time, ``k`` in order, each
    product and sum rounded to float32 (the fused kernels, built without
    FMA contraction, round the same way)."""
    tile = tuple(int(d) for d in tile)
    dx, dy, dz = tile
    tx, ty, tz = (int(n) - 3 for n in phi.shape[:3])
    c = phi.shape[3]
    X, Y, Z = vol_shape
    b = basis(tile, phi.device)
    with torch.no_grad():
        acc = torch.zeros((tx, dx, ty, dy, tz, dz, c), dtype=torch.float32,
                          device=phi.device)
        for k in range(64):
            l, m, n = k >> 4, (k >> 2) & 3, k & 3
            sl = phi[l:l + tx, m:m + ty, n:n + tz][:, None, :, None, :, None, :]
            acc = acc + b[:, k].reshape(1, dx, 1, dy, 1, dz, 1) * sl
        return acc.reshape(tx * dx, ty * dy, tz * dz, c)[:X, :Y, :Z]
