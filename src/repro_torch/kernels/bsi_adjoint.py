"""The BSI adjoint: the CUDA kernels' launches and their plain versions.

The kernels (``csrc/bsi_adjoint.cu``) replace the JAX package's Pallas
kernels in ``repro/kernels/bsi_adjoint.py``, masking the voxels outside the
volume instead of padding:

``bsi_adjoint_separable_pallas``  three gather sweeps (z, then y, then x)
    contract the cotangent of the dense field against the ``(d, 4)`` weight
    LUTs (:func:`launch`, :func:`plain`);
``bsi_adjoint_matmul_pallas``  each tile's cotangent contracted against the
    ``(d^3, 64)`` Kronecker basis into 64 bands, then the bands overlap-added
    onto the control points (:func:`launch_matmul`, :func:`plain_matmul`).

``kernels.ops.bsi_adjoint`` and ``kernels.ops.bsi_adjoint_matmul`` pick
between a kernel and its plain version by the tensor's device.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.bspline import weight_lut
from repro_torch.core.interpolate import bsi_adjoint, bsi_adjoint_matmul
from repro_torch.core.interpolate import _pad_to_tiles
from repro_torch.kernels import bsi_matmul, bsi_ttli
from repro_torch.kernels.build import load_library

__all__ = ["weight_luts", "launch", "plain", "check_blocks_matmul", "launch_matmul",
           "plain_matmul"]


@functools.lru_cache(maxsize=None)
def weight_luts(tile, device) -> tuple:
    """The three ``(d, 4)`` float32 weight LUTs on ``device``."""
    return tuple(weight_lut(d, torch.float32, device) for d in tile)


def launch(g, out, tile):
    """Launch the three sweeps on the current stream: ``g`` -> ``out``.

    The two intermediates, ``(X, Y, Nz, C)`` and ``(X, Ny, Nz, C)``, are
    allocated here; PyTorch's caching allocator reuses their memory only for
    work queued after these launches on the same stream.
    """
    X, Y, Z, c = g.shape
    nx, ny, nz, _ = out.shape
    hz = torch.empty((X, Y, nz, c), dtype=torch.float32, device=g.device)
    hy = torch.empty((X, ny, nz, c), dtype=torch.float32, device=g.device)
    wx, wy, wz = weight_luts(tile, g.device)
    lib = load_library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = lib.bsi_adjoint_f32(
            g.data_ptr(), wx.data_ptr(), wy.data_ptr(), wz.data_ptr(),
            hz.data_ptr(), hy.data_ptr(), out.data_ptr(),
            X, Y, Z, c, nx, ny, nz, *tile, stream)
    if rc:
        raise RuntimeError(f"bsi_adjoint kernel launch failed: cudaError_t {rc}")


def plain(g, tile, grid_shape):
    """The kernel's function in tensor ops: zero-pad to whole tiles, then
    :func:`repro_torch.core.interpolate.bsi_adjoint_separable`."""
    return bsi_adjoint(g, tile, grid_shape, impl="torch")


def check_blocks_matmul(tile, blocks, channels):
    """Raise if the first matmul launch's basis and staged cotangents exceed
    what a block may use."""
    nv = tile[0] * tile[1] * tile[2]
    bsi_ttli.check_smem(f"the matmul adjoint at tile {tile} with {channels} channels",
                        4 * nv * (64 + blocks[0] * blocks[1] * blocks[2] * channels))


def launch_matmul(g, out, tile):
    """Launch the two matmul-adjoint passes on the current stream: ``g`` ->
    ``out``.  The ``(tiles, C, 64)`` band scratch is allocated here."""
    X, Y, Z, c = g.shape
    nx, ny, nz, _ = out.shape
    blocks = bsi_ttli.block_tiles(tile)
    check_blocks_matmul(tile, blocks, c)
    tiles = 1  # tiles that hold voxels of the volume
    for s, d in zip((X, Y, Z), tile):
        tiles *= -(-s // d)
    c4 = torch.empty(tiles * c * 64, dtype=torch.float32, device=g.device)
    lib = load_library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = lib.bsi_adjoint_matmul_f32(
            g.data_ptr(), bsi_matmul.basis(tile, g.device).data_ptr(), c4.data_ptr(),
            out.data_ptr(), X, Y, Z, c, nx, ny, nz, *tile, *blocks, stream)
    if rc:
        raise RuntimeError(f"bsi_adjoint_matmul kernel launch failed: cudaError_t {rc}")


def plain_matmul(g, tile, grid_shape):
    """The matmul kernels' function in tensor ops: zero-pad to whole tiles,
    then :func:`repro_torch.core.interpolate.bsi_adjoint_matmul`."""
    with torch.no_grad():
        return bsi_adjoint_matmul(_pad_to_tiles(g, tile, grid_shape), tile)
