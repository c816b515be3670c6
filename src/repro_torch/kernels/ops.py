"""Dispatchers of the hand-written kernels: checks, allocation, launch, count.

Each dispatcher takes tensors in the JAX package's channels-last layout.  On a
CPU tensor it runs its kernel's plain PyTorch version; on a CUDA tensor it
checks device, dtype (float32), shape and contiguity, allocates the outputs
with ``torch.empty``, launches the kernel on the current stream, raises if
the launch failed, and adds one to its ``launches`` count.  There is no
fallback: a CUDA tensor runs the kernel or raises.

The JAX package's VMEM budget and its volume-in-VMEM gate of the fused
kernel describe a TPU and are not carried over; the kernels pick their own
block sizes from shared memory (``kernels.bsi_ttli.block_tiles``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bsi_adjoint as _adjoint
from repro_torch.kernels import bsi_fused as _fused
from repro_torch.kernels import bsi_ttli as _ttli

__all__ = [
    "bsi_ttli",
    "bsi_adjoint",
    "fused_ssd_loss",
    "launch_counts",
    "reset_launch_counts",
]


def _on_card(t, name) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for anything else."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def _check(t, name, ndim, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _covers(grid_shape, tile, vol_shape, name):
    for n, d, s in zip(grid_shape, tile, vol_shape):
        if not 1 <= s <= (n - 3) * d:
            raise ValueError(
                f"{name}: control grid {tuple(grid_shape)} at tile {tile} does "
                f"not cover volume {tuple(vol_shape)}"
            )


def bsi_ttli(phi, tile, vol_shape=None):
    """Forward BSI, TTLI form, cropped to ``vol_shape`` (default: whole tiles).

    ``phi``: ``(Nx, Ny, Nz, C)`` control grid.  Returns the
    ``vol_shape + (C,)`` dense field.
    """
    tile = tuple(int(d) for d in tile)
    full = tuple((int(n) - 3) * d for n, d in zip(phi.shape[:3], tile))
    vol_shape = full if vol_shape is None else tuple(int(s) for s in vol_shape)
    _covers(phi.shape[:3], tile, vol_shape, "bsi_ttli")
    if not _on_card(phi, "bsi_ttli"):
        return _ttli.plain(phi, tile, vol_shape)
    _check(phi, "phi", 4, phi.device)
    blocks = _ttli.block_tiles(tile)
    _ttli.check_blocks(tile, blocks, phi.shape[3])
    out = torch.empty(vol_shape + (phi.shape[3],), dtype=torch.float32,
                      device=phi.device)
    _ttli.launch(phi, out, tile, blocks)
    bsi_ttli.launches += 1
    return out


def bsi_adjoint(g, tile, grid_shape):
    """BSI adjoint: cotangent of the cropped field -> control-grid cotangent.

    ``g``: ``(X, Y, Z, C)`` with ``X <= (Nx - 3) * dx`` and so on; the voxels
    past the volume count as zero.  Returns ``grid_shape + (C,)`` float32.
    """
    tile = tuple(int(d) for d in tile)
    grid_shape = tuple(int(n) for n in grid_shape)
    _covers(grid_shape, tile, g.shape[:3], "bsi_adjoint")
    if not _on_card(g, "bsi_adjoint"):
        return _adjoint.plain(g, tile, grid_shape)
    _check(g, "g", 4, g.device)
    out = torch.empty(grid_shape + (g.shape[3],), dtype=torch.float32,
                      device=g.device)
    _adjoint.launch(g, out, tile)
    bsi_adjoint.launches += 1
    return out


def fused_ssd_loss(phi, moving, fixed, tile):
    """``mean((warp(moving, bsi(phi)) - fixed)**2)`` without a dense field.

    The fused level step's forward, SSD only; the differentiable face is
    ``repro_torch.core.ffd.fused_warp_loss``.  Returns a 0-dim float32 tensor.
    """
    tile = tuple(int(d) for d in tile)
    if moving.shape != fixed.shape:
        raise ValueError(
            f"shape mismatch: {tuple(fixed.shape)} vs {tuple(moving.shape)}")
    if phi.dim() != 4 or phi.shape[3] != 3:
        raise ValueError(f"phi must be (Nx, Ny, Nz, 3), got {tuple(phi.shape)}")
    _covers(phi.shape[:3], tile, moving.shape, "fused_ssd_loss")
    n = moving.numel()
    if not _on_card(phi, "fused_ssd_loss"):
        return _fused.plain(phi, moving, fixed, tile) / n
    _check(phi, "phi", 4, phi.device)
    _check(moving, "moving", 3, phi.device)
    _check(fixed, "fixed", 3, phi.device)
    blocks = _ttli.block_tiles(tile)
    _ttli.check_blocks(tile, blocks, 3)
    total = _fused.launch(phi, moving, fixed, tile, blocks)
    fused_ssd_loss.launches += 1
    return total / n


_DISPATCHERS = {"bsi_ttli": bsi_ttli, "bsi_adjoint": bsi_adjoint,
                "bsi_fused": fused_ssd_loss}


def reset_launch_counts():
    """Set every dispatcher's launch count to 0."""
    for fn in _DISPATCHERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset."""
    return {name: fn.launches for name, fn in _DISPATCHERS.items()}


reset_launch_counts()
