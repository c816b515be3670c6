"""Forward BSI in the separable form: the CUDA kernel's launch and its plain version.

The kernel (``csrc/bsi_separable.cu``) replaces the JAX package's Pallas
kernel ``repro/kernels/bsi_separable.py:bsi_separable_pallas``.  It is the
TTLI kernel's device code (``csrc/bsi_forward.cuh``) and blocks
(``kernels.bsi_ttli.forward_blocks``) with the three ``(d, 4)`` weight LUTs
in place of the lerp LUTs: the x, y and z sweeps of
:func:`repro_torch.core.interpolate.bsi_separable`, each output a 4-term
weighted sum of the previous stage, writing only the voxels inside the
volume.  :func:`plain` is the same function in tensor ops;
``kernels.ops.bsi_separable`` picks between the two by the tensor's device.
A bf16 or fp16 grid runs ``bsi_separable_bf16`` or ``bsi_separable_f16``:
the grid and LUTs of its dtype, float32 sweeps, one rounding at the store, a
field of its dtype (the JAX package's kernel likewise contracts reduced
operands into float32 and casts once,
``repro/kernels/bsi_separable.py:37-57``).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.bspline import weight_lut
from repro_torch.core.interpolate import bsi_separable
from repro_torch.kernels import bsi_ttli

__all__ = ["launch", "plain", "weight_luts"]


@functools.lru_cache(maxsize=None)
def weight_luts(tile, device, dtype=torch.float32) -> torch.Tensor:
    """The ``(d, 4)`` weight LUTs of x, then y, then z, rounded to ``dtype``
    and flattened into one float32 tensor on ``device``."""
    return torch.cat([weight_lut(d, dtype, device).float().reshape(-1) for d in tile])


def launch(phi, out, tile, lib=None):
    """Launch the kernel on the current stream: ``phi`` -> ``out`` (cropped);
    ``lib`` a measurement build (default: the kernels as built)."""
    bsi_ttli.launch_forward("bsi_separable", phi,
                            weight_luts(tuple(tile), phi.device, phi.dtype), out, tile, lib)


def plain(phi, tile, vol_shape):
    """The kernel's function in tensor ops: :func:`bsi_separable`, cropped;
    for a bf16 or fp16 ``phi`` the float32 form on the widened grid and
    LUTs, rounded once."""
    X, Y, Z = vol_shape
    return bsi_separable(phi, tile)[:X, :Y, :Z]
