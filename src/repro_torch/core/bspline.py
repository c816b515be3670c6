"""Cubic B-spline basis functions and the aligned-grid weight LUTs.

Conventions (shared by every BSI implementation of the package)
---------------------------------------------------------------
* A volume of ``T`` tiles per axis with tile size ``delta`` has ``T * delta``
  voxels per axis.
* The control grid is voxel aligned and uniformly spaced (the NiftyReg
  convention of the paper, §3.4): voxel ``x = t*delta + a`` has fractional
  coordinate ``u = a/delta`` and base index ``i = t - 1``.
* Control grids are stored with a +1 index offset so that tile ``t`` reads
  stored points ``[t, t+4)``; a grid of ``T`` tiles stores ``T + 3`` points
  per axis.
* Because the grid is aligned, ``u`` takes only ``delta`` distinct values per
  axis, so all weights live in a ``(delta, 4)`` look-up table.

The LUTs are built in float64 numpy and cast once, so they are bitwise equal
to the JAX package's, bfloat16 and float16 included: the JAX package's numpy
cast (``ml_dtypes``) takes a float64 to bfloat16 through float32, round to
nearest even at each step, and :func:`_cast` does the same in torch (the
card's machine has no ``ml_dtypes``); numpy casts a float64 to float16
itself, rounding once to nearest even, subnormals kept.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "REDUCED_DTYPES",
    "reduced_step",
    "bspline_basis",
    "weight_lut",
    "basis_matrix",
    "fused_basis",
    "lerp_luts",
    "grid_points_for_tiles",
]


def _cast(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A float64 LUT as a tensor of ``dtype`` (a torch dtype) on ``device``,
    rounded as the JAX package rounds it: numpy dtypes in one cast,
    bfloat16 through float32."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(a.astype(str(dtype).removeprefix("torch."))).to(device)


def bspline_basis(u, dtype=torch.float32):
    """The four cubic B-spline basis values ``B_0..B_3`` at parameter ``u``.

    Returns a tensor of shape ``u.shape + (4,)``; the basis is a partition of
    unity, ``sum_l B_l(u) == 1``, which the TTLI lerp form relies on.
    """
    u = torch.as_tensor(u, dtype=dtype)
    b0 = (1.0 - u) ** 3 / 6.0
    b1 = (3.0 * u**3 - 6.0 * u**2 + 4.0) / 6.0
    b2 = (-3.0 * u**3 + 3.0 * u**2 + 3.0 * u + 1.0) / 6.0
    b3 = u**3 / 6.0
    return torch.stack([b0, b1, b2, b3], dim=-1)


@functools.lru_cache(maxsize=None)
def _weight_lut_np(delta: int) -> np.ndarray:
    # float64 then one cast: LUT rounding stays out of the error budget
    u = np.arange(delta, dtype=np.float64) / float(delta)
    b0 = (1.0 - u) ** 3 / 6.0
    b1 = (3.0 * u**3 - 6.0 * u**2 + 4.0) / 6.0
    b2 = (-3.0 * u**3 + 3.0 * u**2 + 3.0 * u + 1.0) / 6.0
    b3 = u**3 / 6.0
    return np.stack([b0, b1, b2, b3], axis=-1)


def weight_lut(delta: int, dtype=torch.float32, device="cpu"):
    """``(delta, 4)`` aligned-grid weight LUT: ``W[a, l] = B_l(a / delta)``."""
    return _cast(_weight_lut_np(int(delta)), dtype, device)


@functools.lru_cache(maxsize=None)
def _basis_matrix_np(tile: tuple) -> np.ndarray:
    dx, dy, dz = tile
    wx, wy, wz = (_weight_lut_np(d) for d in (dx, dy, dz))
    b = np.einsum("al,bm,cn->abclmn", wx, wy, wz)
    return b.reshape(dx * dy * dz, 64)


def basis_matrix(tile, dtype=torch.float32, device="cpu"):
    """``(dx*dy*dz, 64)`` Kronecker product of the three per-axis LUTs.

    ``B[v, k] = Wx[a, l] * Wy[b, m] * Wz[c, n]`` with voxel offset
    ``v = (a*dy + b)*dz + c`` and control offset ``k = (l*4 + m)*4 + n``.
    """
    return _cast(_basis_matrix_np(tuple(int(d) for d in tile)), dtype, device)


# the reduced compute dtypes (core.interpolate: float32 arithmetic, each
# value rounded once to the dtype at its store; the fused basis rounds its
# products one at a time)
REDUCED_DTYPES = (torch.bfloat16, torch.float16)


def reduced_step(m: torch.Tensor, dtype) -> torch.Tensor:
    """One step of ``dtype`` (bf16 or fp16) at the magnitudes ``m``, float32:
    ``2^floor(log2 m)`` times the dtype's epsilon (``2^-7``, ``2^-10``), at
    least its least subnormal (``2^-133``, ``2^-24``): twice the most that
    one rounding to the dtype moves a value of magnitude ``m``."""
    fi = torch.finfo(dtype)
    bits = 1 - int(np.log2(fi.eps))  # significant bits: 8, 11
    least = int(np.log2(fi.smallest_normal * fi.eps))
    exponent = torch.clamp_min(torch.frexp(m).exponent - bits, least)
    return torch.ldexp(torch.ones_like(m), exponent)


def fused_basis(tile, dtype=torch.float32, device="cpu"):
    """The ``(dx*dy*dz, 64)`` basis of the fused kernels' matrix form.

    float32: :func:`basis_matrix`, the float64 product cast once.  bfloat16
    and float16: the product of the per-axis LUTs of the dtype, each product
    rounded to it, ``r(r(wx * wy) * wz)``, as the JAX package's fused kernel
    forms it from its reduced LUTs (``repro/kernels/bsi_matmul.py:kron_basis``:
    each product of two bf16 or fp16 values is exact in float32, then rounded
    once, an fp16 product to a subnormal where it falls below fp16's normal
    range); some entries lie a step from :func:`basis_matrix`'s one
    rounding.  Returns ``dtype``.
    """
    tile = tuple(int(d) for d in tile)
    if dtype not in REDUCED_DTYPES:
        return basis_matrix(tile, dtype, device)
    dx, dy, dz = tile
    wx, wy, wz = (weight_lut(d, dtype, "cpu").float() for d in tile)
    b = (wx.reshape(dx, 1, 1, 4, 1, 1) * wy.reshape(1, dy, 1, 1, 4, 1)).to(dtype).float()
    b = (b * wz.reshape(1, 1, dz, 1, 1, 4)).to(dtype)
    return b.reshape(dx * dy * dz, 64).to(device)


@functools.lru_cache(maxsize=None)
def _lerp_luts_np(delta: int):
    w = _weight_lut_np(delta)
    b0, b1, b2, b3 = w[:, 0], w[:, 1], w[:, 2], w[:, 3]
    # pairwise renormalisation (paper §3.3): B0*p0 + B1*p1 ==
    # (B0+B1) * lerp(p0, p1, B1/(B0+B1)); partition of unity makes the
    # final combine a lerp too
    t0 = b1 / (b0 + b1)
    t1 = b3 / (b2 + b3)
    s = b2 + b3
    return t0, t1, s


def lerp_luts(delta: int, dtype=torch.float32, device="cpu"):
    """LUTs ``(t0, t1, s)`` of the TTLI lerp form, each of shape ``(delta,)``.

    ``sum_l B_l(u_a) * p_l == lerp(lerp(p0, p1, t0), lerp(p2, p3, t1), s)``:
    3 lerps per axis level, 63 per voxel in 3-D (paper App. B).
    """
    return tuple(_cast(a, dtype, device) for a in _lerp_luts_np(int(delta)))


def grid_points_for_tiles(num_tiles) -> tuple:
    """Stored control-grid points per axis for ``num_tiles`` tiles (+3 halo)."""
    return tuple(int(t) + 3 for t in num_tiles)
