"""Evaluation metrics of registration quality (paper §6-7, Table 5).

The loss-form terms the optimiser minimises are in ``core.similarity``; these
two only score a result: ``mae`` (Table 5) and ``ssim``, both on min-max
normalised intensities.
"""

from __future__ import annotations

import torch

from repro_torch.core.similarity import _norm01, uniform_filter

__all__ = ["mae", "ssim"]


def mae(a, b):
    """Mean absolute error on normalised intensities (paper Table 5)."""
    return torch.mean(torch.abs(_norm01(a) - _norm01(b)))


def ssim(a, b, *, window=7, k1=0.01, k2=0.03):
    """Structural similarity index (3-D, uniform window; paper Table 5).

    The window clamps to the volume's smallest extent, so sub-window volumes
    stay valid.
    """
    a, b = _norm01(a), _norm01(b)
    c1, c2 = k1**2, k2**2
    mu_a = uniform_filter(a, window)
    mu_b = uniform_filter(b, window)
    aa = uniform_filter(a * a, window) - mu_a**2
    bb = uniform_filter(b * b, window) - mu_b**2
    ab = uniform_filter(a * b, window) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * ab + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (aa + bb + c2)
    )
    return torch.mean(s)
