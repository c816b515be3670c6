"""Synthetic pre-clinical volumes (a stand-in for the paper's dataset).

The same numpy formulas and seeds as the JAX package: a smooth parenchyma
blob with tumour spheres and vessel tubes, and a pair made by warping it
with a random smooth control grid through this package's own FFD.
``PAPER_VOLUMES`` holds the paper's Table 2 shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ffd
from repro_torch.device import resolve_device

__all__ = ["PAPER_VOLUMES", "make_phantom", "make_pair"]

# Paper Table 2: registration pair -> resolution (voxels).
PAPER_VOLUMES = {
    "phantom1": (512, 228, 385),
    "phantom2": (294, 130, 208),
    "phantom3": (294, 130, 208),
    "porcine1": (303, 167, 212),
    "porcine2": (267, 169, 237),
}


def _phantom_np(shape, n_tumors, n_vessels, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    X, Y, Z = shape
    xs, ys, zs = np.meshgrid(
        np.linspace(-1, 1, X), np.linspace(-1, 1, Y), np.linspace(-1, 1, Z),
        indexing="ij",
    )
    # parenchyma: soft ellipsoid with a lobed boundary
    r2 = (xs / 0.8) ** 2 + (ys / 0.7) ** 2 + (zs / 0.75) ** 2
    lobes = 0.12 * np.sin(3 * xs + 1.0) * np.cos(2 * ys)
    vol = 0.55 * (1.0 / (1.0 + np.exp(40 * (r2 - 0.8 + lobes))))
    # tumours: bright spheres inside the parenchyma
    for _ in range(n_tumors):
        c = rng.uniform(-0.45, 0.45, 3)
        rad = rng.uniform(0.06, 0.14)
        d2 = (xs - c[0]) ** 2 + (ys - c[1]) ** 2 + (zs - c[2]) ** 2
        vol += 0.35 * np.exp(-d2 / (2 * rad**2))
    # vessels: bright tubes along random directions
    for _ in range(n_vessels):
        p = rng.uniform(-0.35, 0.35, 3)
        d = rng.standard_normal(3)
        d /= np.linalg.norm(d)
        rel = np.stack([xs - p[0], ys - p[1], zs - p[2]], -1)
        t = rel @ d
        closest = rel - t[..., None] * d
        dist2 = (closest**2).sum(-1)
        vol += 0.25 * np.exp(-dist2 / (2 * 0.03**2)) * (np.abs(t) < 0.6)
    vol += rng.normal(0.0, 0.01, vol.shape)  # acquisition noise
    return np.clip(vol, 0.0, 1.0).astype(np.float32)


def make_phantom(shape=(72, 64, 56), *, n_tumors=5, n_vessels=3, seed=0,
                 device="cuda"):
    """Liver-phantom-like float32 volume on ``device``."""
    device = resolve_device(device)
    vol = _phantom_np(tuple(int(s) for s in shape), n_tumors, n_vessels, seed)
    return torch.from_numpy(vol).to(device)


def make_pair(shape=(72, 64, 56), *, tile=(6, 6, 6), magnitude=2.5, seed=0,
              device="cuda"):
    """A ``(fixed, moving, phi_true)`` pair with a known FFD deformation.

    ``fixed`` is the phantom; ``moving`` is the phantom warped by a random
    smooth control grid (plain separable BSI, then the trilinear warp).
    """
    device = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    fixed = make_phantom(shape, seed=seed, device=device)
    rng = np.random.default_rng(seed + 1)
    gshape = ffd.grid_shape_for_volume(shape, tile)
    phi_true = torch.from_numpy(
        rng.normal(0.0, magnitude, gshape + (3,)).astype(np.float32)).to(device)
    with torch.no_grad():
        disp = ffd.dense_field(phi_true, tile, shape)
        moving = ffd.warp_volume(fixed, disp)
    return fixed, moving, phi_true
