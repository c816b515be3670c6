"""The objective of one pyramid level.

``ffd_level_loss`` is similarity + regularisation of the control grid, fused
(the fused level-step kernel scores the warp without a dense field) or
unfused (dense field -> warp -> similarity, scored in float32).
``ffd_level_objective`` wraps it as an ``Objective`` for the level loop.
Batched, sharded and served registration are not in the package yet
(ROADMAP.md queue 1 items 10 and 14).
"""

from __future__ import annotations

import torch

from repro_torch.core import ffd
from repro_torch.core.regularizer import regularizer_term
from repro_torch.core.similarity import resolve_similarity
from repro_torch.core.transform import dense_displacement, resolve_transform
from repro_torch.engine.optimizer import make_objective

__all__ = ["ffd_level_loss", "ffd_level_objective"]


def ffd_level_loss(f, mov, *, tile, bending_weight, mode, impl, grad_impl="autograd",
                   similarity="ssd", transform="displacement", regularizer="none",
                   fused="off"):
    """Similarity + regularisation objective ``phi -> scalar`` for one level.

    ``fused="on"`` (or True) swaps the similarity term for
    ``ffd.fused_warp_loss``: the fused kernel forward, the unfused gradient.
    """
    vol_shape = tuple(f.shape)
    _, sim = resolve_similarity(similarity)
    tspec = resolve_transform(transform)
    gshape = ffd.grid_shape_for_volume(vol_shape, tile)
    reg = regularizer_term(regularizer, grid_shape=gshape, tile=tile,
                           bending_weight=bending_weight)

    if fused in ("on", True):

        def loss_fn(p):
            simloss = ffd.fused_warp_loss(
                p, mov, f, tile, similarity=similarity, mode=mode, impl=impl,
                grad_impl=grad_impl)
            return simloss + reg(p)

        return loss_fn

    def loss_fn(p):
        disp = dense_displacement(tspec, p, tile, vol_shape, mode=mode, impl=impl,
                                  grad_impl=grad_impl)
        warped = ffd.warp_volume(mov, disp)
        # score in fp32 whatever the input dtype
        return sim(warped.to(torch.float32), f.to(torch.float32)) + reg(p)

    return loss_fn


def ffd_level_objective(f, mov, **kwargs):
    """:func:`ffd_level_loss` as an ``engine.optimizer.Objective``."""
    return make_objective(ffd_level_loss(f, mov, **kwargs))
