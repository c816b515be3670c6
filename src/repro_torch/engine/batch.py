"""The objective of one pyramid level.

``ffd_level_loss`` is similarity + regularisation of the control grid, fused
(the fused level-step kernel scores the warp without a dense field) or
unfused (dense field -> warp -> similarity, scored in float32).
``ffd_level_objective`` wraps it as an ``Objective`` for the level loop,
with the residual form Gauss-Newton linearises for unfused SSD, and
``linearize_warp_residual`` linearises a warp's residual once a step.
Batched, sharded and served registration are not in the package yet
(ROADMAP.md queue 1 items 10 and 14).
"""

from __future__ import annotations

import torch

from repro_torch.core import ffd
from repro_torch.core.regularizer import regularizer_term
from repro_torch.core.similarity import resolve_similarity
from repro_torch.core.transform import (VelocityTransform, dense_displacement,
                                        resolve_transform, scaling_and_squaring)
from repro_torch.engine.optimizer import make_objective

__all__ = ["ffd_level_loss", "ffd_level_objective", "linearize_warp_residual"]


def ffd_level_loss(f, mov, *, tile, bending_weight, mode, impl, grad_impl="autograd",
                   similarity="ssd", transform="displacement", regularizer="none",
                   fused="off"):
    """Similarity + regularisation objective ``phi -> scalar`` for one level.

    ``fused="on"`` (or True) swaps the similarity term for
    ``ffd.fused_warp_loss``: the fused kernel forward, the unfused gradient.
    It has no scaling-and-squaring composition, so it refuses the velocity
    transform.
    """
    vol_shape = tuple(f.shape)
    _, sim = resolve_similarity(similarity)
    tspec = resolve_transform(transform)
    gshape = ffd.grid_shape_for_volume(vol_shape, tile)
    reg = regularizer_term(regularizer, grid_shape=gshape, tile=tile,
                           bending_weight=bending_weight)

    if fused in ("on", True):
        if isinstance(tspec, VelocityTransform):
            raise ValueError(
                "fused='on' cannot run the velocity transform: the fused level step "
                "has no scaling-and-squaring composition; use fused='off' (or "
                "'auto') with transform='velocity'")

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
    """:func:`ffd_level_loss` as an ``engine.optimizer.Objective``.

    For the unfused ``"ssd"`` level the objective also carries the residual
    ``(warped - fixed).ravel()``, the regularisation term and the residual's
    linearisation, what ``optimizer="gauss_newton"`` uses.  Both run the
    configured ``mode`` / ``impl`` / ``grad_impl``: the linearisation
    expands the grid once a step and keeps the warp's derivative
    (:func:`linearize_warp_residual`), so ``J v`` is the forward kernel on
    the tangent (then, for velocity, the tangent of scaling and squaring by
    forward mode, which re-runs its compositions) and ``J^T w`` the adjoint
    kernel.  The residual itself is differentiable in forward mode too: the
    analytic BSI's JVP is the forward kernel on the tangent
    (``core.interpolate``).  Any other similarity, or the fused step, gives
    a scalar objective only.
    """
    loss_fn = ffd_level_loss(f, mov, **kwargs)
    similarity = kwargs.get("similarity", "ssd")
    key, _ = resolve_similarity(similarity)
    if key != "ssd" or kwargs.get("fused", "off") in ("on", True):
        return make_objective(loss_fn)

    vol_shape = tuple(f.shape)
    tile = kwargs["tile"]
    tspec = resolve_transform(kwargs.get("transform", "displacement"))
    bsi = dict(mode=kwargs["mode"], impl=kwargs["impl"],
               grad_impl=kwargs.get("grad_impl", "autograd"))
    reg = regularizer_term(kwargs.get("regularizer", "none"),
                           grid_shape=ffd.grid_shape_for_volume(vol_shape, tile),
                           tile=tile, bending_weight=kwargs["bending_weight"])
    fixed32 = f.to(torch.float32)

    velocity = isinstance(tspec, VelocityTransform)

    def residual_fn(p):
        disp = dense_displacement(tspec, p, tile, vol_shape, **bsi)
        return (ffd.warp_volume(mov, disp).to(torch.float32) - fixed32).reshape(-1)

    def linearize_fn(p):
        with torch.enable_grad():
            pg = p.detach().requires_grad_(True)
            field = ffd.dense_field(pg, tile, vol_shape, **bsi)
            disp = scaling_and_squaring(field, tspec.squarings) if velocity else field
            coords = ffd.identity_grid(vol_shape, disp.dtype, disp.device) + disp

        def coords_jvp(v):
            with torch.no_grad():
                dv = ffd.dense_field(v, tile, vol_shape, **bsi)
            if velocity:
                _, dv = torch.func.jvp(
                    lambda x: scaling_and_squaring(x, tspec.squarings),
                    (field.detach(),), (dv,))
            return dv

        return linearize_warp_residual(mov, fixed32, pg, coords, coords_jvp)

    return make_objective(loss_fn, residual_fn=residual_fn, reg_fn=reg,
                          linearize_fn=linearize_fn)


def linearize_warp_residual(moving, fixed, p, coords, coords_jvp):
    """``(r, jvp, vjp)`` of ``p -> trilinear(moving, coords(p)) - fixed`` at
    ``p``, flat.

    ``coords`` is ``coords(p)`` with its autograd graph back to the leaf
    ``p``, and ``coords_jvp(v)`` its forward-mode derivative.  The warp's
    derivative in the coordinates is taken once
    (``ffd.sample_with_gradient``), so ``J v`` is ``coords_jvp(v)`` dotted
    with it voxel by voxel, and ``J^T w`` the backward of ``coords`` with
    the cotangent ``w`` times it: no product re-runs the primal.
    """
    values, grad = ffd.sample_with_gradient(moving, coords.detach())
    shape = values.shape

    def jvp(v):
        return (grad * coords_jvp(v)).sum(-1).reshape(-1)

    def vjp(w):
        ct = w.reshape(shape).unsqueeze(-1) * grad
        return torch.autograd.grad(coords, p, ct, retain_graph=True)[0]

    return (values.to(torch.float32) - fixed).reshape(-1), jvp, vjp
