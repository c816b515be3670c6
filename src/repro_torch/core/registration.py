"""Non-rigid (FFD) and affine registration, the paper's application layer (§6).

``ffd_register`` runs the NiftyReg workflow: a ``downsample2`` pyramid,
``iters`` optimiser steps per level (or fewer under ``stop=``) on
similarity + regularisation of the control grid (the gradient through the
analytic BSI adjoint), the grid upsampled between levels, and a final warp.
``affine_register`` optimises a 3x4 affine about the volume centre on the
similarity.  Both run on the card unless the caller passes
``device="cpu"``, where every kernel's plain version runs.  Both take
``options=``, or the JAX package's legacy keywords (``tile=``, ``iters=``,
...) through the deprecation shim (``core.options.merge_legacy_options``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.core import ffd
from repro_torch.core.options import UNSET, RegistrationOptions, merge_legacy_options
from repro_torch.device import as_volume, resolve_device, synchronize
from repro_torch.engine.autotune import resolve_options
from repro_torch.engine.batch import (compile_finish, level_runner,
                                      linearize_warp_residual, pyramid)
from repro_torch.engine.convergence import check_stop
from repro_torch.engine.loop import make_adam_runner
from repro_torch.engine.optimizer import make_objective

__all__ = ["AFFINE_DEFAULTS", "RegistrationResult", "affine_register", "ffd_register",
           "resolve_device"]

# affine_register's defaults (the FFD defaults are RegistrationOptions' own)
AFFINE_DEFAULTS = RegistrationOptions(iters=60, lr=0.02)


@dataclasses.dataclass
class RegistrationResult:
    warped: Any  # registered moving volume, (X, Y, Z) on the device
    params: Any  # finest-level control grid (Nx, Ny, Nz, 3), or the (3, 4) affine
    losses: list  # FFD: final loss of each level; affine: every 10th step + last
    seconds: float  # wall time, ending in a device synchronisation
    bsi_seconds: float = 0.0  # time inside BSI (paper Figs. 8-9 breakdown)
    traces: list = dataclasses.field(default_factory=list)  # per level: losses
    steps: Any = None  # optimiser steps per level when stop= was set


def _affine_coords(theta, vol_shape):
    """The voxel coordinates ``(x - c) A^T + c + t``, ``A = theta[:, :3] + I``,
    ``t = theta[:, 3]``, ``c`` the volume centre.  The 3x3 product is three
    broadcast multiply-adds, float32 whatever ``allow_tf32`` says."""
    centre = torch.tensor([(s - 1.0) / 2.0 for s in vol_shape], dtype=torch.float32,
                          device=theta.device)
    a = theta[:, :3] + torch.eye(3, dtype=theta.dtype, device=theta.device)
    q = ffd.identity_grid(vol_shape, torch.float32, theta.device) - centre
    coords = q[..., 0:1] * a[:, 0] + q[..., 1:2] * a[:, 1] + q[..., 2:3] * a[:, 2]
    return coords + centre + theta[:, 3]


def _affine_warp(theta, moving, vol_shape):
    """``moving`` sampled at :func:`_affine_coords`."""
    return ffd.trilinear_sample(moving, _affine_coords(theta, vol_shape))


def _affine_objective(fixed, moving, similarity="ssd"):
    """The affine model's objective: ``similarity`` of the warp; SSD also
    carries its residual and linearisation for ``optimizer="gauss_newton"``
    (no regulariser on the affine model)."""
    from repro_torch.core.similarity import resolve_similarity

    sim_key, sim = resolve_similarity(similarity)
    vol_shape = tuple(fixed.shape)

    def loss_fn(theta):
        return sim(_affine_warp(theta, moving, vol_shape), fixed)

    if sim_key != "ssd":
        return make_objective(loss_fn)

    def residual_fn(theta):
        return (_affine_warp(theta, moving, vol_shape) - fixed).reshape(-1)

    def linearize_fn(theta):
        theta = theta.detach()
        with torch.enable_grad():
            tg = theta.clone().requires_grad_(True)
            coords = _affine_coords(tg, vol_shape)

        def coords_jvp(v):
            return torch.func.jvp(lambda t: _affine_coords(t, vol_shape), (theta,),
                                  (v,))[1]

        return linearize_warp_residual(moving, fixed, tg, coords, coords_jvp)

    return make_objective(loss_fn, residual_fn=residual_fn, linearize_fn=linearize_fn)


def _affine_runner(options):
    """The affine loop for ``options`` (``for_affine()``'s)."""
    return make_adam_runner(
        lambda f, mov: _affine_objective(f, mov, options.similarity), options=options)


def affine_register(fixed, moving, *, options=None, iters=UNSET, lr=UNSET,
                    similarity=UNSET, stop=UNSET, optimizer=UNSET, device="cuda"):
    """Optimise a 3x4 affine about the volume centre on ``options.similarity``.

    Of ``options`` (default :data:`AFFINE_DEFAULTS`: ``iters=60, lr=0.02``)
    only ``iters``, ``lr``, ``similarity``, ``stop`` and ``optimizer``
    apply; ``"gauss_newton"`` needs ``similarity="ssd"`` and linearises the
    affine warp.  The legacy keywords overlay :data:`AFFINE_DEFAULTS`.
    ``losses`` are the trace at every 10th step and the last; under
    ``stop`` the result's ``steps`` is ``[steps taken]``.
    """
    device = resolve_device(device)
    opts = merge_legacy_options(
        "affine_register", options,
        dict(iters=iters, lr=lr, similarity=similarity, stop=stop, optimizer=optimizer),
        defaults=AFFINE_DEFAULTS).for_affine()
    fixed, moving = as_volume(fixed, device), as_volume(moving, device)
    if fixed.dim() != 3 or fixed.shape != moving.shape:
        raise ValueError(
            f"fixed and moving must be (X, Y, Z) volumes of one shape, got "
            f"{tuple(fixed.shape)} and {tuple(moving.shape)}")
    stop = opts.stop  # resolved by for_affine()
    t0 = time.perf_counter()
    vol_shape = tuple(fixed.shape)
    out = _affine_runner(opts)(
        torch.zeros((3, 4), dtype=torch.float32, device=device), fixed, moving)
    theta, trace = out[:2]
    steps = [int(out[2])] if stop is not None else None
    span = opts.iters if stop is None else stop.max_iters
    marks = sorted(set(range(10, span + 1, 10)) | {span})
    trace_host = trace.cpu()
    losses = [float(trace_host[i - 1]) for i in marks]
    with torch.no_grad():
        warped = _affine_warp(theta, moving, vol_shape)
    synchronize(device)
    return RegistrationResult(warped, theta, losses, time.perf_counter() - t0,
                              traces=[trace], steps=steps)


def _time_bsi(fn, device, reps=3):
    """Seconds per call of ``fn`` after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def ffd_register(fixed, moving, *, options=None, tile=UNSET, levels=UNSET, iters=UNSET,
                 lr=UNSET, bending_weight=UNSET, mode=UNSET, impl=UNSET, grad_impl=UNSET,
                 compute_dtype=UNSET, similarity=UNSET, transform=UNSET,
                 regularizer=UNSET, stop=UNSET, optimizer=UNSET, device="cuda",
                 measure_bsi_time=False):
    """Multi-resolution FFD registration (NiftyReg workflow, paper §6).

    ``fixed`` and ``moving`` are ``(X, Y, Z)`` numpy arrays or tensors;
    ``options`` a ``RegistrationOptions`` (its defaults run the kernels), or
    the legacy keywords, its fields one by one (deprecated, bit-identical).
    Its ``"auto"`` axes are resolved once, for the finest volume on
    ``device``, before the pyramid (``engine.autotune.resolve_options``).
    ``measure_bsi_time`` times the finest level's BSI expansion and reports
    two expansions per step (forward and adjoint) of the steps that level
    ran as ``bsi_seconds``.  Under ``options.stop`` (a
    ``ConvergenceConfig``) each level ends on a plateau and the result's
    ``steps`` lists the steps each level took.  ``options.compute_dtype``
    (``"bfloat16"``, ``"float16"``) runs each level's BSI and warp in
    reduced precision with float32 parameters, optimiser state, adjoint
    accumulation and objective; the final warp is float32, as in the JAX
    package, and so is ``warped``.
    """
    device = resolve_device(device)
    opts = merge_legacy_options(
        "ffd_register", options,
        dict(tile=tile, levels=levels, iters=iters, lr=lr, bending_weight=bending_weight,
             mode=mode, impl=impl, grad_impl=grad_impl, compute_dtype=compute_dtype,
             similarity=similarity, transform=transform, regularizer=regularizer,
             stop=stop, optimizer=optimizer))
    fixed, moving = as_volume(fixed, device), as_volume(moving, device)
    if fixed.dim() != 3 or fixed.shape != moving.shape:
        raise ValueError(
            f"fixed and moving must be (X, Y, Z) volumes of one shape, got "
            f"{tuple(fixed.shape)} and {tuple(moving.shape)}")
    opts = resolve_options(opts, tuple(fixed.shape), device)  # autotune the "auto"s
    tile, stop = opts.tile, check_stop(opts.stop, opts.iters)

    levels = pyramid(fixed, moving, opts.levels)  # coarse -> fine
    runner = level_runner(opts)
    phi = None
    losses, traces = [], []
    steps = [] if stop is not None else None
    bsi_seconds = 0.0
    t0 = time.perf_counter()
    for level, (f, m) in enumerate(levels):
        gshape = ffd.grid_shape_for_volume(f.shape, tile)
        if phi is None:
            phi = torch.zeros(gshape + (3,), dtype=torch.float32, device=device)
        else:
            phi = ffd.upsample_grid(phi, gshape).contiguous()
        out = runner(phi, f, m)
        phi, trace = out[:2]
        if stop is not None:
            steps.append(int(out[2]))
        losses.append(float(trace[-1]))
        traces.append(trace)

        if measure_bsi_time and level == len(levels) - 1:
            # the BSI share the paper optimises (Figs. 8-9): two expansions
            # per step run, forward and adjoint
            def expand(p=phi, shape=tuple(f.shape)):
                return ffd.dense_field(p, tile, shape, mode=opts.mode, impl=opts.impl,
                                       grad_impl=opts.grad_impl,
                                       compute_dtype=opts.compute_dtype)

            with torch.no_grad():
                ran = steps[-1] if stop is not None else opts.iters
                bsi_seconds = _time_bsi(expand, device) * ran * 2

    warped = compile_finish(tuple(fixed.shape), opts)(phi, moving)
    synchronize(device)
    return RegistrationResult(warped, phi, losses, time.perf_counter() - t0,
                              bsi_seconds, traces, steps)
