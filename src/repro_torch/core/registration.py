"""Non-rigid (FFD) registration, the paper's application layer (§6).

``ffd_register`` runs the NiftyReg workflow: a ``downsample2`` pyramid,
``iters`` optimiser steps per level on similarity + regularisation of the
control grid (the gradient through the analytic BSI adjoint), the grid
upsampled between levels, and a final warp.  It runs on the card unless the
caller passes ``device="cpu"``, where every kernel's plain version runs.
``affine_register`` is not in the package yet (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import ffd
from repro_torch.core.ffd import downsample2
from repro_torch.core.options import RegistrationOptions
from repro_torch.core.transform import dense_displacement
from repro_torch.device import resolve_device
from repro_torch.engine.autotune import resolve_options
from repro_torch.engine.batch import ffd_level_objective
from repro_torch.engine.loop import make_adam_runner

__all__ = ["RegistrationResult", "ffd_register", "resolve_device"]


@dataclasses.dataclass
class RegistrationResult:
    warped: Any  # registered moving volume, (X, Y, Z) on the device
    params: Any  # finest-level control grid, (Nx, Ny, Nz, 3) on the device
    losses: list  # final loss of each pyramid level, coarse to fine
    seconds: float  # wall time, ending in a device synchronisation
    bsi_seconds: float = 0.0  # time inside BSI (paper Figs. 8-9 breakdown)
    traces: list = dataclasses.field(default_factory=list)  # per level: (iters,) losses


def _volume(x, device):
    if not isinstance(x, torch.Tensor):  # copy: numpy views of JAX arrays are read-only
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32).contiguous()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ffd_level_runner(options):
    """The level loop for ``options``: ``(phi, fixed, moving) -> (phi, trace)``."""

    def loss_builder(f, mov):
        return ffd_level_objective(
            f, mov, tile=options.tile, bending_weight=options.bending_weight,
            mode=options.mode, impl=options.impl, grad_impl=options.grad_impl,
            similarity=options.similarity,
            transform=options.transform, regularizer=options.regularizer,
            fused=options.fused)

    return make_adam_runner(loss_builder, options=options)


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


def ffd_register(fixed, moving, *, options=None, device="cuda",
                 measure_bsi_time=False):
    """Multi-resolution FFD registration (NiftyReg workflow, paper §6).

    ``fixed`` and ``moving`` are ``(X, Y, Z)`` numpy arrays or tensors;
    ``options`` a ``RegistrationOptions`` (its defaults run the kernels).
    Its ``"auto"`` axes are resolved once, for the finest volume on
    ``device``, before the pyramid (``engine.autotune.resolve_options``).
    ``measure_bsi_time`` times the finest level's BSI expansion and reports
    two expansions per step (forward and adjoint) as ``bsi_seconds``.
    """
    device = resolve_device(device)
    opts = RegistrationOptions() if options is None else options
    if not isinstance(opts, RegistrationOptions):
        raise TypeError(f"options must be a RegistrationOptions, got {opts!r}")
    fixed, moving = _volume(fixed, device), _volume(moving, device)
    if fixed.dim() != 3 or fixed.shape != moving.shape:
        raise ValueError(
            f"fixed and moving must be (X, Y, Z) volumes of one shape, got "
            f"{tuple(fixed.shape)} and {tuple(moving.shape)}")
    opts = resolve_options(opts, tuple(fixed.shape), device)  # autotune the "auto"s
    tile = opts.tile

    pyramid = [(fixed, moving)]
    for _ in range(opts.levels - 1):
        f, m = pyramid[-1]
        pyramid.append((downsample2(f).contiguous(), downsample2(m).contiguous()))
    pyramid = pyramid[::-1]  # coarse -> fine

    runner = _ffd_level_runner(opts)
    phi = None
    losses, traces = [], []
    bsi_seconds = 0.0
    t0 = time.perf_counter()
    for level, (f, m) in enumerate(pyramid):
        gshape = ffd.grid_shape_for_volume(f.shape, tile)
        if phi is None:
            phi = torch.zeros(gshape + (3,), dtype=torch.float32, device=device)
        else:
            phi = ffd.upsample_grid(phi, gshape).contiguous()
        phi, trace = runner(phi, f, m)
        losses.append(float(trace[-1]))
        traces.append(trace)

        if measure_bsi_time and level == len(pyramid) - 1:
            # the BSI share the paper optimises (Figs. 8-9): two expansions
            # per step, forward and adjoint
            def expand(p=phi, shape=tuple(f.shape)):
                return ffd.dense_field(p, tile, shape, mode=opts.mode, impl=opts.impl,
                                       grad_impl=opts.grad_impl)

            with torch.no_grad():
                bsi_seconds = _time_bsi(expand, device) * opts.iters * 2

    with torch.no_grad():
        disp = dense_displacement(opts.transform, phi, tile, tuple(fixed.shape),
                                  mode=opts.mode, impl=opts.impl,
                                  grad_impl=opts.grad_impl)
        warped = ffd.warp_volume(moving, disp)
    _sync(device)
    return RegistrationResult(warped, phi, losses, time.perf_counter() - t0,
                              bsi_seconds, traces)
