"""The objective of one pyramid level, batched registration, and the lanes
of the serving scheduler.

``ffd_level_loss`` is similarity + regularisation of the control grid, fused
(the fused level-step kernel scores the warp without a dense field) or
unfused (dense field -> warp -> similarity, scored in float32).
``ffd_level_objective`` wraps it as an ``Objective`` for the level loop,
with the residual form Gauss-Newton linearises for unfused SSD, and
``linearize_warp_residual`` linearises a warp's residual once a step.

``ffd_pipeline`` is the whole multi-level registration of one pair on
resolved options, and ``register_batch`` registers a ``(B, X, Y, Z)`` stack
pair by pair through it.  The JAX package ``vmap``s the pipeline into one
program; this package's kernels have no batch axis, so the batch is a loop
and each pair launches what a solo ``ffd_register`` launches.

The lane pieces (``compile_level_init``, ``compile_level_splice``,
``compile_level_chunk``, ``compile_finish``) are the continuous-batching
scheduler's substrate (``engine.serve``): a stage keeps ``W`` lanes of one
pyramid level as stacked ``(W, ...)`` tensors, runs them ``chunk`` steps at
a time, and between chunks the host retires converged lanes and splices
queued pairs into the freed rows.  A lane's step is
``engine.convergence.optimize_plateau_step``, the body of the solo level
loop, on fresh copies of its rows, so its trajectory is the solo one bit
for bit however chunks and recycling slice it.  The factories keep the JAX
package's names; nothing is compiled, each returns a plain function, and
their caches keep one closure per configuration.
With ``mesh=`` the batch is split over the ranks of a ``torch.distributed``
mesh (``engine.shard``), each rank running ``ffd_pipeline`` on its block.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import torch

from repro_torch.core import ffd
from repro_torch.core.interpolate import as_compute_dtype
from repro_torch.core.options import UNSET, merge_legacy_options
from repro_torch.core.regularizer import regularizer_term
from repro_torch.core.similarity import resolve_similarity
from repro_torch.core.transform import (VelocityTransform, dense_displacement,
                                        resolve_transform, scaling_and_squaring)
from repro_torch.device import as_volume, resolve_device, synchronize
from repro_torch.engine.autotune import resolve_options
from repro_torch.engine.convergence import check_stop, level_live, optimize_plateau_step
from repro_torch.engine.loop import make_adam_runner
from repro_torch.engine.optimizer import init_state, make_objective

__all__ = ["BatchRegistrationResult", "alloc_lanes", "compile_finish",
           "compile_level_chunk", "compile_level_init", "compile_level_splice",
           "ffd_level_loss", "ffd_level_objective", "ffd_pipeline", "level_runner",
           "level_vol_shapes", "linearize_warp_residual", "pyramid", "register_batch"]


@dataclasses.dataclass
class BatchRegistrationResult:
    warped: Any  # (B, X, Y, Z) registered moving volumes
    params: Any  # (B, *grid_shape, 3) finest-level control grids
    losses: Any  # (B, levels) float32, final loss per pyramid level
    seconds: float  # wall time of the batch, ending in a device synchronisation
    # True on the first call of a (volume shape, options) configuration: its
    # seconds then include the first launches' one-time costs (the kernel
    # library's build or load, the allocator's first blocks), so time a
    # second call before comparing.
    compiled: bool = False
    # (B, levels) int32 optimiser steps per pair and level under stop=; None
    # with a fixed number of steps
    steps: Any = None


def ffd_level_loss(f, mov, **kwargs):
    """Similarity + regularisation objective ``phi -> scalar`` for one level
    (:func:`_level_loss`)."""
    return _level_loss(f, mov, **kwargs)[0]


def _level_loss(f, mov, *, tile, bending_weight, mode, impl, grad_impl="autograd",
                compute_dtype=None, similarity="ssd", transform="displacement",
                regularizer="none", fused="off"):
    """``(loss_fn, mov)``: the level's objective ``phi -> scalar`` and the
    moving volume in the compute dtype, which it samples.

    ``fused="on"`` (or True) swaps the similarity term for
    ``ffd.fused_warp_loss``: the fused kernel forward, the unfused gradient.
    It has no scaling-and-squaring composition, so it refuses the velocity
    transform.  ``compute_dtype`` (``"bfloat16"``, ``"float16"``) runs the
    expansion and the warp's sampled intensities in reduced precision;
    ``mov`` is cast once here, not once a step, and the similarity is
    scored in float32.
    """
    vol_shape = tuple(f.shape)
    cd = as_compute_dtype(compute_dtype)
    mov = mov if cd is None else mov.to(cd)
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
                grad_impl=grad_impl, compute_dtype=cd)
            return simloss + reg(p)

        return loss_fn, mov

    def loss_fn(p):
        disp = dense_displacement(tspec, p, tile, vol_shape, mode=mode, impl=impl,
                                  grad_impl=grad_impl, compute_dtype=cd)
        warped = ffd.warp_volume(mov, disp, compute_dtype=cd)
        # score in fp32 whatever the input dtype
        return sim(warped.to(torch.float32), f.to(torch.float32)) + reg(p)

    return loss_fn, mov


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
    loss_fn, mov = _level_loss(f, mov, **kwargs)  # mov cast once, shared
    similarity = kwargs.get("similarity", "ssd")
    key, _ = resolve_similarity(similarity)
    if key != "ssd" or kwargs.get("fused", "off") in ("on", True):
        return make_objective(loss_fn)

    vol_shape = tuple(f.shape)
    tile = kwargs["tile"]
    tspec = resolve_transform(kwargs.get("transform", "displacement"))
    bsi = dict(mode=kwargs["mode"], impl=kwargs["impl"],
               grad_impl=kwargs.get("grad_impl", "autograd"),
               compute_dtype=kwargs.get("compute_dtype"))
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
            # float32 coordinates from a reduced field, as the warp takes them
            disp = disp.to(torch.promote_types(disp.dtype, torch.float32))
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


def pyramid(fixed, moving, levels):
    """``[(fixed_l, moving_l), ...]``, coarse -> fine, each level the last
    one's ``downsample2``."""
    out = [(fixed, moving)]
    for _ in range(levels - 1):
        f, m = out[-1]
        out.append((ffd.downsample2(f).contiguous(), ffd.downsample2(m).contiguous()))
    return out[::-1]


def _lane_obj(f, m, options):
    """The level objective of ``options`` on one level's pair."""
    o = options
    return ffd_level_objective(
        f, m, tile=o.tile, bending_weight=o.bending_weight, mode=o.mode, impl=o.impl,
        grad_impl=o.grad_impl, compute_dtype=o.compute_dtype, similarity=o.similarity,
        transform=o.transform, regularizer=o.regularizer, fused=o.fused)


def level_runner(options):
    """The level loop of resolved ``options``: ``(phi, fixed, moving) ->
    (phi, trace)``, and ``steps`` under ``stop`` (``engine.loop``)."""
    return make_adam_runner(lambda f, m: _lane_obj(f, m, options), options=options)


def ffd_pipeline(fixed, moving, *, options):
    """Multi-level FFD registration of one ``(X, Y, Z)`` pair on resolved
    ``options`` (no ``"auto"`` left), as ``ffd_register`` runs it.

    Returns ``(warped, phi, level_losses)``, ``level_losses`` a
    ``(levels,)`` float32 tensor; under ``options.stop`` also
    ``level_steps``, the steps each level took (a list of ints).
    """
    stop = check_stop(options.stop, options.iters)
    runner = level_runner(options)
    phi, finals, steps = None, [], []
    for f, m in pyramid(fixed, moving, options.levels):
        gshape = ffd.grid_shape_for_volume(f.shape, options.tile)
        if phi is None:
            phi = torch.zeros(gshape + (3,), dtype=torch.float32, device=f.device)
        else:
            phi = ffd.upsample_grid(phi, gshape).contiguous()
        out = runner(phi, f, m)
        phi, trace = out[:2]
        if stop is not None:
            steps.append(int(out[2]))
        finals.append(trace[-1])
    warped = compile_finish(tuple(fixed.shape), options)(phi, moving)
    if stop is None:
        return warped, phi, torch.stack(finals)
    return warped, phi, torch.stack(finals), steps


@functools.lru_cache(maxsize=32)
def _compiled_batch(vol_shape, options, shards=None):
    """The pipeline of one ``(vol_shape, options, shards)`` configuration:
    the per-pair ``ffd_pipeline``, or for a mesh of ``shards`` batch shards
    ``engine.shard.sharded_pipeline``, which takes the caller's ``mesh=`` at
    each call.  No mesh is cached: a ``DeviceMesh`` hashes without its
    process group, so a cached one could outlive its group.

    Nothing is compiled: the kernels are built once per process, at their
    first launch.  The cache's misses mark a configuration's first call,
    which ``register_batch`` reports as ``compiled``.
    """
    del vol_shape  # cache key only
    if shards is None:
        return functools.partial(ffd_pipeline, options=options)
    from repro_torch.engine.shard import sharded_pipeline

    return functools.partial(sharded_pipeline, options=options)


def register_batch(fixed, moving, *, options=None, tile=UNSET, levels=UNSET, iters=UNSET,
                   lr=UNSET, bending_weight=UNSET, mode=UNSET, impl=UNSET,
                   grad_impl=UNSET, compute_dtype=UNSET, similarity=UNSET,
                   transform=UNSET, regularizer=UNSET, mesh=None, stop=UNSET,
                   optimizer=UNSET, device="cuda"):
    """Register a ``(B, X, Y, Z)`` stack of pairs, one ``ffd_pipeline`` per pair.

    ``options`` (default ``RegistrationOptions()``; or the legacy keywords,
    its fields one by one, deprecated and bit-identical) is resolved once
    for the volume shape on ``device`` (``engine.autotune.resolve_options``).
    Each pair runs on fresh copies of its volumes, so ``warped[b]``,
    ``params[b]`` and ``losses[b]`` equal a solo ``ffd_register`` of pair
    ``b`` under the same options bit for bit, and the batch launches what
    the solo calls launch together.  Under ``options.stop`` the result's
    ``steps`` is a ``(B, levels)`` int32 tensor on the host.  Runs on the
    card unless ``device="cpu"``.

    ``mesh`` (``engine.shard.make_registration_mesh``) splits the batch over
    the mesh's ranks.  Every rank calls with the same stacks; the batch is
    padded to the mesh's batch multiple (repeating the last pair), each rank
    copies its block of rows from the stacks, where they lie, to its own
    device (``mesh``'s, which must be of ``device``'s type), the first
    rank's resolution of ``options`` is used by all, and the results are
    gathered (``DTensor.full_tensor``) and stripped of the pad rows.  Every rank returns the same result, equal to
    ``mesh=None``'s bit for bit.  Not an options field: it names ranks and
    devices, which no options-keyed cache should hold.
    """
    device = resolve_device(device, "register_batch")
    opts = merge_legacy_options(
        "register_batch", options,
        dict(tile=tile, levels=levels, iters=iters, lr=lr, bending_weight=bending_weight,
             mode=mode, impl=impl, grad_impl=grad_impl, compute_dtype=compute_dtype,
             similarity=similarity, transform=transform, regularizer=regularizer,
             stop=stop, optimizer=optimizer))
    if mesh is not None:
        if mesh.device_type != device.type:
            raise ValueError(f"register_batch got a {mesh.device_type} mesh and "
                             f"device={str(device)!r}")
        from repro_torch.engine import shard

        device = shard.mesh_device(mesh)
        # the stacks stay where they are: each rank copies only its rows
        fixed, moving = shard.as_source(fixed), shard.as_source(moving)
    else:
        fixed, moving = as_volume(fixed, device), as_volume(moving, device)
    if fixed.dim() != 4:
        raise ValueError(
            f"register_batch expects (B, X, Y, Z) stacks, got {tuple(fixed.shape)}; "
            "use ffd_register for a single pair")
    if fixed.shape[0] == 0:
        raise ValueError(
            "register_batch got an empty batch (B=0); supply at least one "
            "(fixed, moving) pair")
    if fixed.shape != moving.shape:
        raise ValueError(
            f"shape mismatch: {tuple(fixed.shape)} vs {tuple(moving.shape)}")
    vol_shape = tuple(fixed.shape[1:])
    if mesh is None:
        opts = resolve_options(opts, vol_shape, device)
    else:
        opts = shard.resolve_on_mesh(opts, vol_shape, device, mesh)

    t0 = time.perf_counter()
    b = fixed.shape[0]
    multiple = None if mesh is None else shard.batch_multiple(mesh)
    misses = _compiled_batch.cache_info().misses
    run = _compiled_batch(vol_shape, opts, multiple)
    compiled = _compiled_batch.cache_info().misses > misses
    stop = check_stop(opts.stop, opts.iters)
    steps = None
    if mesh is None:
        outs = [run(fixed[i].clone(), moving[i].clone()) for i in range(b)]
        warped, params, losses = (torch.stack([o[j] for o in outs]) for j in range(3))
        if stop is not None:
            steps = torch.tensor([o[3] for o in outs], dtype=torch.int32)
    else:
        out = run(shard.pad_batch(fixed, multiple)[0], shard.pad_batch(moving, multiple)[0],
                  mesh=mesh)
        # gather the shards and strip the pad rows
        warped, params, losses = (t.full_tensor()[:b] for t in out[:3])
        if stop is not None:
            steps = out[3].full_tensor()[:b].cpu()
    synchronize(device)
    return BatchRegistrationResult(warped, params, losses, time.perf_counter() - t0,
                                   compiled=compiled, steps=steps)


# ---------------------------------------------------------------------------
# The lanes of the continuous-batching scheduler (``engine.serve``).
#
# A stage's state is a dict of stacked ``(W, ...)`` tensors on the device,
# one row a lane: ``phi``, ``g``, ``best_p``, ``best``, ``loss``, ``since``,
# and the optimiser state under ``"opt"`` (``engine.optimizer.init_state``).
# Beside them the host keeps what it decides on: each lane's step index
# ``k`` (an int, as the solo loop passes it: Adam's bias correction rounds
# differently from a tensor index), ``since_read``, the lane's ``since`` as
# last read from the device, and ``active``, whether the row holds a pair.
# A stage's volumes are lists of separate tensors, one a lane.
# ---------------------------------------------------------------------------

_ROWS = ("phi", "g", "best_p", "best", "loss", "since")


def level_vol_shapes(vol_shape, levels):
    """Per-level volume shapes, coarse -> fine (``downsample2`` geometry)."""
    shapes = [tuple(int(s) for s in vol_shape)]
    for _ in range(int(levels) - 1):
        shapes.append(tuple((s - s % 2) // 2 for s in shapes[-1]))
    return shapes[::-1]


def alloc_lanes(width, lvl_shape, options, device):
    """An empty stage state of ``width`` lanes at ``lvl_shape``."""
    grid = ffd.grid_shape_for_volume(lvl_shape, options.tile) + (3,)
    template = init_state(options.optimizer, torch.zeros(grid, device=device))

    def rows(shape=(), dtype=torch.float32):
        return torch.zeros((width,) + tuple(shape), dtype=dtype, device=device)

    return dict(phi=rows(grid), g=rows(grid), best_p=rows(grid), best=rows(),
                loss=rows(), since=rows(dtype=torch.int32),
                opt={n: rows(t.shape, t.dtype) for n, t in template.items()},
                k=[0] * width, since_read=[0] * width, active=[False] * width)


def _lane_row(state, i):
    """Lane ``i``'s device state as fresh contiguous copies of its rows.

    A row of a stacked grid starts at an offset that need not be a multiple
    of 16 bytes, and PyTorch's CUDA reductions pick their vectorised loads,
    and with them their summation order, by alignment: stepping on fresh
    copies sums as the solo loop does.
    """
    row = {key: state[key][i].clone() for key in _ROWS}
    row["opt"] = {n: t[i].clone() for n, t in state["opt"].items()}
    return row


def _set_lane(state, i, lane):
    """Write lane ``i``'s device state back into its rows."""
    for key in _ROWS:
        state[key][i].copy_(lane[key])
    for n, t in state["opt"].items():
        t[i].copy_(lane["opt"][n])


def _lane_init(phi, f, m, *, options):
    """A lane's state at the start of a level, as ``optimize_until`` starts
    it: one value-and-grad at ``phi`` seeds step 1 and the best loss."""
    loss, g = _lane_obj(f, m, options).vg(phi)
    loss = loss.to(torch.float32)
    p = phi.detach()
    return dict(phi=p, opt=init_state(options.optimizer, p), g=g, best_p=p, best=loss,
                loss=loss, since=torch.zeros((), dtype=torch.int32, device=p.device))


@functools.lru_cache(maxsize=128)
def compile_level_init(lvl_shape, options):
    """``(phi0, fixed, moving) -> lane``: one pair's state at the start of a
    level (``fixed``/``moving`` at ``lvl_shape``), unstacked.  Nothing is
    compiled; a plain function."""
    del lvl_shape  # cache key only
    return functools.partial(_lane_init, options=options)


@functools.lru_cache(maxsize=128)
def compile_level_splice(lvl_shape, options):
    """``(state, fixed, moving, i, phi0, f, m) -> (state, fixed, moving)``:
    admit a pair into lane ``i``, its state initialised
    (``compile_level_init``) and written into row ``i``, its volumes into
    entry ``i`` of the stage's lists.  Nothing is compiled; a plain
    function, mutating its arguments."""
    init = compile_level_init(lvl_shape, options)

    def splice(state, fixed, moving, i, phi, f, m):
        _set_lane(state, i, init(phi, f, m))
        state["k"][i], state["since_read"][i], state["active"][i] = 0, 0, True
        fixed[i], moving[i] = f, m
        return state, fixed, moving

    return splice


@functools.lru_cache(maxsize=128)
def compile_level_chunk(lvl_shape, options, chunk):
    """``(state, fixed, moving) -> state``: ``chunk`` steps of one level.

    In each step every lane that is ``active`` and ``level_live`` (budget
    left and, under ``stop``, its patience open: ``optimize_until``'s loop
    condition) takes one ``optimize_plateau_step`` on fresh copies of its
    rows, with its host ``k``, and the results are written back.  Dead and
    empty lanes run nothing.  Under ``stop`` the stacked ``since`` is read
    once a step, after every live lane has taken it; without, liveness is
    ``k < iters`` and a chunk reads nothing.  A retired lane holds its solo
    result.  Without ``stop`` the tolerance is ``-inf``, so every accepted
    step "improves".  Nothing is compiled; a plain function, mutating
    ``state``.
    """
    del lvl_shape  # cache key only
    o = options
    stop = check_stop(o.stop, o.iters)
    tol = float("-inf") if stop is None else stop.tol

    def run(state, fixed, moving):
        tol_t = torch.tensor(tol, dtype=torch.float32, device=state["phi"].device)
        objs = {}
        for _ in range(int(chunk)):
            live = [i for i, active in enumerate(state["active"])
                    if active and level_live(state["k"][i], state["since_read"][i],
                                             stop=stop, iters=o.iters)]
            if not live:
                break
            for i in live:
                if i not in objs:
                    objs[i] = _lane_obj(fixed[i], moving[i], o)
                r = _lane_row(state, i)
                k, p, opt, g, loss, since, best, best_p = optimize_plateau_step(
                    objs[i], o.optimizer, state["k"][i], r["phi"], r["opt"], r["g"],
                    r["loss"], r["since"], r["best"], r["best_p"], tol=tol_t, lr=o.lr)
                _set_lane(state, i, dict(phi=p, opt=opt, g=g, best_p=best_p, best=best,
                                         loss=loss, since=since))
                state["k"][i] = k
            if stop is not None:  # the chunk's one read of the device a step
                state["since_read"] = state["since"].tolist()
        return state

    return run


@functools.lru_cache(maxsize=64)
def compile_finish(vol_shape, options):
    """``(phi, moving) -> warped``: the finest grid's full-resolution
    displacement and the warp of the moving volume, as ``ffd_register``
    ends: in float32 whatever ``options.compute_dtype``, as the JAX
    package's pipeline ends.  Nothing is compiled; a plain function."""
    o = options

    def finish(phi, moving):
        with torch.no_grad():
            disp = dense_displacement(o.transform, phi, o.tile, vol_shape, mode=o.mode,
                                      impl=o.impl, grad_impl=o.grad_impl)
            return ffd.warp_volume(moving, disp)

    return finish
