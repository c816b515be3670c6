"""Sharded batched registration: data parallelism over a ``torch.distributed``
mesh.

The JAX package places its batched program's batch axis over a
``jax.sharding.Mesh`` and one controller drives every device.  PyTorch runs
SPMD instead: every rank of the mesh calls the entry point with the same
full stacks, runs its contiguous block of the (padded) batch on its own
card, and the results come back as ``DTensor``s sharded on the batch
dimension, the counterpart of the JAX package's ``out_shardings``.

The layout comes from ``repro_torch.distributed.sharding.REGISTRATION_RULES``:
batch over the mesh's data axes, every per-pair axis (volume and grid
geometry, the displacement channel, pyramid level) replicated.  So the
optimisation loop has no collective: a rank runs ``engine.batch.ffd_pipeline``
on fresh copies of each of its rows, and a sharded result equals the
unsharded one bit for bit, pad rows included.

Batches that do not divide are padded (repeating the last pair) up to the
mesh's batch multiple; ``register_batch`` strips the pad rows on return.
Callers of ``compile_sharded_batch`` / ``sharded_pipeline`` get the padded
outputs and can mask the pad rows with ``batch_mask``.

``make_registration_mesh`` builds the mesh over the ranks of the process
group (``torchrun``'s, or a one-rank group it starts): NCCL on the card,
gloo on the CPU, and nothing else.  Every rank computes on
``cuda:{LOCAL_RANK}``.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import as_volume, resolve_device
from repro_torch.distributed.sharding import REGISTRATION_RULES, placements
from repro_torch.engine.autotune import resolve_options
from repro_torch.engine.batch import ffd_pipeline
from repro_torch.engine.convergence import check_stop

__all__ = [
    "VOLUME_AXES",
    "GRID_AXES",
    "LOSS_AXES",
    "make_registration_mesh",
    "batch_multiple",
    "pad_batch",
    "batch_mask",
    "lane_sharding",
    "sharded_pipeline",
    "compile_sharded_batch",
]

# Logical axes (REGISTRATION_RULES names) of the results.
VOLUME_AXES = ("batch", "vol_x", "vol_y", "vol_z")
GRID_AXES = ("batch", "grid_x", "grid_y", "grid_z", "disp")
LOSS_AXES = ("batch", "level")

# The process group's timeout: a rank that raises leaves the others waiting
# at their next collective, and the timeout ends that wait with an error.
TIMEOUT = datetime.timedelta(minutes=10)

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_registration_mesh(num_devices=None, *, devices=None, device="cuda"):
    """A 1-D ``("data",)`` ``DeviceMesh`` over the first ``num_devices`` ranks
    of the process group (default: all), or of ``devices``, a sequence of
    ranks.

    The axis is named ``"data"``: the name ``REGISTRATION_RULES`` binds the
    batch to.  Every rank of the group calls it (SPMD).  With no group
    initialised it starts one: from ``torchrun``'s environment when
    ``WORLD_SIZE`` > 1, else a one-rank group on an in-process store.  Its
    backend is NCCL for ``device="cuda"`` and gloo for ``"cpu"``; an
    initialised group without that backend raises, as does a card asked for
    on a host without one.  On the card the rank's device is
    ``cuda:{LOCAL_RANK}``, made current.
    """
    device = resolve_device(device, "the registration mesh")
    backend = _BACKENDS.get(device.type)
    if backend is None:
        raise ValueError(f"a registration mesh runs on 'cuda' or 'cpu', got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=TIMEOUT)
    elif backend not in dist.get_backend():
        raise RuntimeError(
            f"the process group's backend is {dist.get_backend()!r}; a registration "
            f"mesh on {device.type} needs {backend!r}")
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    n = len(ranks) if num_devices is None else int(num_devices)
    if not 1 <= n <= len(ranks):
        raise ValueError(
            f"need {n} ranks for a registration mesh, have {len(ranks)}; start more "
            "with torchrun --nproc-per-node")
    return DeviceMesh(device.type, ranks[:n], mesh_dim_names=("data",))


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on in ``mesh``: its current card, or
    the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _batch_dims(mesh):
    axes = REGISTRATION_RULES(mesh.mesh_dim_names)["batch"]
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    return [d for d, name in enumerate(mesh.mesh_dim_names) if name in axes]


def batch_multiple(mesh) -> int:
    """Shard count of the batch axis: what batch sizes must pad up to."""
    n = 1
    for d in _batch_dims(mesh):
        n *= mesh.size(d)
    return n


def batch_block(mesh) -> int:
    """This rank's block of the batch axis, ``0 .. batch_multiple(mesh) - 1``
    (row-major over the mesh's batch dimensions, as ``Shard(0)`` lays them
    out).  Raises on a rank outside the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the registration mesh")
    block = 0
    for d in _batch_dims(mesh):
        block = block * mesh.size(d) + coord[d]
    return block


def mesh_group(mesh):
    """The process group spanning ``mesh``'s ranks, for its broadcasts."""
    if mesh.ndim == 1:
        return mesh.get_group()
    if mesh.size() == dist.get_world_size():
        return None  # the default group
    raise ValueError("a broadcast over a mesh needs a 1-D mesh or one over every rank")


def mesh_rank(mesh, block) -> int:
    """The global rank of the mesh's ``block``-th rank (row-major)."""
    return int(mesh.mesh.flatten()[block])


def resolve_on_mesh(options, vol_shape, device, mesh):
    """``engine.autotune.resolve_options`` once for the mesh: its first rank
    resolves (on the card, racing the ``"auto"`` axes) and broadcasts the
    resolved axes, so every rank runs the same kernels."""
    if mesh.size() == 1:
        return resolve_options(options, vol_shape, device)
    src = mesh_rank(mesh, 0)
    axes = [None]
    if dist.get_rank() == src:
        r = resolve_options(options, vol_shape, device)
        axes = [dict(mode=r.mode, impl=r.impl, grad_impl=r.grad_impl, fused=r.fused,
                     fused_reason=r.fused_reason)]
    dist.broadcast_object_list(axes, src=src, group=mesh_group(mesh))
    return dataclasses.replace(options, **axes[0])


def as_source(x):
    """``x`` as a contiguous float32 tensor where it already lies (an array
    on the host): the stack or pair a rank copies only its own rows from, so
    no rank uploads what other ranks register."""
    return as_volume(x, x.device if isinstance(x, torch.Tensor) else "cpu")


def pad_batch(x, multiple):
    """Pad the leading axis up to ``multiple`` by repeating the last entry.

    Returns ``(padded, orig_b)``.  Repeating a real pair rather than zeros
    keeps the pad rows ordinary: no similarity ever sees an all-zero volume.
    """
    b = x.shape[0]
    if b == 0:
        # x[-1:] of an empty batch repeats nothing: padding would return an
        # empty stack and the pipeline fail later with a shape error
        raise ValueError(
            "pad_batch got an empty batch (leading axis 0); there is no last entry "
            "to repeat; supply at least one pair")
    pad = (-b) % int(multiple)
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    return x, b


def batch_mask(orig_b, padded_b):
    """Boolean ``(padded_b,)`` mask: True for real rows, False for padding."""
    return torch.arange(int(padded_b)) < int(orig_b)


def lane_sharding(mesh):
    """The placements of a leading lane or batch axis on ``mesh``: sharded
    over the data axes, as ``REGISTRATION_RULES`` places the batch.  Lane
    widths should be a multiple of ``batch_multiple(mesh)``."""
    return placements(mesh, ("batch",))


def sharded_pipeline(fixed, moving, *, options, mesh):
    """``ffd_pipeline`` over this rank's block of a padded ``(B, X, Y, Z)``
    stack pair.

    Every rank of ``mesh`` passes the same full stacks and resolved
    ``options``, on any device; ``B`` must be a multiple of
    ``batch_multiple(mesh)``.  Rank block ``r`` registers rows ``r * B / n
    .. (r + 1) * B / n - 1``, each on fresh copies of its volumes on the
    rank's device (``mesh_device``).  Returns ``DTensor``s of the whole batch,
    ``(warped, phi, losses)`` with shapes ``(B, X, Y, Z)``, ``(B, *grid, 3)``
    and ``(B, levels)``, and under ``options.stop`` also ``steps``, ``(B,
    levels)`` int32; each sharded on dimension 0 (``REGISTRATION_RULES``).
    """
    from torch.distributed.tensor import DTensor  # a second to import

    b = fixed.shape[0]
    n = batch_multiple(mesh)
    if b % n:
        raise ValueError(
            f"sharded_pipeline got a batch of {b}, not a multiple of the mesh's "
            f"{n} shards; pad it first (pad_batch)")
    local = b // n
    start = batch_block(mesh) * local
    device = mesh_device(mesh)
    outs = [ffd_pipeline(fixed[i].to(device, copy=True), moving[i].to(device, copy=True),
                         options=options)
            for i in range(start, start + local)]
    warped, phi, losses = (torch.stack([o[j] for o in outs]) for j in range(3))

    def shard(t, axes):
        return DTensor.from_local(t, mesh, placements(mesh, axes), run_check=False)

    out = (shard(warped, VOLUME_AXES), shard(phi, GRID_AXES), shard(losses, LOSS_AXES))
    if check_stop(options.stop, options.iters) is None:
        return out
    steps = torch.tensor([o[3] for o in outs], dtype=torch.int32, device=warped.device)
    return out + (shard(steps, LOSS_AXES),)


def compile_sharded_batch(mesh, options):
    """The sharded pipeline of one ``(mesh, options)``: ``(fixed, moving) ->
    DTensors`` (:func:`sharded_pipeline`).

    Uncached: ``engine.batch._compiled_batch`` is the one cache, keyed by
    the mesh's batch multiple, and it binds no mesh (a ``DeviceMesh`` hashes
    without its process group, so a cached one could outlive its group).
    Nothing is compiled; the kernels are built at their first launch.
    """
    return functools.partial(sharded_pipeline, options=options, mesh=mesh)
