"""Continuous-batching registration serving: a queue over lane arrays.

``register_batch`` serves pairs that arrive together.  An intra-operative
service sees them arrive one at a time, with mixed difficulty, and each
caller cares about its own latency.  The scheduler here borrows continuous
batching from LM serving: a lane whose level loop has stopped (the
early-stopping rule of ``engine.convergence`` is the retire signal) is
freed between chunks and the next queued pair is spliced into it.

* Requests are **bucketed by volume shape**, the options resolved once per
  bucket (``engine.autotune.resolve_options``).
* Inside a bucket each pyramid level is a **stage**: ``lanes`` rows of
  optimiser state, stepped ``chunk`` steps at a time by
  ``engine.batch.compile_level_chunk``, which steps only the live lanes.
* After every chunk the host **harvests** the lanes whose loop stopped: a
  lane's state froze at its own stopping point, so its grid is the solo
  ``ffd_register``'s bit for bit.  It moves up a level (``upsample_grid``,
  as the solo pyramid does) or finishes with the full-resolution warp; and
  queued pairs fill the freed lanes (**recycling**).

The scheduler is synchronous and single-threaded: ``step()`` runs one
round, and the caller (:class:`AsyncRegistrationService`, the load
generator ``launch/serve_registration.py``, or a test with a fake clock)
owns the loop.  ``max_queue`` (:class:`QueueFull`) and ``timeout``
(:class:`RegistrationTimeout`) fail fast instead of hanging.  Every option
of ``RegistrationOptions`` runs in the lanes: the transform, regularizer and
optimiser change the lane's step, not the scheduling.  The scheduler runs
on the card unless given ``device="cpu"``.

With ``mesh=`` (``engine.shard.make_registration_mesh``) the lanes are split
over the mesh's ranks, SPMD: every rank builds the scheduler, submits the
same requests in the same order and drives ``step()`` alike.  Rank block
``r`` owns the lanes of its block and steps only those.  After each chunk
the ranks gather the lanes' host state (step index, ``since``, loss), so
harvest and recycling decide the same everywhere; a retired lane's grid
and a finished request's warp are broadcast from the lane's owner, so every
rank's handles return the same result.  A submitted pair waits where the
caller put it (an array on the host), and a rank builds its pyramid on its
card only when one of its own lanes takes it, so no rank holds the device
copies of pairs other ranks register.  The first rank resolves each
bucket's ``"auto"`` axes and broadcasts them, so every rank runs the same
kernels.  The clock that stamps requests and decides expiry is the first
rank's, broadcast each round; admission (:class:`QueueFull`) follows from
state every rank shares.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import itertools
import time
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core import ffd
from repro_torch.core.options import RegistrationOptions
from repro_torch.device import as_volume, resolve_device
from repro_torch.engine.autotune import resolve_options
from repro_torch.engine.batch import (alloc_lanes, compile_finish, compile_level_chunk,
                                      compile_level_splice, level_vol_shapes, pyramid)
from repro_torch.engine.convergence import check_stop, level_live
from repro_torch.engine.shard import (as_source, batch_block, batch_multiple,
                                      lane_sharding, mesh_device, mesh_group, mesh_rank,
                                      resolve_on_mesh)

__all__ = ["AsyncRegistrationService", "QueueFull", "RegistrationScheduler",
           "RegistrationTimeout", "RequestHandle", "ServeResult", "ServeStats"]


class QueueFull(RuntimeError):
    """Admission refused: the scheduler's queue holds ``max_queue`` requests.

    The caller sheds load or retries later; an unbounded queue would only
    turn overload into timeouts.
    """


class RegistrationTimeout(TimeoutError):
    """The request's deadline passed before it completed."""


@dataclasses.dataclass
class ServeResult:
    """One completed registration."""

    warped: Any  # (X, Y, Z) registered moving volume
    params: Any  # finest-level control grid (gx, gy, gz, 3)
    losses: list  # final loss per pyramid level (coarse -> fine)
    steps: list  # optimiser steps run per level
    seconds: float  # submit -> complete latency (scheduler clock)
    recycled: bool = False  # True if the request entered a mid-flight stage


@dataclasses.dataclass
class ServeStats:
    submitted: int = 0
    completed: int = 0
    timed_out: int = 0
    rejected: int = 0  # QueueFull admissions
    recycled: int = 0  # requests that entered a mid-flight stage
    buckets: int = 0  # distinct volume shapes seen
    compiles: int = 0  # distinct (level shape, options, chunk) stage keys acquired
    chunks: int = 0  # chunks run


@dataclasses.dataclass
class RequestHandle:
    """The caller's view of a submitted request.

    Poll ``done`` while driving ``scheduler.step()`` (or let
    :class:`AsyncRegistrationService` do both); then ``result()`` returns
    the :class:`ServeResult` or raises the request's failure.
    """

    id: int
    submitted_at: float
    done: bool = False
    _result: Any = None
    _error: Any = None

    def result(self) -> ServeResult:
        if not self.done:
            raise RuntimeError(
                f"request {self.id} is still in flight; drive scheduler.step() "
                "(or use AsyncRegistrationService)")
        if self._error is not None:
            raise self._error
        return self._result


@dataclasses.dataclass
class _Request:
    handle: RequestHandle
    volumes: Any  # with a mesh, the (fixed, moving) pair where the caller put it
    pyramid: Any  # [(f, m) per level], coarse -> fine, on this rank's device or None
    deadline: Any  # absolute clock time or None
    phi: Any = None  # the grid carried between levels
    losses: list = dataclasses.field(default_factory=list)
    steps: list = dataclasses.field(default_factory=list)
    recycled: bool = False


class _Stage:
    """One pyramid level's lanes inside a bucket."""

    def __init__(self, level):
        self.level = level
        self.queue = collections.deque()  # _Request waiting to enter
        self.state = None  # engine.batch.alloc_lanes's state, or None
        self.fixed = None  # [lane's fixed volume or None] at this level
        self.moving = None
        self.lanes = None  # [_Request or None]

    def any_active(self):
        return self.lanes is not None and any(r is not None for r in self.lanes)


class _Bucket:
    """The scheduling state of one volume shape."""

    def __init__(self, vol_shape, options):
        self.vol_shape = vol_shape
        self.options = options  # resolved for this shape
        self.lvl_shapes = level_vol_shapes(vol_shape, options.levels)
        self.stages = [_Stage(i) for i in range(options.levels)]


class RegistrationScheduler:
    """Continuous-batching scheduler for registration requests.

    Args:
      options: the ``RegistrationOptions`` every request runs under (one
        configuration a scheduler; buckets differ only in volume shape).
      lanes: lanes a stage, the pairs in flight at each pyramid level.
      chunk: optimiser steps between the host's looks.  Smaller frees lanes
        sooner but reads the device more often; it never changes results.
      max_queue: bound on waiting requests (across buckets); ``submit``
        raises :class:`QueueFull` beyond it.
      timeout: default seconds from submit until a request must have
        completed; an expired request fails with
        :class:`RegistrationTimeout` at the next round boundary (a chunk
        is never interrupted).
      mesh: optional ``DeviceMesh`` (``engine.shard.make_registration_mesh``):
        the lanes split over its ranks, ``lanes`` a multiple of
        ``engine.shard.batch_multiple(mesh)``; the lanes run on the rank's
        device (``mesh``'s, of ``device``'s type).
      clock: monotonic seconds (tests pass a fake clock).
      device: where the lanes run; the card unless ``"cpu"``.
    """

    def __init__(self, options=None, *, lanes=8, chunk=4, max_queue=64, timeout=None,
                 mesh=None, clock=time.monotonic, device="cuda"):
        if options is None:
            options = RegistrationOptions()
        if not isinstance(options, RegistrationOptions):
            raise TypeError(
                f"options must be a RegistrationOptions, got {type(options).__name__}")
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.device = resolve_device(device, "the registration scheduler")
        self.mesh = mesh
        self._block, self._width = 0, int(lanes)  # this rank's block of lanes
        if mesh is not None:
            mult = batch_multiple(mesh)
            if lanes % mult:
                raise ValueError(
                    f"lanes={lanes} must be a multiple of the mesh's batch multiple "
                    f"({mult}) for an even lane split")
            if mesh.device_type != self.device.type:
                raise ValueError(f"the scheduler got a {mesh.device_type} mesh and "
                                 f"device={str(self.device)!r}")
            self.device = mesh_device(mesh)
            self._group = mesh_group(mesh)
            self._block, self._width = batch_block(mesh), int(lanes) // mult
        self.options = options
        self.lanes = int(lanes)
        self.chunk = int(chunk)
        self.max_queue = int(max_queue)
        self.timeout = timeout
        self.clock = clock
        self.stats = ServeStats()
        self._buckets: dict = {}
        self._ids = itertools.count()
        self._queued = 0  # waiting for a first lane
        self._inflight = 0  # in a lane, or between levels
        self._programs: set = set()  # stage keys acquired

    # -- submission ----------------------------------------------------------

    def submit(self, fixed, moving, *, timeout=None) -> RequestHandle:
        """Queue one ``(fixed, moving)`` pair; returns at once.

        Raises :class:`QueueFull` when ``max_queue`` requests wait.  The
        pair's pyramid is built on the device here, so admission into a
        freed lane is a splice.  With a mesh the pair waits where the caller
        put it (an array on the host), and a rank builds its pyramid on its
        device only when one of its own lanes takes it.
        """
        if self.mesh is None:
            fixed, moving = as_volume(fixed, self.device), as_volume(moving, self.device)
        else:
            fixed, moving = as_source(fixed), as_source(moving)
        if fixed.dim() != 3 or fixed.shape != moving.shape:
            raise ValueError(
                "submit expects one (X, Y, Z) pair of equal shapes, got "
                f"{tuple(fixed.shape)} vs {tuple(moving.shape)}")
        if self._queued >= self.max_queue:
            self.stats.rejected += 1
            raise QueueFull(
                f"{self._queued} requests waiting (max_queue={self.max_queue}); "
                "retry later or raise max_queue")
        bucket = self._bucket_for(tuple(fixed.shape))
        now = self.now()
        timeout = self.timeout if timeout is None else timeout
        handle = RequestHandle(id=next(self._ids), submitted_at=now)
        sharded = self.mesh is not None
        req = _Request(handle=handle, volumes=(fixed, moving) if sharded else None,
                       pyramid=None if sharded else pyramid(fixed, moving,
                                                            bucket.options.levels),
                       deadline=None if timeout is None else now + float(timeout))
        bucket.stages[0].queue.append(req)
        self._queued += 1
        self.stats.submitted += 1
        return handle

    def _bucket_for(self, vol_shape) -> _Bucket:
        bucket = self._buckets.get(vol_shape)
        if bucket is None:
            # with a mesh the first rank resolves, so every rank runs the
            # same kernels
            opts = (resolve_options(self.options, vol_shape, self.device) if self.mesh is None
                    else resolve_on_mesh(self.options, vol_shape, self.device, self.mesh))
            bucket = _Bucket(vol_shape, opts)
            self._buckets[vol_shape] = bucket
            self.stats.buckets += 1
        return bucket

    # -- the scheduling round ------------------------------------------------

    def step(self) -> int:
        """One round over every bucket; returns the requests completed.

        Per stage, coarse -> fine: expire dead queue entries, splice queued
        pairs into free lanes, run one chunk; then harvest the stages that
        ran, moving retired lanes up a level (so a pair can cross one stage
        a round) or finishing them.
        """
        done = 0
        now = self.now()
        for bucket in self._buckets.values():
            ran = []
            for stage in bucket.stages:
                self._expire(stage, now)
                self._fill(bucket, stage)
                if not stage.any_active():
                    continue
                key = (bucket.lvl_shapes[stage.level], bucket.options, self.chunk)
                if key not in self._programs:
                    self._programs.add(key)
                    self.stats.compiles += 1
                compile_level_chunk(*key)(stage.state, stage.fixed, stage.moving)
                self.stats.chunks += 1
                ran.append(stage)
            for stage in ran:
                done += self._harvest(bucket, stage)
        return done

    def run_until_idle(self, max_rounds=100_000) -> int:
        """Drive ``step()`` until no request waits or is in flight."""
        done = 0
        for _ in range(max_rounds):
            if not self.pending:
                return done
            done += self.step()
        raise RuntimeError(
            f"still {self._queued} queued / {self._inflight} in flight after "
            f"{max_rounds} rounds; is the clock advancing?")

    @property
    def pending(self) -> int:
        """Requests not yet completed (waiting or in a lane)."""
        return self._queued + self._inflight

    def now(self) -> float:
        """The scheduler's clock: ``clock()``, with a mesh the first rank's,
        broadcast (every rank calls it alike)."""
        now = self.clock()
        if self.mesh is None:
            return now
        t = torch.tensor([now], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=mesh_rank(self.mesh, 0), group=self._group)
        return t.item()

    # -- internals -----------------------------------------------------------

    def _local(self, i):
        """Lane ``i``'s row in this rank's state, or None if another rank
        owns it."""
        block, row = divmod(i, self._width)
        return row if block == self._block else None

    def _owner(self, i):
        """The global rank that owns lane ``i``."""
        return mesh_rank(self.mesh, i // self._width)

    def _expire(self, stage, now):
        keep = collections.deque()
        for req in stage.queue:
            if req.deadline is not None and now >= req.deadline:
                if stage.level == 0:  # the later stages' queues hold in-flight work
                    self._queued -= 1
                else:
                    self._inflight -= 1
                self.stats.timed_out += 1
                req.handle._error = RegistrationTimeout(
                    f"request {req.handle.id} expired after "
                    f"{now - req.handle.submitted_at:.3f}s waiting for a lane")
                req.handle.done = True
            else:
                keep.append(req)
        stage.queue = keep

    def _fill(self, bucket, stage):
        if not stage.queue:
            return
        lvl_shape = bucket.lvl_shapes[stage.level]
        splice = compile_level_splice(lvl_shape, bucket.options)
        mid_flight = stage.any_active()
        if stage.lanes is None:
            stage.state = alloc_lanes(self._width, lvl_shape, bucket.options, self.device)
            stage.fixed, stage.moving = [None] * self._width, [None] * self._width
            stage.lanes = [None] * self.lanes
        for i, slot in enumerate(stage.lanes):
            if slot is not None:
                continue
            if not stage.queue:
                break
            req = stage.queue.popleft()
            if req.phi is None:  # the coarsest level starts from the zero grid
                gshape = ffd.grid_shape_for_volume(lvl_shape, bucket.options.tile)
                req.phi = torch.zeros(gshape + (3,), dtype=torch.float32,
                                      device=self.device)
            row = self._local(i)
            if row is not None:  # only the lane's owner holds its state and volumes
                if req.pyramid is None:
                    req.pyramid = pyramid(*(v.to(self.device) for v in req.volumes),
                                          bucket.options.levels)
                f, m = req.pyramid[stage.level]
                splice(stage.state, stage.fixed, stage.moving, row, req.phi, f, m)
            else:
                req.pyramid = None
            stage.lanes[i] = req
            if stage.level == 0:
                self._queued -= 1
                self._inflight += 1
            if mid_flight and not req.recycled:
                req.recycled = True
                self.stats.recycled += 1

    def _harvest(self, bucket, stage) -> int:
        opts = bucket.options
        stop = check_stop(opts.stop, opts.iters)
        # the solo loop returns the best params it visited under stop, its
        # last params without
        grid, loss = ("best_p", "best") if stop is not None else ("phi", "loss")
        k, since, losses = self._lane_view(stage, loss)
        retired = [i for i, req in enumerate(stage.lanes)
                   if req is not None and not level_live(k[i], since[i], stop=stop,
                                                         iters=opts.iters)]
        if not retired:
            return 0
        if losses is None:
            losses = stage.state[loss].tolist()  # one read for the retired lanes
        done = 0
        for i in retired:
            req = stage.lanes[i]
            req.phi = self._lane_grid(stage, i, grid)
            req.losses.append(losses[i])
            req.steps.append(k[i])
            stage.lanes[i] = None
            row = self._local(i)
            if row is not None:
                stage.fixed[row] = stage.moving[row] = None
                stage.state["active"][row] = False
            if stage.level + 1 < opts.levels:
                gshape = ffd.grid_shape_for_volume(bucket.lvl_shapes[stage.level + 1],
                                                   opts.tile)
                req.phi = ffd.upsample_grid(req.phi, gshape).contiguous()
                bucket.stages[stage.level + 1].queue.append(req)
            else:
                self._finish(bucket, req, i)
                done += 1
        return done

    def _lane_view(self, stage, loss):
        """Every lane's step index, ``since`` and (with a mesh) ``loss``, as
        host lists: the state's own without a mesh (``loss`` then None, read
        only if a lane retires), else each rank's rows gathered."""
        state = stage.state
        if self.mesh is None:
            return state["k"], state["since_read"], None
        from torch.distributed.tensor import DTensor  # a second to import

        f64 = dict(dtype=torch.float64, device=self.device)
        rows = torch.stack([torch.tensor(state["k"], **f64),
                            torch.tensor(state["since_read"], **f64),
                            state[loss].to(torch.float64)], dim=1)
        full = DTensor.from_local(rows, self.mesh, lane_sharding(self.mesh),
                                  run_check=False).full_tensor().tolist()
        return ([int(r[0]) for r in full], [int(r[1]) for r in full],
                [r[2] for r in full])

    def _lane_grid(self, stage, i, grid):
        """A copy of lane ``i``'s ``grid`` row (the row is reused by the next
        splice); with a mesh, broadcast from the lane's owner."""
        row = self._local(i)
        if self.mesh is None:
            return stage.state[grid][row].clone()
        out = (stage.state[grid][row].clone() if row is not None
               else torch.empty_like(stage.state[grid][0]))
        dist.broadcast(out, src=self._owner(i), group=self._group)
        return out

    def _finish(self, bucket, req, i):
        """The full-resolution warp of ``req``, from lane ``i`` of the last
        level: with a mesh computed by the lane's owner and broadcast."""
        row = self._local(i)
        if row is not None:
            moving = req.pyramid[-1][1]  # full resolution
            warped = compile_finish(bucket.vol_shape, bucket.options)(req.phi, moving)
        if self.mesh is not None:
            warped = (warped.contiguous() if row is not None
                      else torch.empty(bucket.vol_shape, device=self.device))
            dist.broadcast(warped, src=self._owner(i), group=self._group)
        handle = req.handle
        handle._result = ServeResult(
            warped=warped, params=req.phi, losses=req.losses, steps=req.steps,
            seconds=self.now() - handle.submitted_at, recycled=req.recycled)
        handle.done = True
        req.pyramid = req.volumes = None
        self._inflight -= 1
        self.stats.completed += 1


class AsyncRegistrationService:
    """Asyncio facade: ``await service.register(fixed, moving)``.

    Concurrent ``register`` calls share the scheduler through a lock, each
    pumping ``step()`` in the default executor (so the event loop stays live
    while the device works) until its own request completes.  Admission and
    deadline failures surface as the scheduler's exceptions.
    ``scheduler_kwargs`` build the scheduler, ``mesh=`` included.
    """

    def __init__(self, scheduler=None, **scheduler_kwargs):
        self.scheduler = (RegistrationScheduler(**scheduler_kwargs)
                          if scheduler is None else scheduler)
        self._lock = asyncio.Lock()

    async def register(self, fixed, moving, *, timeout=None) -> ServeResult:
        handle = self.scheduler.submit(fixed, moving, timeout=timeout)
        loop = asyncio.get_running_loop()
        while not handle.done:
            async with self._lock:
                if not handle.done:
                    await loop.run_in_executor(None, self.scheduler.step)
            await asyncio.sleep(0)  # let other registrations interleave
        return handle.result()
