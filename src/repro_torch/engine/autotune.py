"""Autotuner: pick the fastest BSI (mode, impl, grad_impl) and level step for a
configuration, on the device that will run it.

A port of the JAX package's ``repro/engine/autotune.py`` with the same public
names.  Which BSI form is fastest depends on the tile, the grid and the
device (paper §5), so instead of pinning ``mode`` / ``impl`` / ``grad_impl``
the caller may leave any of them ``"auto"``: the tuner times the candidate
forms on the workload the registration loop runs and caches the winner:

* in-process, keyed by ``device|grid|tile`` and what else changes
  the measurement (the similarity, a compute dtype as ``|cd=bfloat16``, the
  velocity transform, a non-default optimiser, the candidate list);
* on disk as JSON, at ``$REPRO_TORCH_AUTOTUNE_CACHE`` or
  ``~/.cache/repro_torch/bsi_autotune.json``.  The file is versioned
  (``SCHEMA_VERSION``, entries under ``{"__schema__": N, "entries": {...}}``)
  and replaced atomically; a corrupt file, another schema's file or a
  malformed entry reads as a miss (re-measure and rewrite).  The key starts
  with the device's name (``cuda:NVIDIA H100 80GB HBM3|g...``), so a file
  written on another card is a miss.

:func:`resolve_bsi` passes explicit choices through and tunes only the
``"auto"`` axes; :func:`resolve_options` also races the fused level step
against the unfused winner when ``fused="auto"`` (:func:`autotune_fused`) and
records why ``fused`` resolved as it did on ``fused_reason``.

Unlike the JAX package, the device is an argument of every function (nothing
reads a global backend), the workload is always the registration step's
gradient, and a race swallows no error.  On a CUDA device ``impl="auto"``
races the forward kernels only: the plain forms run there only when the
caller names ``impl="torch"`` or a mode with no kernel (``gather``).  A candidate the options refuse (a kernel
forward under ``grad_impl="autograd"``) is left out when the pool is built.
The one error a candidate may raise and be stepped past is a plain form's
``torch.cuda.OutOfMemoryError`` (the plain ``gather`` form under autograd
saves ~47 GB at the paper's phantom1 volume), recorded as "did not fit"; a
kernel that fails to build, launch or allocate raises.  Every race measured
in this process is appended to :data:`RACES`.

Under a ``compute_dtype`` the workload runs in it and ``grad_impl="auto"``
never picks ``autograd``, whose backward would differentiate the reduced
forward rather than accumulate the analytic adjoint in float32.  Under
``"bfloat16"`` (``"float16"``) on a CUDA device the race times the four
forms' bf16 (fp16) kernels, and ``fused="auto"`` races the fused level step
in that dtype (the matrix form for ``matmul``, the lerp form for the
others) against the unfused winner, the races keyed ``|cd=bfloat16|``
(``|cd=float16|``).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
import warnings

import numpy as np
import torch

from repro_torch.core.interpolate import (GRAD_IMPLS, KERNEL_MODES, MODE_NAMES,
                                          compute_dtype_name, interpolate)
from repro_torch.core.similarity import fused_spec, resolve_similarity, similarity_token

__all__ = ["BsiChoice", "RACES", "Race", "SCHEMA_VERSION", "autotune_bsi",
           "autotune_fused", "resolve_bsi", "resolve_options", "default_candidates",
           "default_grad_impls", "default_cache_path"]

PLAIN_CANDIDATES = tuple((m, "torch") for m in MODE_NAMES)
KERNEL_CANDIDATES = tuple((m, "cuda") for m in KERNEL_MODES)

# Disk-cache schema of this package (its own line of versions, not the JAX
# package's).  Bump it when the candidate space or an entry's fields change,
# so a file written before reads as a miss.
SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class BsiChoice:
    mode: str
    impl: str
    us_per_call: float
    grad_impl: str = "autograd"  # the adjoint; "autograd" is plain autodiff
    fused: str = "off"  # "on": the fused level step won (autotune_fused only)


@dataclasses.dataclass(frozen=True)
class Race:
    """One measured race: its cache key, its wall seconds (inputs included),
    each candidate's median microseconds (None: did not fit in device
    memory) and the winner."""

    key: str
    seconds: float
    timings: tuple  # ((candidate name, us or None), ...) in race order
    winner: BsiChoice


RACES: list = []  # every race measured in this process, oldest first
_MEM_CACHE: dict = {}


def default_cache_path() -> str:
    return os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "bsi_autotune.json")


def default_candidates(device):
    """``(mode, impl)`` forms ``impl="auto"`` times on ``device``: on a CUDA
    device the forward kernels (each takes float32, bf16 and fp16), on the
    CPU the plain forms (there a kernel's dispatcher runs its plain version, so
    timing it says nothing of the kernel)."""
    if torch.device(device).type == "cuda":
        return KERNEL_CANDIDATES
    return PLAIN_CANDIDATES


def default_grad_impls(device):
    """Adjoints worth timing on ``device``: plain autodiff and the plain
    analytic adjoint, and on a CUDA device the two adjoint kernels."""
    impls = ("autograd", "torch")
    if torch.device(device).type == "cuda":
        impls += ("cuda", "matmul")
    return impls


def _runs(impl, grad_impl) -> bool:
    """Whether the options accept the pair: a kernel forward has no autograd
    graph, so it needs an analytic adjoint."""
    return not (impl == "cuda" and grad_impl == "autograd")


def _cross(pairs, grad_impls):
    """``(mode, impl, grad_impl)`` triples: ``(mode, impl)`` pairs crossed
    with ``grad_impls``, less those the options refuse."""
    return tuple((mode, impl, gi) for mode, impl in pairs for gi in grad_impls
                 if _runs(impl, gi))


def _key(device, grid_shape, tile) -> str:
    name = (f"cuda:{torch.cuda.get_device_name(device)}" if device.type == "cuda"
            else device.type)
    g = "x".join(map(str, grid_shape))
    t = "x".join(map(str, tile))
    return f"{name}|g{g}|t{t}|c3"


def _load_disk(path) -> dict:
    """The file's entries; a corrupt file, or one of another schema, is {}."""
    try:
        with open(path) as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict) or data.get("__schema__") != SCHEMA_VERSION:
        return {}
    entries = data.get("entries")
    return entries if isinstance(entries, dict) else {}


def _parse_choice(hit):
    """A cache entry as a ``BsiChoice``; a malformed one (fields missing,
    mistyped or naming no form of this package) is None."""
    try:
        choice = BsiChoice(str(hit["mode"]), str(hit["impl"]),
                           float(hit["us_per_call"]), str(hit["grad_impl"]),
                           str(hit["fused"]))
    except (KeyError, TypeError, ValueError):
        return None
    ok = (choice.mode in MODE_NAMES and choice.impl in ("torch", "cuda")
          and choice.grad_impl in GRAD_IMPLS and choice.fused in ("on", "off")
          and _runs(choice.impl, choice.grad_impl)
          and (choice.impl == "torch" or choice.mode in KERNEL_MODES))
    return choice if ok else None


def _store_disk(path, key, choice) -> None:
    entries = _load_disk(path)
    entries[key] = dataclasses.asdict(choice)
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump({"__schema__": SCHEMA_VERSION, "entries": entries}, fh, indent=1,
                      sort_keys=True)
        os.replace(tmp, path)  # atomic: concurrent tuners never corrupt it
    except OSError as err:
        # the choice is still returned and kept in this process; every new
        # process will race again
        warnings.warn(f"autotune cache {path} not written: {err}", RuntimeWarning,
                      stacklevel=3)


def _cached(cache_path, key):
    """The cached choice of ``key``, in memory or on disk, or None."""
    mem_key = (cache_path, key)
    if mem_key in _MEM_CACHE:
        return _MEM_CACHE[mem_key]
    hit = _load_disk(cache_path).get(key)
    choice = _parse_choice(hit) if hit else None
    if choice is not None:
        _MEM_CACHE[mem_key] = choice
    return choice


def _keep(cache_path, key, choice):
    _MEM_CACHE[(cache_path, key)] = choice
    _store_disk(cache_path, key, choice)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_us(fn, device, reps, plain):
    """One warm-up call, then the median of ``reps`` host-clock intervals,
    each closed by a device synchronisation.  None if a ``plain`` form ran
    out of device memory; a kernel's out-of-memory error raises."""
    try:
        fn()
        _sync(device)
        times = []
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            fn()
            _sync(device)
            times.append(time.perf_counter() - t0)
        return float(np.median(times) * 1e6)
    except torch.cuda.OutOfMemoryError:
        if not plain:
            raise
    # outside the handler: its traceback no longer holds the call's tensors
    torch.cuda.empty_cache()
    return None


def _tensor(values, device):
    return torch.from_numpy(np.asarray(values, np.float32)).to(device)


def autotune_bsi(grid_shape, tile, *, device, similarity="ssd", candidates=None,
                 reps=3, cache_path=None, stop=None, transform=None,
                 optimizer=None, compute_dtype=None) -> BsiChoice:
    """Time one registration-step gradient of each candidate BSI form on
    ``device`` and return (and cache) the fastest.

    The workload is the loop's: forward and backward of
    ``similarity(warp(moving, bsi(phi)), fixed)``, ``phi`` a 3-channel grid,
    on random volumes at the tile-multiple volume of the grid.

    Args:
      grid_shape: stored control-grid dims ``(Tx+3, Ty+3, Tz+3)``.
      tile: control-point spacing ``(dx, dy, dz)``.
      device: where to time (a ``torch.device`` or its name).
      similarity: the objective; the cache entry is per-similarity.
      candidates: ``(mode, impl, grad_impl)`` triples (default: every
        :func:`default_candidates` form with every
        :func:`default_grad_impls` adjoint the options accept).
      reps: timed calls per candidate, after one warm-up call.
      cache_path: the JSON cache (None: :func:`default_cache_path`).
      stop: must be None.  The workload is one fixed step: early stopping
        changes how many steps run, not the per-step cost a form is ranked
        on.
      transform: the options' transform; under ``velocity`` the workload
        integrates the field by scaling and squaring before the warp, and
        the key gains ``|tf=...``.
      optimizer: the options' optimiser.  The workload stays the one
        forward and backward step every optimiser runs, but a non-default
        optimiser keys its entry apart (``|opt=...``).
      compute_dtype: the options' compute dtype; the workload's BSI and
        warp run in it and the key gains ``|cd=<name>``.
    """
    if stop is not None:
        raise ValueError(
            "autotune_bsi times a fixed-iteration workload; stop= must be None "
            "(early stopping changes step count, not per-step cost)")
    from repro_torch.core.ffd import warp_volume
    from repro_torch.core.transform import (VelocityTransform, resolve_transform,
                                            scaling_and_squaring, transform_token)
    from repro_torch.engine.optimizer import optimizer_token

    device = torch.device(device)
    grid_shape = tuple(int(g) for g in grid_shape)
    tile = tuple(int(t) for t in tile)
    cd = compute_dtype_name(compute_dtype)
    cands = (_cross(default_candidates(device), default_grad_impls(device))
             if candidates is None else tuple(tuple(c) for c in candidates))
    if not cands:
        raise ValueError(f"no BSI candidate to time among {candidates}")
    tspec = None if transform is None else resolve_transform(transform)
    velocity = isinstance(tspec, VelocityTransform)
    opt_token = None if optimizer is None else optimizer_token(optimizer)
    key = (_key(device, grid_shape, tile) + f"|grad|sim={similarity_token(similarity)}"
           + ("" if cd is None else f"|cd={cd}")
           + (f"|tf={transform_token(tspec)}" if velocity else "")
           + ("" if opt_token in (None, "adam") else f"|opt={opt_token}")
           + "|" + ",".join("/".join(c) for c in cands))
    cache_path = default_cache_path() if cache_path is None else cache_path
    choice = _cached(cache_path, key)
    if choice is not None:
        return choice

    t_race = time.perf_counter()
    _, sim_fn = resolve_similarity(similarity)
    rng = np.random.default_rng(0)
    phi = _tensor(rng.standard_normal(grid_shape + (3,)), device)
    dense_shape = tuple((g - 3) * t for g, t in zip(grid_shape, tile))
    fix = _tensor(rng.random(dense_shape), device)
    mov = _tensor(rng.random(dense_shape), device)

    def workload(mode, impl, grad_impl):
        def fn():
            p = phi.detach().requires_grad_(True)
            out = interpolate(p, tile, mode=mode, impl=impl, grad_impl=grad_impl,
                              dtype=cd)
            if velocity:
                out = scaling_and_squaring(out, tspec.squarings)
            warped = warp_volume(mov, out, compute_dtype=cd)
            torch.autograd.grad(sim_fn(warped.to(torch.float32), fix), p)
        return fn

    timings, best = [], None
    for mode, impl, gi in cands:
        us = _median_us(workload(mode, impl, gi), device, reps, plain=impl == "torch")
        timings.append((f"{mode}/{impl}/{gi}", us))
        if us is not None and (best is None or us < best.us_per_call):
            best = BsiChoice(mode, impl, us, gi)
    if best is None:
        raise RuntimeError(
            f"no BSI candidate fit in device memory for grid={grid_shape} "
            f"tile={tile} on {device}: {timings}")
    RACES.append(Race(key, time.perf_counter() - t_race, tuple(timings), best))
    _keep(cache_path, key, best)
    return best


def autotune_fused(grid_shape, tile, vol_shape, *, base, similarity, device, reps=3,
                   cache_path=None, compute_dtype=None) -> BsiChoice:
    """Race the fused level step against the unfused one on ``device``.

    ``base`` is the resolved unfused ``BsiChoice`` (concrete ``mode``,
    ``impl``, ``grad_impl``).  The race times one level-step gradient,
    BSI + warp + ``similarity`` forward and backward on random volumes of
    ``vol_shape``, through ``core.ffd.fused_warp_loss`` and through the
    unfused composition, and returns ``base`` with ``fused`` set to the
    winner.  A similarity with no fused kernel resolves ``"off"`` without a
    race.  Cached like :func:`autotune_bsi`, keyed per volume, similarity and
    base, and the compute dtype (``|cd=<name>``), in which both steps run.
    It races on whatever device it is given; :func:`resolve_options` calls
    it only for a CUDA device.
    """
    from repro_torch.core import ffd

    device = torch.device(device)
    grid_shape = tuple(int(g) for g in grid_shape)
    tile = tuple(int(t) for t in tile)
    vol_shape = tuple(int(s) for s in vol_shape)
    cd = compute_dtype_name(compute_dtype)
    if fused_spec(similarity) is None:
        return dataclasses.replace(base, fused="off")
    key = (_key(device, grid_shape, tile) + "|fused|v" + "x".join(map(str, vol_shape))
           + f"|sim={similarity_token(similarity)}"
           + ("" if cd is None else f"|cd={cd}")
           + f"|base={base.mode}/{base.impl}/{base.grad_impl}")
    cache_path = default_cache_path() if cache_path is None else cache_path
    choice = _cached(cache_path, key)
    if choice is not None:
        return choice

    t_race = time.perf_counter()
    _, sim_fn = resolve_similarity(similarity)
    rng = np.random.default_rng(0)
    phi = _tensor(rng.standard_normal(grid_shape + (3,)), device)
    mov = _tensor(rng.random(vol_shape), device)
    fix = _tensor(rng.random(vol_shape), device)
    bsi = dict(mode=base.mode, impl=base.impl, grad_impl=base.grad_impl,
               compute_dtype=cd)

    def unfused_loss(p):
        disp = ffd.dense_field(p, tile, vol_shape, **bsi)
        return sim_fn(ffd.warp_volume(mov, disp, compute_dtype=cd).to(torch.float32), fix)

    def fused_loss(p):
        return ffd.fused_warp_loss(p, mov, fix, tile, similarity=similarity, **bsi)

    def step(loss):
        def fn():
            p = phi.detach().requires_grad_(True)
            torch.autograd.grad(loss(p), p)
        return fn

    # both steps' backward runs the base's forms
    timings = [(f"fused={flag}", _median_us(step(loss), device, reps,
                                            plain=base.impl == "torch"))
               for flag, loss in (("off", unfused_loss), ("on", fused_loss))]
    timed = [(us, name[len("fused="):]) for name, us in timings if us is not None]
    if not timed:
        raise RuntimeError(
            f"neither level step fit in device memory for volume {vol_shape} on "
            f"{device}")
    us, flag = min(timed)
    best = dataclasses.replace(base, fused=flag, us_per_call=us)
    RACES.append(Race(key, time.perf_counter() - t_race, tuple(timings), best))
    _keep(cache_path, key, best)
    return best


def _candidate_pool(mode, impl, device):
    """``(mode, impl)`` candidates honouring the fixed axes: an explicit
    ``impl`` takes its forms on any device (``"cuda"`` on the CPU times the
    kernels' plain versions); ``"auto"`` takes :func:`default_candidates`,
    or the plain form of a ``mode`` that has no kernel (``gather``)."""
    if impl == "torch" or (impl == "auto" and mode in MODE_NAMES
                           and mode not in KERNEL_MODES):
        pool = PLAIN_CANDIDATES
    elif impl == "cuda":
        pool = KERNEL_CANDIDATES
    else:
        pool = default_candidates(device)
    return tuple(c for c in pool if mode in ("auto", c[0]))


def resolve_bsi(mode, impl, grid_shape, tile, *, grad_impl, device, **tune_kwargs):
    """``(mode, impl, grad_impl)`` with every ``"auto"`` resolved.

    Explicit choices pass through untouched; an ``"auto"`` axis narrows the
    candidates to the fixed axes and times the rest
    (:func:`autotune_bsi`, which takes ``tune_kwargs``).  Under a
    ``compute_dtype`` (in ``tune_kwargs``) ``grad_impl="auto"`` leaves
    ``autograd`` out: only the analytic adjoints accumulate in float32 (an
    explicit ``"autograd"`` passes through).
    """
    if grad_impl != "auto" and grad_impl not in GRAD_IMPLS:
        raise ValueError(
            f"unknown grad_impl {grad_impl!r}; choose from {GRAD_IMPLS} or 'auto'")
    if "auto" not in (mode, impl, grad_impl):
        return mode, impl, grad_impl
    cd = compute_dtype_name(tune_kwargs.get("compute_dtype"))
    gis = default_grad_impls(device) if grad_impl == "auto" else (grad_impl,)
    if grad_impl == "auto" and cd is not None:
        gis = tuple(g for g in gis if g != "autograd")
    cands = _cross(_candidate_pool(mode, impl, device), gis)
    if not cands:
        raise ValueError(f"no BSI candidates match mode={mode!r} impl={impl!r} "
                         f"grad_impl={grad_impl!r}")
    if len(cands) == 1:
        return cands[0]
    choice = autotune_bsi(grid_shape, tile, device=device, candidates=cands,
                          **tune_kwargs)
    return choice.mode, choice.impl, choice.grad_impl


@functools.lru_cache(maxsize=256)
def resolve_options(options, vol_shape, device):
    """``options`` for a volume of ``vol_shape`` on ``device``, every
    ``"auto"`` resolved, ``fused_reason`` set.

    The BSI axes are tuned jointly, forward + backward of the options'
    similarity on the finest grid (:func:`resolve_bsi`).  ``fused="auto"``
    is resolved last: on a CUDA device the fused level step races the
    unfused winner on the volume (:func:`autotune_fused`); on the CPU it
    resolves ``"off"`` without a race (the kernels' plain versions run
    there, and their time says nothing of the card); a similarity with no
    fused kernel, the velocity transform and Gauss-Newton resolve ``"off"``
    without a race.  Under a reduced ``compute_dtype`` the race runs both
    steps in it.  Cached on ``(options, vol_shape, device)``; ``fused_reason``
    is left out of the options' equality, so it never splits that cache.
    """
    from repro_torch.core import ffd
    from repro_torch.core.options import RegistrationOptions

    if not isinstance(options, RegistrationOptions):
        raise TypeError(
            f"resolve_options expects a RegistrationOptions, got {options!r}")
    device = torch.device(device)
    vol_shape = tuple(int(s) for s in vol_shape)
    grid_shape = ffd.grid_shape_for_volume(vol_shape, options.tile)
    from repro_torch.core.transform import VelocityTransform
    from repro_torch.engine.optimizer import GaussNewtonOptimizer

    mode, impl, grad_impl = resolve_bsi(
        options.mode, options.impl, grid_shape, options.tile, device=device,
        grad_impl=options.grad_impl, similarity=options.similarity,
        transform=options.transform, optimizer=options.optimizer,
        compute_dtype=options.compute_dtype)
    is_velocity = isinstance(options.transform, VelocityTransform)
    is_gn = isinstance(options.optimizer, GaussNewtonOptimizer)
    fused, reason = options.fused, f"forced {options.fused}"
    if fused == "auto":
        if is_velocity:
            fused, reason = "off", ("velocity transform: the fused level step has "
                                    "no scaling-and-squaring composition")
        elif is_gn:
            fused, reason = "off", ("gauss_newton optimiser: the fused level step "
                                    "never materialises the residual volume")
        elif fused_spec(options.similarity) is None:
            fused, reason = "off", "unsupported: similarity has no fused kernel"
        elif device.type != "cuda":
            fused, reason = "off", (
                f"{device.type} device: the kernels run their plain versions there, "
                "so a race would say nothing of the card")
        else:
            choice = autotune_fused(grid_shape, options.tile, vol_shape,
                                    base=BsiChoice(mode, impl, 0.0, grad_impl),
                                    similarity=options.similarity, device=device,
                                    compute_dtype=options.compute_dtype)
            fused = choice.fused
            reason = ("autotune: fused level step "
                      + ("won" if fused == "on" else "lost") + " the race")
    return dataclasses.replace(options, mode=mode, impl=impl, grad_impl=grad_impl,
                               fused=fused, fused_reason=reason)
