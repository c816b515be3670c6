"""Early stopping: a level's loop that ends when its loss stops improving.

:class:`ConvergenceConfig` is the ``stop=`` option: stop once ``patience``
consecutive steps have failed to beat the best loss by a relative ``tol``,
or at ``max_iters`` (by default the options' ``iters``).  A step improves
only if its optimiser accepted it (``ok`` of ``engine.optimizer.opt_step``)
*and* it beats the best loss: a collapsed L-BFGS line search or a refused
Gauss-Newton trial never counts as progress, so a stuck level ends after
``patience`` of them.  The loop returns the best params it visited.

JAX's ``lax.while_loop`` becomes a Python loop that reads one counter from
the device a step (its condition); the losses, the best loss and the best
params stay on the device.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.engine.optimizer import (AdamOptimizer, Objective, init_state,
                                          make_objective, opt_step, resolve_optimizer)

__all__ = ["ConvergenceConfig", "adam_until", "check_stop", "level_live",
           "optimize_plateau_step", "optimize_until", "plateau_step"]


@dataclasses.dataclass(frozen=True)
class ConvergenceConfig:
    """Early-stopping rule of a level's loop.

    Stop when ``patience`` consecutive steps have gone by without one beating
    the best loss so far by more than ``tol`` (relative:
    ``(best - loss) / max(|best|, 1e-12)``), or at ``max_iters``.
    ``max_iters=None`` inherits the caller's ``iters`` (:meth:`resolve`).
    """

    tol: float = 1e-4
    patience: int = 5
    max_iters: int | None = None

    def __post_init__(self):
        if self.tol < 0:
            raise ValueError(f"tol must be >= 0, got {self.tol}")
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")
        if self.max_iters is not None and self.max_iters < 1:
            raise ValueError(f"max_iters must be >= 1, got {self.max_iters}")

    def resolve(self, iters) -> "ConvergenceConfig":
        """A copy with a concrete ``max_iters`` (default: ``iters``)."""
        mx = int(iters) if self.max_iters is None else int(self.max_iters)
        return dataclasses.replace(self, tol=float(self.tol), patience=int(self.patience),
                                   max_iters=mx)


def check_stop(stop, iters):
    """Validate and resolve a ``stop=`` value (None passes through): a bare
    tolerance (``stop=1e-4``) raises ``TypeError``; ``max_iters`` defaults to
    ``iters``."""
    if stop is None:
        return None
    if not isinstance(stop, ConvergenceConfig):
        raise TypeError(
            f"stop must be a ConvergenceConfig or None, got {stop!r}; "
            "e.g. stop=ConvergenceConfig(tol=1e-4)")
    return stop.resolve(iters)


def optimize_plateau_step(obj, optimizer, k, p, opt, g, loss, since, best, best_p, *,
                          tol, lr):
    """One step of the plateau-stopped loop and its bookkeeping.

    Runs one ``opt_step`` from ``(p, g, loss)`` and folds the best loss, the
    best params and ``since`` (consecutive steps that did not improve), all
    on the device.  Returns ``(k + 1, p, opt, g, loss, since, best, best_p)``,
    ``loss`` the step's trace entry.
    """
    p, opt, g, loss, ok = opt_step(optimizer, obj, k, p, opt, g, loss, lr=lr)
    gain = (best - loss) / torch.clamp(best.abs(), min=1e-12)
    improved = gain > tol
    if isinstance(ok, torch.Tensor):
        improved = torch.logical_and(ok, improved)
    elif not ok:
        improved = torch.zeros_like(improved)
    best_p = torch.where(improved, p, best_p)
    best = torch.where(improved, loss, best)
    since = torch.where(improved, torch.zeros_like(since), since + 1)
    return k + 1, p, opt, g, loss, since, best, best_p


def plateau_step(vg, k, p, m, v, g, since, best, best_p, *, tol, lr, b1=0.9, b2=0.999,
                 eps=1e-8):
    """The Adam spelling of :func:`optimize_plateau_step`, the moments as
    separate ``(m, v)`` operands.  Returns ``(k + 1, p, m, v, g, loss,
    since, best, best_p)``."""
    obj = Objective(loss=None, vg=vg)
    spec = AdamOptimizer(b1=b1, b2=b2, eps=eps)
    k1, p, opt, g, loss, since, best, best_p = optimize_plateau_step(
        obj, spec, k, p, {"m": m, "v": v}, g, best, since, best, best_p, tol=tol, lr=lr)
    return k1, p, opt["m"], opt["v"], g, loss, since, best, best_p


def level_live(k, since, *, stop, iters=None):
    """Whether a level's loop takes another step: ``optimize_until``'s loop
    condition under ``stop`` (a resolved ``ConvergenceConfig``), else the
    fixed budget ``k < iters``.  The scheduler's retire signal of a lane;
    ints give a bool, tensors a bool tensor."""
    if stop is None:
        return k < int(iters)
    return (k < int(stop.max_iters)) & (since < int(stop.patience))


def optimize_until(obj, params, *, optimizer, stop, lr):
    """A registered optimiser that stops on a plateau or at ``stop.max_iters``.

    Returns ``(params, trace, steps_taken)``: the best params visited (the
    start counts), the ``(stop.max_iters,)`` trace (``trace[k]`` the loss
    after ``k + 1`` steps, the entries past the last step padded with the
    best loss, and ``trace[-1]`` always the best loss, the loss of the
    returned params) and the steps taken, an int.
    """
    if not isinstance(stop, ConvergenceConfig):
        raise TypeError(f"stop must be a ConvergenceConfig, got {stop!r}")
    if stop.max_iters is None:
        raise ValueError("stop.max_iters is unresolved; call stop.resolve(iters) first")
    spec = resolve_optimizer(optimizer)
    max_iters, patience = int(stop.max_iters), int(stop.patience)
    opt = init_state(spec, params)

    loss, g = obj.vg(params)  # the gradient at the start seeds step 1
    loss = loss.to(torch.float32)
    p = params.detach()
    device = p.device
    tol = torch.tensor(stop.tol, dtype=torch.float32, device=device)
    trace = torch.zeros((max_iters,), dtype=torch.float32, device=device)
    since = torch.zeros((), dtype=torch.int32, device=device)
    best, best_p = loss, p
    k = 0
    while k < max_iters:
        k, p, opt, g, loss, since, best, best_p = optimize_plateau_step(
            obj, spec, k, p, opt, g, loss, since, best, best_p, tol=tol, lr=lr)
        trace[k - 1] = loss
        if int(since) >= patience:  # the loop's one read of the device a step
            break
    # pad the tail with the best loss, and pin the last slot to it: trace[-1]
    # is the loss of the params returned, also when the last step was worse
    trace = torch.where(torch.arange(max_iters, device=device) < k, trace, best)
    trace[-1] = best
    return best_p, trace, k


def adam_until(loss_fn, params, *, stop, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The Adam face of :func:`optimize_until`."""
    return optimize_until(make_objective(loss_fn), params,
                          optimizer=AdamOptimizer(b1=b1, b2=b2, eps=eps), stop=stop, lr=lr)
