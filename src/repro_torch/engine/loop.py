"""The optimisation loop of one pyramid level.

JAX's ``lax.scan`` over optimiser steps becomes a Python loop: PyTorch runs
eagerly, so each step's kernels are queued on the stream as the loop runs,
and the trace stays on the device until the caller reads it.  With
``stop=`` the loop is ``engine.convergence.optimize_until``.
"""

from __future__ import annotations

import torch

from repro_torch.core.options import UNSET, RegistrationOptions, merge_legacy_options
from repro_torch.engine.convergence import check_stop, optimize_until
from repro_torch.engine.optimizer import (AdamOptimizer, Objective, init_state,
                                          make_objective, opt_step, resolve_optimizer)

__all__ = ["make_adam_runner", "optimize_scan"]


def optimize_scan(obj, params, *, optimizer, iters, lr):
    """Run ``iters`` optimiser steps from ``params``.

    One value-and-grad at ``params`` seeds the first step; each step then
    updates and evaluates at the new params (a rejected second-order step
    leaves them in place).  Returns ``(params, trace)`` where ``trace[k]``
    is the loss after ``k+1`` steps.
    """
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    spec = resolve_optimizer(optimizer)
    opt = init_state(spec, params)
    loss, g = obj.vg(params)
    p, trace = params.detach(), []
    for k in range(iters):
        p, opt, g, loss, _ = opt_step(spec, obj, k, p, opt, g, loss, lr=lr)
        trace.append(loss)
    return p, torch.stack(trace)


def make_adam_runner(loss_builder, *, options=None, iters=UNSET, lr=UNSET, b1=0.9,
                     b2=0.999, eps=1e-8, stop=UNSET, optimizer=UNSET):
    """A ``(params, *data) -> (params, trace)`` runner for one level.

    ``loss_builder(*data)`` returns the scalar loss of the params or an
    :class:`~repro_torch.engine.optimizer.Objective`; ``options`` supplies
    ``iters``, ``lr``, ``optimizer`` (whose spec carries its own
    hyperparameters) and ``stop``.  The legacy ``iters=`` / ``lr=`` /
    ``stop=`` / ``optimizer=`` keywords still work through the deprecation
    shim (``core.options.merge_legacy_options``); one of the two spellings
    is needed.  ``b1`` / ``b2`` / ``eps`` are Adam's, folded into a default
    Adam spec as the JAX package folds them.  With a ``ConvergenceConfig``
    the runner returns ``(params, trace, steps_taken)``, the trace padded to
    ``stop.max_iters`` (``engine.convergence``).
    """
    if options is None and (iters is UNSET or lr is UNSET):
        raise TypeError("make_adam_runner needs options=RegistrationOptions(...) or "
                        "the legacy iters=/lr= keywords")
    options = merge_legacy_options(
        "make_adam_runner", options,
        dict(iters=iters, lr=lr, stop=stop, optimizer=optimizer))
    spec = resolve_optimizer(options.optimizer)
    if isinstance(spec, AdamOptimizer) and spec == AdamOptimizer():
        spec = AdamOptimizer(b1=b1, b2=b2, eps=eps)  # the defaults change nothing
    stop = check_stop(options.stop, options.iters)

    def run(p, *data):
        built = loss_builder(*data)
        obj = built if isinstance(built, Objective) else make_objective(built)
        if stop is None:
            return optimize_scan(obj, p, optimizer=spec, iters=options.iters,
                                 lr=options.lr)
        return optimize_until(obj, p, optimizer=spec, stop=stop, lr=options.lr)

    return run
