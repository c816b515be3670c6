"""Optimisers: the ``optimizer=`` registry behind the level loop.

``adam`` is the JAX package's default loop, step for step: the update comes
first, bias-corrected with the 1-based step index as a float32 scalar (so
``b1**i`` and ``b2**i`` are float32 powers, as in JAX), then one
value-and-grad at the new params.  ``lbfgs`` and ``gauss_newton`` are not in
the package yet (ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core.registry import Registry

__all__ = [
    "OPTIMIZERS",
    "AdamOptimizer",
    "Objective",
    "adam_update",
    "init_state",
    "make_objective",
    "opt_step",
    "resolve_optimizer",
]


@dataclasses.dataclass(frozen=True)
class AdamOptimizer:
    """Adam with the JAX package's defaults."""

    name = "adam"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def __post_init__(self):
        for field in ("b1", "b2"):
            v = float(getattr(self, field))
            if not 0.0 <= v < 1.0:
                raise ValueError(f"adam {field} must be in [0, 1), got {v}")
            object.__setattr__(self, field, v)
        eps = float(self.eps)
        if not eps > 0:
            raise ValueError(f"adam eps must be > 0, got {eps}")
        object.__setattr__(self, "eps", eps)


OPTIMIZERS = Registry(
    "optimizer", passthrough=lambda o: isinstance(o, AdamOptimizer))
OPTIMIZERS.register("adam", AdamOptimizer())


def resolve_optimizer(optimizer):
    """Resolve a name-or-spec to a frozen optimiser spec instance."""
    _, spec = OPTIMIZERS.resolve(optimizer)
    return spec


class Objective(NamedTuple):
    """The function a step minimises: ``loss(p)`` and ``vg(p) -> (loss, grad)``."""

    loss: Callable
    vg: Callable


def make_objective(loss_fn) -> Objective:
    """Wrap a scalar loss of the params as an :class:`Objective`."""

    def vg(p):
        p = p.detach().requires_grad_(True)
        loss = loss_fn(p)
        (g,) = torch.autograd.grad(loss, p)
        return loss.detach(), g

    return Objective(loss=loss_fn, vg=vg)


def adam_update(p, m, v, g, i, *, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam update, bias-corrected with step index ``i`` (1-based)."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mh = m / (1 - b1**i)
    vh = v / (1 - b2**i)
    return p - lr * mh / (torch.sqrt(vh) + eps), m, v


def init_state(optimizer, params) -> dict:
    """The optimiser state for ``params``: float32 first and second moments."""
    resolve_optimizer(optimizer)
    zeros = torch.zeros(params.shape, dtype=torch.float32, device=params.device)
    return {"m": zeros, "v": zeros}


def opt_step(optimizer, obj, k, p, opt, g, loss, *, lr):
    """One step from ``(p, g, loss)`` at the current params (``k`` 0-based).

    Returns ``(p1, opt1, g1, loss1)`` with ``g1``/``loss1`` at ``p1``.
    """
    del loss  # Adam reads only the gradient
    spec = resolve_optimizer(optimizer)
    # a fill on the device: a host-to-device copy would synchronise every step
    i = torch.full((), k + 1, dtype=torch.float32, device=p.device)
    p, m, v = adam_update(p, opt["m"], opt["v"], g, i, lr=lr, b1=spec.b1,
                          b2=spec.b2, eps=spec.eps)
    loss, g = obj.vg(p)
    return p, {"m": m, "v": v}, g, loss
