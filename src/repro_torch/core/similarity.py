"""Similarity terms: ``(warped, fixed) -> scalar`` losses, lower = better.

The registry holds ``ssd``, the mono-modal default; ``ncc``, ``lncc`` and
``nmi`` are not in the package yet (ROADMAP.md queue 1 item 8).  A loss
callable passes through unregistered and runs on the unfused level step.
"""

from __future__ import annotations

import torch

from repro_torch.core.registry import Registry

__all__ = ["SIMILARITIES", "fused_spec", "resolve_similarity", "ssd"]

SIMILARITIES = Registry("similarity", passthrough=callable, hint="or pass a callable")


def resolve_similarity(similarity):
    """Resolve a name-or-callable to ``(key, loss_fn)``."""
    return SIMILARITIES.resolve(similarity)


def fused_spec(similarity):
    """The fused-kernel spec tuple of ``similarity`` (``("ssd",)``), or None."""
    _, fn = resolve_similarity(similarity)
    return getattr(fn, "_fused_spec", None)


@SIMILARITIES.register("ssd")
def ssd(warped, fixed):
    """Mean squared intensity difference (mono-modal default)."""
    return torch.mean((warped - fixed) ** 2)


ssd._fused_spec = ("ssd",)
