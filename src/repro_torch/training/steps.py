"""The prefill and decode steps the server runs.

The port of the serving half of the JAX package's ``repro/training/steps.py``
(the train step waits for training, ROADMAP queue 1 item 17c).  The JAX
steps cast the float32 masters to the compute dtype inside every call; these
cast once, when the step is built, and close over the cast copy.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M

__all__ = ["make_prefill_step", "make_decode_step"]


def _cast(model: M.DecoderLM, dtype) -> M.DecoderLM:
    """``model`` with its floating parameters in ``dtype`` (a config's dtype
    name or a ``torch.dtype``): a new model, the masters left as they are;
    ``model`` itself when they already are."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if all(p.dtype == dt for p in model.parameters() if p.is_floating_point()):
        return model
    return M.DecoderLM(model.cfg, M.map_tree(
        lambda t: t.to(dt) if t.is_floating_point() else t, model.tree()))


def make_prefill_step(cfg: ModelConfig, model: M.DecoderLM, max_len=None):
    """``prefill_step(batch) -> (logits, cache)`` on ``model`` in ``cfg.dtype``."""
    model = _cast(model, cfg.dtype)

    def prefill_step(batch):
        return M.prefill(model, batch, cfg, max_len=max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig, model: M.DecoderLM):
    """``decode_step(cache, tokens) -> (logits, cache)`` on ``model`` in
    ``cfg.dtype``; the cache is updated in place."""
    model = _cast(model, cfg.dtype)

    def decode_step(cache, tokens):
        return M.decode_step(model, cache, tokens, cfg)

    return decode_step

