"""The dense decoder language model: schema, parameters, prefill and decode.

The port of the dense family of the JAX package's ``repro/models/model.py``.
Parameters live in a :class:`DecoderLM`, an ``nn.Module`` whose parameter
names follow the JAX tree's leaf paths with the layer stack split into a
``ModuleList`` (``blocks.3.attn.wq`` is the JAX tree's
``params["blocks"]["attn"]["wq"][3]``); the forward functions are plain
functions over it, as in the JAX package.  Prefill attention is
``attention.attend_blockwise`` (the flash-attention kernel on the card);
decode attention is plain.

Not ported: the other families (``moe``, ``hybrid``, ``ssm``, ``encdec``,
``vlm``), which raise ``NotImplementedError``; the loss, which waits for
training; and the sharding rules (``constrain``), ``remat`` and the layer
scan, which shape only JAX's compilation and sharding, not the function.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_schema, mlp_schema,
                                       norm_schema, softcap)
from repro_torch.models.schema import P, init_params

__all__ = [
    "DecoderLM", "ParamDict", "model_schema", "init_model", "forward_train",
    "prefill", "decode_step", "init_decode_cache", "map_tree",
]


def _check_family(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} model family is not ported yet (ROADMAP.md queue 1 "
            "item 17b): only the dense decoder is")


# ----------------------------------------------------------------- schemas

def _decoder_blocks_schema(cfg: ModelConfig, L: int):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "ln1": norm_schema(d, cfg.norm, layers=L),
        "attn": attn.attn_schema(d, cfg.num_heads, cfg.num_kv_heads, hd, cfg.qkv_bias,
                                 layers=L),
        "ln2": norm_schema(d, cfg.norm, layers=L),
        "mlp": mlp_schema(d, cfg.d_ff, cfg.act, layers=L),
    }


def model_schema(cfg: ModelConfig):
    _check_family(cfg)
    s = {
        "embed": embed_schema(cfg.vocab_size, cfg.d_model),
        "blocks": _decoder_blocks_schema(cfg, cfg.num_layers),
        "final_norm": norm_schema(cfg.d_model, cfg.norm),
    }
    if not _tied(cfg):
        s["lm_head"] = P((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), scale=0.02)
    return s


def _tied(cfg: ModelConfig) -> bool:
    return cfg.name.startswith(("gemma", "whisper"))


# -------------------------------------------------------------- parameters

def map_tree(fn, tree):
    """``tree`` (nested dicts and lists of tensors) with ``fn`` on each tensor."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


class ParamDict(nn.Module):
    """A group of parameters under the JAX tree's names: ``p.wq`` is its
    ``p["wq"]``; a nested dict becomes a child module.  Serving needs no
    gradients, so no parameter requires one."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamDict(value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def tree(self) -> dict:
        out = {name: p.data for name, p in self.named_parameters(recurse=False)}
        out.update((name, m.tree()) for name, m in self.named_children())
        return out


class DecoderLM(nn.Module):
    """The dense decoder's parameters: ``embed.table``, ``blocks.{i}.{ln1,
    attn, ln2, mlp}.*``, ``final_norm.scale`` and, untied, ``lm_head``.

    ``tree`` is the JAX tree's layout with the blocks as a list of per-layer
    dicts; :meth:`from_stacked` takes the JAX layout itself, whose block
    leaves stack the layers on a leading axis (the parameters are then views
    of the stacked tensors, not copies).
    """

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = ParamDict(tree["embed"])
        self.blocks = nn.ModuleList(ParamDict(b) for b in tree["blocks"])
        self.final_norm = ParamDict(tree["final_norm"])
        if "lm_head" in tree:
            self.lm_head = nn.Parameter(tree["lm_head"], requires_grad=False)

    @classmethod
    def from_stacked(cls, cfg: ModelConfig, params: dict) -> "DecoderLM":
        stacked = params["blocks"]
        blocks = [map_tree(lambda t, i=i: t[i], stacked) for i in range(cfg.num_layers)]
        return cls(cfg, dict(params, blocks=blocks))

    def tree(self) -> dict:
        out = {"embed": self.embed.tree(), "blocks": [b.tree() for b in self.blocks],
               "final_norm": self.final_norm.tree()}
        if hasattr(self, "lm_head"):
            out["lm_head"] = self.lm_head.data
        return out


def init_model(cfg: ModelConfig, seed=0, device="cuda", dtype=torch.float32) -> DecoderLM:
    """Seeded parameters on ``device`` (the card unless ``device="cpu"``);
    see :func:`repro_torch.models.schema.init_params` for the seeding."""
    device = resolve_device(device, "the model")
    gen = torch.Generator().manual_seed(seed)
    return DecoderLM.from_stacked(cfg, init_params(model_schema(cfg), gen, dtype, device))


def _head_table(model: DecoderLM):
    return model.lm_head if hasattr(model, "lm_head") else model.embed.table


def _logits(x, model: DecoderLM, cfg: ModelConfig):
    """Float32 logits from the head table in the parameters' dtype, upcast."""
    logits = x.float() @ _head_table(model).float().T
    return softcap(logits, cfg.final_logit_softcap)


def _embed(model: DecoderLM, tokens, cfg: ModelConfig):
    return model.embed.table[tokens].to(getattr(torch, cfg.dtype))


# ------------------------------------------------------------ block bodies

def _attn_block(p, x, *, cfg, window, positions):
    """Pre-norm attention with residual; returns ``(x, (k, v))``."""
    h = apply_norm(p.ln1, x, cfg.norm)
    q, k, v = attn.project_qkv(p.attn, h, positions, cfg.rope_theta,
                               n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads)
    o = attn.attend_blockwise(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_logit_softcap)
    o = attn.out_proj(p.attn, o).to(x.dtype)
    return x + o, (k, v)


def _ffn_block(p, x, *, cfg):
    """Pre-norm MLP with residual (the JAX package's ``_mlp_tp`` adds only a
    sharding constraint to the MLP)."""
    h = apply_norm(p.ln2, x, cfg.norm)
    return x + apply_mlp(p.mlp, h, cfg.act).to(x.dtype)


def forward_train(model: DecoderLM, batch, cfg: ModelConfig):
    """Final hidden states and the aux loss (0 for the dense family)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = _embed(model, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for bp, window in zip(model.blocks, cfg.layer_windows()):
        x, _ = _attn_block(bp, x, cfg=cfg, window=window, positions=positions)
        x = _ffn_block(bp, x, cfg=cfg)
    return apply_norm(model.final_norm, x, cfg.norm), 0.0


# ------------------------------------------------------------- decode path

def init_decode_cache(cfg: ModelConfig, batch, max_len, device="cuda"):
    """A zero KV cache, ``(L, batch, max_len, KV, hd)`` keys and values in
    ``cfg.kv_cache_dtype`` (int8 with per-(token, head) scales), and its
    write position ``pos`` (a Python int)."""
    _check_family(cfg)
    return attn.init_cache(cfg, batch, max_len, device)


def _layer_cache(cache, i):
    """Layer ``i``'s view of the stacked cache (writes land in the cache)."""
    return {name: t[i] for name, t in cache.items() if name != "pos"}


def _decode_attn_layer(bp, cache_l, x, *, cfg, window, pos):
    """One decoder layer, single-token decode; updates ``cache_l`` in place."""
    h = apply_norm(bp.ln1, x, cfg.norm)
    positions = torch.full((1,), pos, device=x.device)
    q, k, v = attn.project_qkv(bp.attn, h, positions, cfg.rope_theta,
                               n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads)
    attn.update_cache(cache_l, k, v, pos, cfg.kv_cache_dtype == "int8")
    kc, vc = attn.read_cache(cache_l, x.dtype)
    o = attn.decode_attend(q, kc, vc, q_pos=pos, cache_len=pos + 1, window=window,
                           softcap=cfg.attn_logit_softcap)
    x = x + attn.out_proj(bp.attn, o)
    return _ffn_block(bp, x, cfg=cfg)


def decode_step(model: DecoderLM, cache, tokens, cfg: ModelConfig):
    """One serve step: ``(B, 1)`` new tokens against the cache.  Returns
    ``(logits (B, 1, V) float32, cache)``; the cache is updated in place."""
    _check_family(cfg)
    pos = cache["pos"]
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"the cache holds {cache['k'].shape[2]} positions, all written")
    x = _embed(model, tokens, cfg)
    for i, (bp, window) in enumerate(zip(model.blocks, cfg.layer_windows())):
        x = _decode_attn_layer(bp, _layer_cache(cache, i), x, cfg=cfg, window=window,
                               pos=pos)
    x = apply_norm(model.final_norm, x, cfg.norm)
    cache["pos"] = pos + 1
    return _logits(x, model, cfg), cache


# ----------------------------------------------------------------- prefill

def prefill(model: DecoderLM, batch, cfg: ModelConfig, max_len=None):
    """Process a full prompt; returns (last-position logits ``(B, V)``
    float32, the filled cache).

    One pass over the layers computes the hidden states and writes each
    layer's keys and values; the JAX package runs the decoder twice (the
    train forward, then a pass collecting the keys and values) and leaves the
    shared work to XLA.  The results are the same.
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = attn.init_cache(cfg, B, max_len or S, tokens.device)
    quant = cfg.kv_cache_dtype == "int8"
    x = _embed(model, tokens, cfg)
    positions = torch.arange(S, device=tokens.device)
    for i, (bp, window) in enumerate(zip(model.blocks, cfg.layer_windows())):
        x, (k, v) = _attn_block(bp, x, cfg=cfg, window=window, positions=positions)
        x = _ffn_block(bp, x, cfg=cfg)
        attn.update_cache(_layer_cache(cache, i), k, v, 0, quant)
    # the norm is per position: the last one's is all the logits need
    h = apply_norm(model.final_norm, x[:, -1], cfg.norm)
    cache["pos"] = S
    return _logits(h, model, cfg), cache
