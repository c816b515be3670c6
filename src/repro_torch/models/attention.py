"""Attention: GQA projections, flash attention for prefill, KV caches, decode.

The port of the JAX package's ``repro/models/attention.py``.  Prefill runs
:func:`attend_blockwise`, which is the hand-written flash-attention kernel on
the card (``kernels.ops.flash_attention``) and its plain version on the CPU;
:func:`attend_full` is the plain unchunked oracle.  Decode reads a bf16,
float32 or int8-quantised KV cache (per-(token, head) scales) and attends in
plain tensor ops, as the JAX package does.  The caches are updated in place,
where the JAX package returns new arrays.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import rope
from repro_torch.models.layers import softcap as _softcap
from repro_torch.models.schema import P, lead

__all__ = [
    "attn_schema", "proj_heads", "project_qkv", "attend_blockwise", "attend_full",
    "cache_schema_shapes", "init_cache", "update_cache", "read_cache",
    "decode_attend", "out_proj",
]

NEG_INF = -2.0e30


def attn_schema(d, n_heads, n_kv, hd, qkv_bias=False, layers=None):
    """Head dims stored flattened, ``(d, H*hd)``, as in the JAX package."""
    pre, ax = lead(layers)
    s = {
        "wq": P(pre + (d, n_heads * hd), ax + ("embed", "heads")),
        "wk": P(pre + (d, n_kv * hd), ax + ("embed", "kv_heads")),
        "wv": P(pre + (d, n_kv * hd), ax + ("embed", "kv_heads")),
        "wo": P(pre + (n_heads * hd, d), ax + ("heads", "embed")),
    }
    if qkv_bias:
        s["bq"] = P(pre + (n_heads * hd,), ax + ("heads",), init="zeros")
        s["bk"] = P(pre + (n_kv * hd,), ax + ("kv_heads",), init="zeros")
        s["bv"] = P(pre + (n_kv * hd,), ax + ("kv_heads",), init="zeros")
    return s


def proj_heads(w, x, n_heads, bias=None):
    """x (B,S,D) @ w (D, H*hd) -> (B, S, H, hd)."""
    y = x @ w
    if bias is not None:
        y = y + bias
    B, S, E = y.shape
    return y.reshape(B, S, n_heads, E // n_heads)


def project_qkv(p, x, positions, rope_theta=10_000.0, use_rope=True, *, n_heads,
                n_kv):
    """x: (B, S, D) -> q (B, S, H, hd), k/v (B, S, KV, hd); ``p`` holds
    ``wq``, ``wk``, ``wv`` and optionally ``bq``, ``bk``, ``bv``.  The JAX
    package's head-count inference (``set_head_hint``) is not ported: pass
    the counts."""
    q = proj_heads(p.wq, x, n_heads, getattr(p, "bq", None))
    k = proj_heads(p.wk, x, n_kv, getattr(p, "bk", None))
    v = proj_heads(p.wv, x, n_kv, getattr(p, "bv", None))
    if use_rope:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q, k, v


def out_proj(p, o):
    B, S, H, hd = o.shape
    return o.reshape(B, S, H * hd) @ p.wo


def _repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    B, S, KV, hd = k.shape
    return k[:, :, :, None].expand(B, S, KV, n_rep, hd).reshape(B, S, KV * n_rep, hd)


def _mask_bias(q_pos, k_pos, causal, window, dtype=torch.float32):
    """(Q, K) additive mask. window > 0 keeps k_pos > q_pos - window."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF).to(dtype)


def _sqrt_hd(hd, device):
    """``sqrt(hd)`` in float32, as the JAX package's ``jnp.sqrt(hd)``."""
    return torch.tensor(math.sqrt(hd), dtype=torch.float32, device=device)


def attend_full(q, k, v, *, q_positions, k_positions, causal=True, window=0,
                softcap=0.0):
    """Unchunked attention (short sequences, the tests' oracle)."""
    hd = q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    s = torch.einsum("bqhd,bmhd->bhqm", q, k).float() / _sqrt_hd(hd, q.device)
    s = _softcap(s, softcap)
    s = s + _mask_bias(q_positions, k_positions, causal, window)[None, None]
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqm,bmhk->bqhk", w.to(v.dtype), v)


def attend_blockwise(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Flash attention: the hand-written kernel on the card, its plain
    version on the CPU (``kernels.ops.flash_attention``).

    q: ``(B, S, H, hd)``; k, v: ``(B, S, KV, hd)``.  The query and key
    positions are ``arange(S)``: every caller of the JAX package's
    ``attend_blockwise`` passes that for both, so the port takes none.  The
    scores stay in float32 from q and k upcast, as in the JAX package's
    Pallas kernel; its ``attend_blockwise`` rounds a bf16 score product to
    bf16 first, so the two agree exactly in float32 and to bf16 rounding in
    bf16.  Returns ``(B, S, H, hd)`` in q's dtype.
    """
    return ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)


# ---------------------------------------------------------------- KV caches

def cache_schema_shapes(cfg, batch, max_len):
    """Shapes/dtypes of one layer-stack's KV cache (leading layers axis)."""
    hd = cfg.resolved_head_dim
    L, KV = cfg.num_layers, cfg.num_kv_heads
    base = dict(
        k=((L, batch, max_len, KV, hd), cfg.kv_cache_dtype),
        v=((L, batch, max_len, KV, hd), cfg.kv_cache_dtype),
    )
    if cfg.kv_cache_dtype == "int8":
        base["k_scale"] = ((L, batch, max_len, KV), "float32")
        base["v_scale"] = ((L, batch, max_len, KV), "float32")
    return base


def init_cache(cfg, batch, max_len, device="cuda"):
    """A zero cache of :func:`cache_schema_shapes`, write position 0; on the
    card unless the caller passes ``device="cpu"``."""
    device = resolve_device(device, "the model")
    out = {
        name: torch.zeros(shape, dtype=getattr(torch, dt), device=device)
        for name, (shape, dt) in cache_schema_shapes(cfg, batch, max_len).items()
    }
    out["pos"] = 0
    return out


def _quant_int8(x):
    xf = x.float()
    scale = torch.clamp_min(torch.amax(torch.abs(xf), dim=-1) / 127.0, 1e-8)
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale


def update_cache(cache_layer, k_new, v_new, pos, quantized):
    """Write (B, S_new, KV, hd) keys/values at offset ``pos``, in place;
    returns ``cache_layer``."""
    end = pos + k_new.shape[1]
    if quantized:
        kq, ks = _quant_int8(k_new)
        vq, vs = _quant_int8(v_new)
        cache_layer["k"][:, pos:end] = kq
        cache_layer["v"][:, pos:end] = vq
        cache_layer["k_scale"][:, pos:end] = ks
        cache_layer["v_scale"][:, pos:end] = vs
    else:
        cache_layer["k"][:, pos:end] = k_new.to(cache_layer["k"].dtype)
        cache_layer["v"][:, pos:end] = v_new.to(cache_layer["v"].dtype)
    return cache_layer


def read_cache(cache_layer, compute_dtype):
    if "k_scale" in cache_layer:
        k = cache_layer["k"].float() * cache_layer["k_scale"][..., None]
        v = cache_layer["v"].float() * cache_layer["v_scale"][..., None]
        return k.to(compute_dtype), v.to(compute_dtype)
    return cache_layer["k"].to(compute_dtype), cache_layer["v"].to(compute_dtype)


def decode_attend(q, k_cache, v_cache, *, q_pos, cache_len, window=0, softcap=0.0):
    """Single-step decode attention over the full cache with a length mask.

    q: (B, 1, H, hd); k/v_cache: (B, S_max, KV, hd) already dequantised.
    The scores come from a product in the compute dtype, the probabilities
    are cast to v's dtype, as in the JAX package.
    """
    B, _, H, hd = q.shape
    S = k_cache.shape[1]
    n_rep = H // k_cache.shape[2]
    kk = _repeat_kv(k_cache, n_rep)
    vv = _repeat_kv(v_cache, n_rep)
    s = torch.einsum("bqhk,bmhk->bhqm", q, kk).float() / _sqrt_hd(hd, q.device)
    s = _softcap(s, softcap)
    kpos = torch.arange(S, device=q.device)
    ok = (kpos <= q_pos) & (kpos < cache_len)
    if window > 0:
        ok &= kpos > q_pos - window
    s = torch.where(ok, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqm,bmhk->bqhk", w.to(vv.dtype), vv)
