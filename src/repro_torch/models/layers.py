"""Shared neural layers: norms, RoPE, MLPs, embeddings.

Each function follows the JAX package's ``repro/models/layers.py`` step for
step in its dtypes: the norms and RoPE compute in float32 and cast back to
the input's dtype; the MLPs' products run in the parameters' dtype.  A
parameter group is any object with the JAX tree's leaf names as attributes
(``p.scale``, ``p.wi_gate``): a module of :class:`repro_torch.models.model.
ParamDict`.  ``chunked_xent`` waits for training (ROADMAP queue 1 item 17).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.schema import P, lead

__all__ = [
    "rmsnorm", "layernorm", "norm_schema", "apply_norm",
    "rope", "glu_mlp", "gelu_mlp", "mlp_schema", "apply_mlp", "embed_schema",
    "softcap",
]


def norm_schema(d, kind="rmsnorm", layers=None):
    pre, ax = lead(layers)
    s = {"scale": P(pre + (d,), ax + ("embed",), init="ones")}
    if kind == "layernorm":
        s["bias"] = P(pre + (d,), ax + ("embed",), init="zeros")
    return s


def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-6):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    return (y + bias.float()).to(x.dtype)


def apply_norm(p, x, kind="rmsnorm", eps=1e-6):
    if kind == "layernorm":
        return layernorm(x, p.scale, p.bias, eps)
    return rmsnorm(x, p.scale, eps)


def rope(x, positions, theta=10_000.0):
    """Rotary embedding. x: (..., S, H, hd); positions: (..., S) integers."""
    hd = x.shape[-1]
    half = hd // 2
    # float32 throughout, as jnp evaluates log(theta) on a weak float32
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32, device=x.device))
    freqs = torch.exp(
        -log_theta * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def mlp_schema(d, f, act="silu", layers=None):
    pre, ax = lead(layers)
    if act == "silu":  # GLU: gate + up + down
        return {
            "wi_gate": P(pre + (d, f), ax + ("embed", "ff")),
            "wi_up": P(pre + (d, f), ax + ("embed", "ff")),
            "wo": P(pre + (f, d), ax + ("ff", "embed")),
        }
    return {  # plain MLP (whisper-style)
        "wi": P(pre + (d, f), ax + ("embed", "ff")),
        "bi": P(pre + (f,), ax + ("ff",), init="zeros"),
        "wo": P(pre + (f, d), ax + ("ff", "embed")),
        "bo": P(pre + (d,), ax + ("embed",), init="zeros"),
    }


def glu_mlp(p, x):
    g = F.silu(x @ p.wi_gate)
    u = x @ p.wi_up
    return (g * u) @ p.wo


def gelu_mlp(p, x):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p.wi + p.bi, approximate="tanh")
    return h @ p.wo + p.bo


def apply_mlp(p, x, act="silu"):
    return glu_mlp(p, x) if act == "silu" else gelu_mlp(p, x)


def embed_schema(vocab, d):
    return {"table": P((vocab, d), ("vocab", "embed"), scale=1.0)}


def softcap(x, cap):
    """``tanh(x / cap) * cap``; ``cap = 0`` leaves ``x`` as it is."""
    return torch.tanh(x / cap) * cap if cap else x

