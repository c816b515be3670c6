"""Model configuration: the one dataclass every language model of the JAX
package fits in.

Each ``configs/<arch>.py`` instantiates :class:`ModelConfig` with the
published numbers and registers it, with a reduced ``smoke`` variant for CPU
tests.  The fields are the JAX package's (``repro/configs/base.py``), so a
config file copies over with only its import changed; the fields that shape
only JAX's compilation and sharding (``remat``, ``remat_policy``,
``seq_parallel``, ``attn_remat``, ``scan_layers``, the chunk sizes) are kept
and read by nothing here.  The dry run's ``ShapeCfg``, ``SHAPES``,
``input_specs`` and ``cell_supported`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = ["ModelConfig", "register", "get_config", "list_configs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    # --- attention pattern ---
    window: int = 0                  # sliding window size; 0 = full attention
    window_pattern: tuple = ()       # per-layer: 1 = local (use window), 0 = global; cycled
    attn_logit_softcap: float = 0.0  # gemma2-style tanh softcap (0 = off)
    final_logit_softcap: float = 0.0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    dense_residual: bool = False     # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    slstm_every: int = 0             # xLSTM: every k-th block is sLSTM
    mamba_conv: int = 4
    mamba_expand: int = 2
    # --- enc-dec / vlm frontends ---
    encoder_layers: int = 0
    encoder_seq_divisor: int = 4     # stub frame rate: enc_len = seq // divisor
    cross_attn_every: int = 0        # every k-th decoder layer adds cross-attn
    img_tokens: int = 0
    # --- numerics / memory ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu (GLU) | gelu (plain MLP)
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"
    seq_parallel: bool = True
    attn_remat: bool = True
    scan_layers: bool = True
    loss_chunk: int = 1024
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    kv_cache_dtype: str = "bfloat16" # bfloat16 | int8 | float32
    # --- provenance ---
    source: str = ""
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def layer_windows(self) -> tuple:
        """Per-layer window size: 0 = full attention, >0 = sliding window."""
        if not self.window_pattern:
            return (self.window,) * self.num_layers
        pat = self.window_pattern
        return tuple(
            self.window if pat[i % len(pat)] else 0 for i in range(self.num_layers)
        )


_REGISTRY: dict = {}
# The config modules ported so far (the JAX package registers ten models and
# the paper's BSI config).
_ARCH_MODULES = ["gemma2_2b"]


def register(cfg: ModelConfig, smoke: ModelConfig | None = None):
    _REGISTRY[cfg.name] = (cfg, smoke)
    return cfg


def _load_all():
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg, smoke_cfg = _REGISTRY[name]
    if smoke:
        if smoke_cfg is None:
            raise KeyError(f"{name} has no smoke variant")
        return smoke_cfg
    return cfg


def list_configs() -> list:
    _load_all()
    return sorted(_REGISTRY)
