"""gemma2-2b [dense] — [arXiv:2408.00118; hf]."""
from repro_torch.configs.base import ModelConfig, register

register(
    ModelConfig(
        name="gemma2-2b", family="dense",
        num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
        d_ff=9216, vocab_size=256000, head_dim=256,
        window=4096, window_pattern=(1, 0),   # alternating local/global
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        source="[arXiv:2408.00118; hf]",
        notes="local+global alternating; logit softcaps",
    ),
    smoke=ModelConfig(
        name="gemma2-2b", family="dense",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16,
        window=8, window_pattern=(1, 0),
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        remat=False, loss_chunk=64, attn_q_chunk=32, attn_kv_chunk=32,
    ),
)
