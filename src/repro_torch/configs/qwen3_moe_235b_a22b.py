# Data copied from repro/configs; the ModelConfig is the port's.
"""qwen3-moe-235b-a22b — 128-expert top-8 MoE [hf:Qwen/Qwen3 family; hf].

94L, d_model 4096, 64 heads (GQA kv=4), per-expert d_ff 1536, vocab 151936.
Experts shard over the 16-way model axis (8 experts/shard).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    pattern=(("attn", "moe"),),
    n_experts=128,
    n_experts_active=8,
    capacity_factor=1.25,
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab_size=512,
    head_dim=16,
    qk_norm=True,
    pattern=(("attn", "moe"),),
    n_experts=8,
    n_experts_active=2,
    vocab_pad_multiple=64,
)
