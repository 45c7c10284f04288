# Data copied from repro/configs; the ModelConfig is the port's.
"""qwen2-1.5b — dense GQA with QKV bias [arXiv:2407.10671; hf].

28L, d_model 1536, 12 heads (GQA kv=2), d_ff 8960, vocab 151936.
Note: 12 query heads do NOT divide the 16-way model axis — the sharding
rule engine falls back per-dim (DESIGN.md §4); this arch is the divisibility
stress test.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    pattern=(("attn", "swiglu"),),
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen2-1.5b-smoke",
    n_layers=2,
    d_model=48,
    n_heads=6,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    head_dim=16,
    qkv_bias=True,
    pattern=(("attn", "swiglu"),),
    vocab_pad_multiple=64,
)
