# Data copied from repro/configs; the ModelConfig is the port's.
"""qwen3-0.6b — dense GQA with qk_norm [hf:Qwen/Qwen3-8B family; hf].

28L, d_model 1024, 16 heads (GQA kv=8), d_ff 3072, vocab 151936.
head_dim 128 is decoupled from d_model/n_heads (Qwen3 convention).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    pattern=(("attn", "swiglu"),),
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen3-0.6b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=32,
    qk_norm=True,
    pattern=(("attn", "swiglu"),),
    vocab_pad_multiple=64,
)
