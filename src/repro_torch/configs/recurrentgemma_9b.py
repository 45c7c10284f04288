# Data copied from repro/configs; the ModelConfig is the port's.
"""recurrentgemma-9b — Griffin: RG-LRU + local attention 1:2
[arXiv:2402.19427; unverified].

38L (12 full (rglru, rglru, attn_local) blocks + 2 remainder rglru layers),
d_model 4096, 16 heads (MQA kv=1), d_ff 12288, vocab 256000, window 2048.
lru_width = d_model (assumption documented in DESIGN.md). Sub-quadratic by
construction — runs long_500k.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    pattern=(
        ("rglru", "swiglu"),
        ("rglru", "swiglu"),
        ("attn_local", "swiglu"),
    ),
    attn_window=2048,
    lru_width=4096,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    pattern=(
        ("rglru", "swiglu"),
        ("rglru", "swiglu"),
        ("attn_local", "swiglu"),
    ),
    attn_window=8,
    lru_width=64,
    vocab_pad_multiple=64,
)
