# Data copied from repro/configs; the ModelConfig is the port's.
"""seamless-m4t-medium — encoder-decoder, multimodal [arXiv:2308.11596; hf].

12L encoder + 12L decoder, d_model 1024, 16 heads (kv=16), d_ff 4096,
vocab 256206 (padded to 256256 for clean 16-way vocab sharding). The audio
frontend is a STUB: input_specs provide precomputed frame embeddings.
Deviation: RoPE replaces the original relative-position scheme (DESIGN.md).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    n_layers=12,
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    pattern=(("attn", "swiglu"),),
    frontend="audio",
)

SMOKE = ModelConfig(
    name="seamless-m4t-smoke",
    n_layers=2,
    n_encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    pattern=(("attn", "swiglu"),),
    frontend="audio",
    vocab_pad_multiple=64,
)
