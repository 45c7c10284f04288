# Data copied from repro/configs; the ModelConfig is the port's.
"""yi-34b — dense llama-arch GQA [arXiv:2403.04652; hf].

60L, d_model 7168, 56 heads (GQA kv=8), d_ff 20480, vocab 64000.
The largest dense assigned arch — the FSDP+TP+SP memory stress test.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    pattern=(("attn", "swiglu"),),
    rope_theta=5000000.0,
)

SMOKE = ModelConfig(
    name="yi-34b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    head_dim=16,
    pattern=(("attn", "swiglu"),),
    vocab_pad_multiple=64,
)
