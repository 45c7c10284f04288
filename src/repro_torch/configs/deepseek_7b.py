# Data copied from repro/configs; the ModelConfig is the port's.
"""deepseek-7b — dense llama-arch decoder [arXiv:2401.02954; hf].

30L, d_model 4096, 32 heads (GQA kv=32 ⇒ MHA), d_ff 11008, vocab 102400.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    head_dim=128,
    pattern=(("attn", "swiglu"),),
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="deepseek-7b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    pattern=(("attn", "swiglu"),),
    vocab_pad_multiple=64,
)
