# Data copied from repro/configs; the ModelConfig is the port's.
"""phi-3-vision-4.2b — VLM: phi3-mini backbone + CLIP stub
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L, d_model 3072, 32 heads (kv=32), d_ff 8192, vocab 32064. The modality
frontend is a STUB: input_specs provide precomputed
patch embeddings [B, 256, d_model] that a learned projection prepends to
the token stream.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    pattern=(("attn", "swiglu"),),
    frontend="vision",
    frontend_tokens=256,
)

SMOKE = ModelConfig(
    name="phi-3-vision-4.2b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    pattern=(("attn", "swiglu"),),
    frontend="vision",
    frontend_tokens=8,
    vocab_pad_multiple=64,
)
