# Data copied from repro/configs; the ModelConfig is the port's.
"""llama4-scout-17b-a16e — 16-expert top-1 MoE, iRoPE chunked attention
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L, d_model 5120, 40 heads (GQA kv=8), d_ff 8192, vocab 202048.
Attention pattern 3:1 — three chunked-local (RoPE, chunk 8192) layers per
one global NoPE layer. Chunked layers keep long_500k sub-quadratic; the
global layer reads the whole cache once per decode step (linear/step).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    pattern=(
        ("attn_chunked", "moe"),
        ("attn_chunked", "moe"),
        ("attn_chunked", "moe"),
        ("attn_nope", "moe"),
    ),
    attn_chunk=8192,
    n_experts=16,
    n_experts_active=1,
    capacity_factor=1.25,
    rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=512,
    head_dim=16,
    pattern=(
        ("attn_chunked", "moe"),
        ("attn_chunked", "moe"),
        ("attn_chunked", "moe"),
        ("attn_nope", "moe"),
    ),
    attn_chunk=16,
    n_experts=4,
    n_experts_active=1,
    vocab_pad_multiple=64,
)
