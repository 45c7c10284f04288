# Data copied from repro/configs; the ModelConfig is the port's.
"""mamba2-2.7b — attention-free SSD (state-space duality) [arXiv:2405.21060].

64L, d_model 2560, ssm_state 128, vocab 50280. FLASH-D is inapplicable
(no softmax attention): the arch runs without it (DESIGN.md
§Arch-applicability). Runs long_500k (sub-quadratic).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    n_layers=64,
    d_model=2560,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    pattern=(("ssm", "none"),),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=512,
    pattern=(("ssm", "none"),),
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=8,
    vocab_pad_multiple=64,
)
