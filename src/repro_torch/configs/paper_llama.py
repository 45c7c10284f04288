# Data copied from repro/configs; the ModelConfig is the port's.
"""paper-llama — the paper's own evaluation vehicle (§V: llama2.c-style).

The paper verified the FLASH-D C++ datapath by integrating it into
llama2.c and checking bit-identical replies, then measured Table-I skip
rates on small HF LLMs. This config is the equivalently-sized model this
repo trains end-to-end (examples/train_lm.py) and measures skip rates on
(benchmarks/table1_skiprate.py). ~15M params trains on the CPU container;
PAPER_110M matches llama2.c's stories110M for the scaled run.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(  # llama2.c stories15M-shaped
    name="paper-llama-15m",
    n_layers=6,
    d_model=288,
    n_heads=6,
    n_kv_heads=6,
    d_ff=768,
    vocab_size=512,  # byte-ish toy vocab for the synthetic pipeline
    head_dim=48,
    pattern=(("attn", "swiglu"),),
    vocab_pad_multiple=64,
    dtype="float32",
    remat="none",
)

PAPER_110M = ModelConfig(  # llama2.c stories110M-shaped (end-to-end driver)
    name="paper-llama-110m",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=2048,
    vocab_size=32000,
    head_dim=64,
    pattern=(("attn", "swiglu"),),
    dtype="float32",
    remat="none",
)

SMOKE = CONFIG
