"""Model configuration — the port of `repro/models/config.py`, with torch
dtypes in place of `jnp.dtype`. Field names and defaults are the reference's,
so `bridge.config_from_reference` copies a reference config field by field.

A model is a repeating *pattern* of (mixer, ffn) layer specs over
`n_layers` (pattern remainder handled as an epilogue stack), with
parameters stacked per pattern position. Mixers:

  attn          causal softmax attention (FLASH-D kernel)
  attn_bidir    bidirectional (encoder / cross)
  attn_local    causal sliding window (recurrentgemma)
  attn_chunked  causal within chunks (llama4 iRoPE local layers)
  attn_nope     causal, NO rotary (llama4 global layers)
  ssm           Mamba-2 SSD block (attention-free)
  rglru         Griffin RG-LRU recurrent block

FFNs: swiglu | moe | none. The port runs `attn` / `attn_nope` + `swiglu`
stacks; the others raise "not ported" in `models/transformer.py` (A12).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

LayerSpec = Tuple[str, str]  # (mixer, ffn)


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...] = (("attn", "swiglu"),)
    head_dim: int = 0  # 0 → d_model // n_heads
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_window: int = 0  # attn_local sliding window
    attn_chunk: int = 0  # attn_chunked chunk length
    rope_theta: float = 10000.0
    attn_impl: str = "flashd"  # one of core.attention.IMPLS
    attn_block_q: Optional[int] = None  # None → repro_torch.kernels.tuning picks
    attn_block_k: Optional[int] = None
    attn_skip: bool = False  # FLASH-D tile-skip predication
    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss_weight: float = 1e-2
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_width: int = 4
    # RG-LRU (recurrentgemma)
    lru_width: int = 0  # 0 → d_model
    # enc-dec
    n_encoder_layers: int = 0  # >0 → encoder-decoder model
    # modality frontend (stub: precomputed embeddings enter input_specs)
    frontend: str = "none"  # none | vision | audio
    frontend_tokens: int = 0  # patches / frames prepended (vision) or encoder input length factor (audio)
    # numerics / embedding
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"  # master weights
    vocab_pad_multiple: int = 256
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # remat: none | dots | full — per-block activation checkpointing under
    # autograd (models/transformer.py::_remat)
    remat: str = "full"
    # the reference's scan-vs-unrolled switch; the port always loops in
    # Python over the stacked layer axis
    scan_layers: bool = True

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def remainder(self) -> Tuple[LayerSpec, ...]:
        r = self.n_layers % len(self.pattern)
        return self.pattern[:r]

    @property
    def compute_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)

    @property
    def master_dtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def lru_width_(self) -> int:
        return self.lru_width or self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def uses_attention(self) -> bool:
        return any(m.startswith("attn") for m, _ in self.pattern)

    @property
    def subquadratic(self) -> bool:
        """True if no layer does full-context softmax attention over long
        sequences (SSM / local / chunked only) — gates the long_500k shape."""
        return all(
            m in ("ssm", "rglru", "attn_local", "attn_chunked") or not m.startswith("attn")
            for m, _ in self.pattern
        )

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once)."""
        d, hd = self.d_model, self.head_dim_
        total = self.padded_vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.padded_vocab * d  # lm head
        total += d  # final norm

        def attn_params():
            p = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
            if self.qkv_bias:
                p += (self.n_heads + 2 * self.n_kv_heads) * hd
            if self.qk_norm:
                p += 2 * hd
            return p + d  # pre-norm

        def swiglu_params():
            return 3 * d * self.d_ff + d

        def moe_params():
            return self.n_experts * 3 * d * self.d_ff + d * self.n_experts + d

        def ssm_params():
            di, hs = self.d_inner, self.ssm_heads
            p = d * (2 * di + 2 * self.ssm_state + hs)  # in_proj (z,x,B,C,dt)
            p += self.conv_width * (di + 2 * self.ssm_state)  # conv
            p += hs + hs  # A_log, D
            p += di * d  # out_proj
            return p + d

        def rglru_params():
            w = self.lru_width_
            p = 2 * d * w  # input + gate branch
            p += self.conv_width * w  # temporal conv
            p += 2 * w * w // 1  # RG-LRU gates (input gate + recurrence gate, diagonalish per-channel: use w params each)
            p += w * d  # out proj
            return p + d

        mixer_cost = {
            "attn": attn_params, "attn_bidir": attn_params, "attn_local": attn_params,
            "attn_chunked": attn_params, "attn_nope": attn_params,
            "ssm": ssm_params, "rglru": rglru_params, "none": lambda: 0,
        }
        ffn_cost = {"swiglu": swiglu_params, "moe": moe_params, "none": lambda: 0}

        layers = [self.pattern[i % len(self.pattern)] for i in range(self.n_layers)]
        for mixer, ffn in layers:
            total += mixer_cost[mixer]() + ffn_cost[ffn]()
        if self.is_encdec:
            # encoder layers (bidir attn + swiglu) + decoder cross-attn adds
            total += self.n_encoder_layers * (attn_params() + swiglu_params())
            total += self.n_layers * attn_params()  # cross-attention per decoder layer
        if self.frontend == "vision":
            total += self.d_model * self.d_model  # patch projection stub
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(1 for _, f in (
            self.pattern[i % len(self.pattern)] for i in range(self.n_layers)
        ) if f == "moe")
        inactive = moe_layers * (self.n_experts - self.n_experts_active) * 3 * self.d_model * self.d_ff
        return full - inactive
