"""Model configuration of the transformer families (counterpart of
``repro/models/config.py``, with torch dtypes in place of jnp dtypes).

One frozen dataclass describes a model; every config in
``repro_torch/configs/`` instantiates it with the published numbers. The
port runs all six families (``models/transformer.py``, ``models/moe.py``,
``models/ssm.py``): dense, MoE, SSM, hybrid, VLM (``cross_attn_every``,
``n_image_tokens``) and audio (``encoder``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # llama4-style: a shared (always-on) expert alongside the routed ones
    shared_expert: bool = False


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128      # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Audio/vision encoder backbone (whisper): precomputed frame
    embeddings of shape (batch, n_frames, d_model)."""
    n_layers: int
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None       # default d_model // n_heads
    qkv_bias: bool = False               # qwen2
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    mlp: str = "swiglu"                  # swiglu | gelu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    sliding_window: Optional[int] = None  # mixtral SWA
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None

    # vlm: a cross-attention layer every k self-attention layers
    cross_attn_every: Optional[int] = None
    n_image_tokens: int = 0

    # hybrid (zamba2): one weight-shared attention block applied every k
    # mamba layers
    shared_attn_every: Optional[int] = None

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

    # citation: arXiv id or model card
    source: str = ""

    # ----- derived -----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 128 (logits over padded ids are
        masked)."""
        return _round_up(self.vocab, 128)

    @property
    def supports_long_decode(self) -> bool:
        """True if the decode state is O(1) or bounded (SSM/hybrid state,
        or a sliding-window KV): these run the long_500k shape. Pure
        full-attention archs skip it, as in the reference."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def kv_cache_len(self, seq_len: int) -> int:
        """Decode KV footprint: ring buffer of `sliding_window` if SWA."""
        if self.sliding_window is not None:
            return min(self.sliding_window, seq_len)
        return seq_len

    def num_params(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, v = self.d_model, self.vocab_padded
        total = v * d                       # embedding
        if not self.tie_embeddings:
            total += d * v                  # lm head
        total += self._layer_params() * self.n_layers
        if self.encoder is not None:
            total += self._attn_params() + 2 * self._mlp_params(False)
            enc_layer = self._attn_params() + self._mlp_params(False) + 4 * d
            total += enc_layer * self.encoder.n_layers
        if self.shared_attn_every:
            total += (self._attn_params() + self._mlp_params(False)
                      + 2 * self.d_model)
        if self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (self._attn_params() + 2 * d)
        return total

    def num_active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.num_params()
        full_ffn = self._mlp_params(True)
        active_ffn = full_ffn * self.moe.top_k / self.moe.num_experts
        if self.moe.shared_expert:
            active_ffn += self._mlp_params(False)
        inactive = (full_ffn - active_ffn) * self.n_layers
        return int(self.num_params() - inactive)

    def _attn_params(self) -> int:
        d, hq = self.d_model, self.n_heads * self.hd
        hkv = self.n_kv_heads * self.hd
        p = d * hq + 2 * d * hkv + hq * d
        if self.qkv_bias:
            p += hq + 2 * hkv
        return p

    def _mlp_params(self, moe_total: bool) -> int:
        d, f = self.d_model, self.d_ff
        per = (3 if self.mlp == "swiglu" else 2) * d * f
        if self.moe is not None and moe_total:
            per = per * self.moe.num_experts + d * self.moe.num_experts
            if self.moe.shared_expert:
                per += (3 if self.mlp == "swiglu" else 2) * d * f
        return per

    def _ssm_params(self) -> int:
        assert self.ssm is not None
        s = self.ssm
        d = self.d_model
        din = s.d_inner(d)
        nh = s.n_heads(d)
        gn = s.n_groups * s.d_state
        conv_ch = din + 2 * gn
        return (d * (2 * din + 2 * gn + nh)      # in_proj (z,x,B,C,dt)
                + conv_ch * s.d_conv             # depthwise conv
                + nh * 2                         # A_log, D
                + nh                             # dt bias
                + din * d)                       # out_proj

    def _layer_params(self) -> int:
        norms = 2 * self.d_model
        if self.family in ("ssm", "hybrid"):
            return self._ssm_params() + norms
        return self._attn_params() + self._mlp_params(True) + norms
