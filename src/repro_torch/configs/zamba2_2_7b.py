"""zamba2-2.7b [arXiv:2411.15242] — hybrid: 54 Mamba2 backbone layers with
one weight-SHARED transformer block applied every 6 layers. d_model 2560,
shared block: 32 heads (MHA, kv=32, head_dim 80), d_ff 10240. Mamba2:
ssm_state 64, expand 2, head_dim 64 (d_inner 5120, 80 ssm heads).
vocab 32000. Counterpart of ``repro/configs/zamba2_2_7b.py``.
"""
import torch

from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=10240, vocab=32000, rope_theta=1e4, shared_attn_every=6,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
        source="arXiv:2411.15242",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=512, rope_theta=1e4, shared_attn_every=2,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                      chunk=32),
        param_dtype=torch.float32, compute_dtype=torch.float32,
        source="arXiv:2411.15242",
    )
