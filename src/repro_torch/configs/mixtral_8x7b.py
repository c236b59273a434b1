"""mixtral-8x7b [arXiv:2401.04088] — MoE decoder: 8 experts, top-2
routing, sliding-window attention (window 4096). 32 layers, d_model 4096,
32 heads / 8 kv (head_dim 128), expert d_ff 14336, vocab 32000.
Counterpart of ``repro/configs/mixtral_8x7b.py``.
"""
import torch

from repro_torch.models.config import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=32000, rope_theta=1e6, sliding_window=4096,
        moe=MoEConfig(num_experts=8, top_k=2),
        source="arXiv:2401.04088",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, rope_theta=1e6, sliding_window=16,
        moe=MoEConfig(num_experts=4, top_k=2),
        param_dtype=torch.float32, compute_dtype=torch.float32,
        source="arXiv:2401.04088",
    )
