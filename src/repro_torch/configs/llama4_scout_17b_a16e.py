"""llama4-scout-17b-16e [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE
decoder: 16 routed experts, top-1 routing, plus a shared expert (early
fusion). 48 layers, d_model 5120, 40 heads / 8 kv (head_dim 128),
expert d_ff 8192, vocab 202048. Counterpart of
``repro/configs/llama4_scout_17b_a16e.py``.
"""
import torch

from repro_torch.models.config import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=202048, rope_theta=5e5,
        moe=MoEConfig(num_experts=16, top_k=1, shared_expert=True),
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, rope_theta=5e5,
        moe=MoEConfig(num_experts=4, top_k=1, shared_expert=True),
        param_dtype=torch.float32, compute_dtype=torch.float32,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
