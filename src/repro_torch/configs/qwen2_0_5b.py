"""qwen2-0.5b [arXiv:2407.10671] — dense decoder, GQA (kv=2), QKV bias.

24 layers, d_model 896, 14 heads / 2 kv heads (head_dim 64), d_ff 4864,
vocab 151936, tied embeddings, rope_theta 1e6. Counterpart of
``repro/configs/qwen2_0_5b.py``.
"""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab=151936, qkv_bias=True, tie_embeddings=True,
        rope_theta=1e6, source="arXiv:2407.10671",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, qkv_bias=True, tie_embeddings=True,
        rope_theta=1e6, param_dtype=torch.float32,
        compute_dtype=torch.float32, source="arXiv:2407.10671",
    )
