"""tinyllama-1.1b [arXiv:2401.02385] — llama2-architecture dense decoder:
22 layers, d_model 2048, 32 heads / 4 kv (head_dim 64), d_ff 5632,
vocab 32000, rope_theta 1e4. Counterpart of
``repro/configs/tinyllama_1_1b.py``.
"""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
        d_ff=5632, vocab=32000, rope_theta=1e4,
        source="arXiv:2401.02385",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, rope_theta=1e4,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        source="arXiv:2401.02385",
    )
