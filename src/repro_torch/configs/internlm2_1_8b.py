"""internlm2-1.8b [arXiv:2403.17297] — dense decoder, GQA: 24 layers,
d_model 2048, 16 heads / 8 kv (head_dim 128), d_ff 8192, vocab 92544,
rope_theta 1e6. Counterpart of ``repro/configs/internlm2_1_8b.py``.
"""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", family="dense",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=92544, rope_theta=1e6,
        source="arXiv:2403.17297",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internlm2-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, rope_theta=1e6,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        source="arXiv:2403.17297",
    )
