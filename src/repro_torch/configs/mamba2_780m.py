"""mamba2-780m [arXiv:2405.21060] — attention-free SSM (SSD): 48 layers,
d_model 1536 (d_inner 3072, 48 ssm heads of dim 64), ssm_state 128,
vocab 50280, tied embeddings. O(1) decode state in the sequence length.
Counterpart of ``repro/configs/mamba2_780m.py``.
"""
import torch

from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=50280, tie_embeddings=True,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
        source="arXiv:2405.21060",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=128, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=512, tie_embeddings=True,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                      chunk=32),
        param_dtype=torch.float32, compute_dtype=torch.float32,
        source="arXiv:2405.21060",
    )
