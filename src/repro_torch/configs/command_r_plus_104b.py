"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01 family] — dense
decoder: 64 layers, d_model 12288, 96 heads / 8 kv (head_dim 128),
d_ff 33792, vocab 256000. Bias-free LayerNorm, no QKV bias, tied
embeddings, rope_theta 75e4. Counterpart of
``repro/configs/command_r_plus_104b.py``.
"""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family="dense",
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
        d_ff=33792, vocab=256000, norm="layernorm_nobias",
        tie_embeddings=True, rope_theta=75e4,
        source="hf:CohereForAI/c4ai-command-r-v01",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=512, norm="layernorm_nobias", tie_embeddings=True,
        rope_theta=75e4, param_dtype=torch.float32,
        compute_dtype=torch.float32,
        source="hf:CohereForAI/c4ai-command-r-v01",
    )
