"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision, scaled per
assignment] — VLM decoder: 100 layers of which every 5th is a gated
cross-attention image layer (20 cross + 80 self). d_model 8192, 64 heads /
8 kv (head_dim 128), d_ff 28672, vocab 128256. The ViT vision encoder and
projector are a stub: the caller gives 1600 patch embeddings. Counterpart
of ``repro/configs/llama_3_2_vision_90b.py``.
"""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=28672, vocab=128256, rope_theta=5e5,
        cross_attn_every=5, n_image_tokens=1600,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-smoke", family="vlm",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, rope_theta=5e5,
        cross_attn_every=2, n_image_tokens=32,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )
