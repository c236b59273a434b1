"""whisper-base [arXiv:2212.04356] — encoder-decoder ASR transformer.

6 encoder + 6 decoder layers, d_model 512, 8 heads (MHA: kv = 8), d_ff
2048, vocab 51865. GELU MLP, LayerNorm, absolute sinusoidal positions
(rope_theta=None). The mel-spectrogram and conv frontend are a stub: the
caller gives 1500 precomputed frame embeddings. Counterpart of
``repro/configs/whisper_base.py``.
"""
import torch

from repro_torch.models.config import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
        vocab=51865, norm="layernorm", mlp="gelu", rope_theta=None,
        encoder=EncoderConfig(n_layers=6, n_frames=1500),
        source="arXiv:2212.04356",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-base-smoke", family="audio",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512, norm="layernorm", mlp="gelu", rope_theta=None,
        encoder=EncoderConfig(n_layers=2, n_frames=48),
        param_dtype=torch.float32, compute_dtype=torch.float32,
        source="arXiv:2212.04356",
    )
