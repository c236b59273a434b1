"""Model configurations: the paper's GCN (``gcn_paper``) and the
transformer registry (``--arch <id>``, counterpart of
``repro/configs/__init__.py``).

Each transformer module exposes ``config()`` (the published numbers, cited
in its docstring) and ``smoke()`` (a reduced same-family variant for the
CPU tests). The port has every model of the reference's registry: the
dense, MoE, SSM, hybrid, VLM and audio families.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "whisper-base",
    "qwen2-0.5b",
    "llama4-scout-17b-a16e",
    "llama-3.2-vision-90b",
    "mixtral-8x7b",
    "command-r-plus-104b",
    "zamba2-2.7b",
    "tinyllama-1.1b",
    "internlm2-1.8b",
    "mamba2-780m",
)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k only for a sub-quadratic decode state
    (``ModelConfig.supports_long_decode``), as in the reference."""
    if shape.name == "long_500k":
        return cfg.supports_long_decode
    return True
