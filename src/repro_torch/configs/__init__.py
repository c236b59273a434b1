"""Model configurations: the paper's GCN (``gcn_paper``) and the
transformer registry (``--arch <id>``, counterpart of
``repro/configs/__init__.py``).

Each transformer module exposes ``config()`` (the published numbers, cited
in its docstring) and ``smoke()`` (a reduced same-family variant for the
CPU tests). The port has the dense models it serves so far; every other id
of the reference's registry raises, naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import importlib

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

_PORTED = ("tinyllama-1.1b", "qwen2-0.5b")

_TODO = {
    "llama4-scout-17b-a16e": "item 10c (MoE)",
    "mixtral-8x7b": "item 10c (MoE)",
    "zamba2-2.7b": "item 10e (SSM and hybrid)",
    "mamba2-780m": "item 10e (SSM and hybrid)",
    "llama-3.2-vision-90b": "item 10f (VLM and audio)",
    "whisper-base": "item 10f (VLM and audio)",
    "command-r-plus-104b": "item 10i (the other dense configs)",
    "internlm2-1.8b": "item 10i (the other dense configs)",
}


def _module(arch: str):
    if arch in _TODO:
        raise NotImplementedError(
            f"{arch} is not ported yet: ROADMAP queue 1, {_TODO[arch]}")
    if arch not in _PORTED:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()
