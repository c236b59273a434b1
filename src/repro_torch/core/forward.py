"""Training options of the layer program, and its dropout generators.

Counterpart of ``repro/core/forward.py``'s ``TrainOptions`` (every field,
the same defaults except ``extract_impl``, which names the port's
backends) and ``_dropout_key``. The distributed ``ForwardEngine`` is
ROADMAP queue 1, item 3: at g = 1 it computes exactly
``core.gcn_model.forward``, which ``core/fourd.py`` calls. Values this
slice cannot honour raise ``NotImplementedError`` naming their queue item.
"""
from __future__ import annotations

import dataclasses
from typing import List, Union

import torch

from repro_torch.core import sampling as smp

_COMM = "ROADMAP queue 1, item 6 (ring overlap and compressed collectives)"


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """Optimization toggles of the training step (paper §V); see the
    reference for the meaning of each."""

    bf16_collectives: bool = False     # §V-B
    fused_elementwise: bool = False    # §V-C: the fused tail kernel
    reshard_impl: str = "gather"
    dropout: float = 0.0               # dropout of the training step
    seed: int = 0
    sample_mode: str = "step"          # "step" | "epoch"
    sample_kind: str = "stratified"    # "stratified" ("partition", "walk")
    clusters: int = 0
    walk_len: int = 4
    walk_k: int = 8
    block_dtype: str = "f32"           # "f32" ("bf16")
    spmm_impl: str = "dense"           # "dense" | "ell" (block-ELL kernel)
    ell_tile: int = 128                # (bm = bn) tile side
    ell_slots: int = 16                # max nonzero col-tiles per row-block
    extract_impl: str = "torch"        # "torch" | "cuda" (fused kernel)
    overlap_impl: str = "none"         # "none" ("ring")
    compress: str = "none"             # "none" ("bf16", "int8", "int4")
    compress_schedule: str = "uniform"

    def __post_init__(self):
        if self.compress != "none" or self.bf16_collectives:
            raise NotImplementedError(
                f"compress={self.compress!r}, bf16_collectives="
                f"{self.bf16_collectives}: {_COMM}")
        if self.overlap_impl == "ring" or self.reshard_impl == "permute":
            raise NotImplementedError(
                f"overlap_impl={self.overlap_impl!r}, reshard_impl="
                f"{self.reshard_impl!r}: {_COMM}")
        if self.sample_kind in ("partition", "walk"):
            raise NotImplementedError(
                f"sample_kind={self.sample_kind!r} is {smp._LOCALITY}")
        if self.block_dtype == "bf16":
            raise NotImplementedError(
                "block_dtype='bf16' is not ported: the extraction writes "
                "float32 blocks")
        for name, value, allowed in (
                ("reshard_impl", self.reshard_impl, ("gather",)),
                ("overlap_impl", self.overlap_impl, ("none",)),
                ("sample_kind", self.sample_kind, ("stratified",)),
                ("sample_mode", self.sample_mode, ("step", "epoch")),
                ("block_dtype", self.block_dtype, ("f32",)),
                ("spmm_impl", self.spmm_impl, ("dense", "ell")),
                ("extract_impl", self.extract_impl, ("torch", "cuda")),
                ("compress_schedule", self.compress_schedule,
                 ("uniform", "variable"))):
            if value not in allowed:
                raise ValueError(f"{name}={value!r}: one of {allowed}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout={self.dropout}")


def _dropout_key(opts: TrainOptions, step: int, layer: int) -> int:
    """Per-layer dropout key of a step: (seed + 1, step, layer) mixed, as
    the reference folds them (its block coordinates are all 0 at g = 1)."""
    return smp.fold_in(smp.fold_in(opts.seed + 1, step), layer)


def dropout_masks(opts: TrainOptions, step: int, num_layers: int,
                  shape: tuple, device: Union[str, torch.device]
                  ) -> List[torch.Tensor]:
    """One bool keep-mask per layer, ``rand < 1 - p`` drawn on ``device``
    from the layer's generator: a pure function of (seed, step, layer)."""
    return [torch.rand(shape, device=device, generator=smp.make_generator(
        _dropout_key(opts, step, li), device)) < 1.0 - opts.dropout
        for li in range(num_layers)]
