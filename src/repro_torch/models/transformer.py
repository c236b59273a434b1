"""Dense decoder-only transformer: init, weights from the reference, the
full-sequence forward and the slot-indexed KV cache of LLM serving.

Counterpart of ``repro/models/transformer.py`` for the ``dense`` family
(llama-style: pre-norm attention and MLP blocks, RoPE, GQA; qwen2's QKV
bias and tied embeddings). Other families raise ``NotImplementedError``
naming their ROADMAP item.

The model is an ``nn.Module`` (:class:`Transformer`) holding one
:class:`DenseBlock` per layer, where the reference stacks every layer leaf
with a leading L dim and scans over it; the public functions keep the
reference's names and arguments (``params`` is the module). Weights carry
no gradient: this slice serves, and LLM training is still to be ported.

Full-sequence attention goes through the CUDA flash kernel
(``attn_impl="cuda"``, the default) or its plain version
(``attn_impl="torch"``); decode attention is plain PyTorch in float32 on
both. Unlike the reference, which returns a new cache, the KV pool is
updated in place: :func:`prefill_into_slot` and :func:`decode_step_slots`
write into ``cache`` and return that same dict.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device, use_full_f32_matmul
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Cache = Dict[str, Any]

LLM_ITEM = '"The LLM stack beyond the dense serving path"'

# the part of ROADMAP queue 1, "The LLM stack beyond the dense serving
# path", that ports each family
_FAMILY_TODO = {
    "moe": "MoE",
    "ssm": "SSM and hybrid",
    "hybrid": "SSM and hybrid",
    "vlm": "VLM and audio",
    "audio": "VLM and audio",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet: ROADMAP queue 1, "
            f'{LLM_ITEM} ({_FAMILY_TODO.get(cfg.family, cfg.family)})')


def _pdict(leaves: Mapping[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in leaves.items()})


class DenseBlock(nn.Module):
    """One pre-norm layer: ``norm1`` -> attention -> residual, ``norm2``
    -> MLP -> residual."""

    def __init__(self, attn: Mapping, norm1: Mapping, norm2: Mapping,
                 mlp: Mapping):
        super().__init__()
        self.attn = _pdict(attn)
        self.norm1 = _pdict(norm1)
        self.norm2 = _pdict(norm2)
        self.mlp = _pdict(mlp)

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, attn_impl: str = "cuda",
                return_kv: bool = False):
        return _dense_block(self, x, cfg, positions,
                            window=cfg.sliding_window,
                            rope_theta=cfg.rope_theta, attn_impl=attn_impl,
                            return_kv=return_kv)


class Transformer(nn.Module):
    """The model: embedding, the blocks, the final norm and the LM head
    (absent with tied embeddings)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 final_norm: Mapping, lm_head: Optional[torch.Tensor],
                 blocks: list):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = _pdict(final_norm)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))
        self.blocks = nn.ModuleList(blocks)

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ---------------------------------------------------------------------------
# Initialization and weights from the reference
# ---------------------------------------------------------------------------

def _norm_leaves(cfg: ModelConfig, d: int, dev) -> dict:
    p = {"scale": torch.ones((d,), dtype=cfg.param_dtype, device=dev)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=cfg.param_dtype, device=dev)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[Union[str, torch.device]] = None
                ) -> Transformer:
    """Random weights as the reference draws them: N(0, 0.02) matrices
    (drawn in float32 on the generator's device, then cast), unit norm
    scales and zero biases. ``device`` None means the card."""
    _check_family(cfg)
    dev = resolve_device(device)
    use_full_f32_matmul()
    d, vp, f = cfg.d_model, cfg.vocab_padded, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd

    def dense(*shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * 0.02
        return w.to(device=dev, dtype=cfg.param_dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.param_dtype, device=dev)

    embed = dense(vp, d)
    lm_head = None if cfg.tie_embeddings else dense(d, vp)
    blocks = []
    for _ in range(cfg.n_layers):
        attn = {"wq": dense(d, hq), "wk": dense(d, hkv), "wv": dense(d, hkv),
                "wo": dense(hq, d)}
        if cfg.qkv_bias:
            attn.update(bq=zeros(hq), bk=zeros(hkv), bv=zeros(hkv))
        mlp = ({"wg": dense(d, f), "wu": dense(d, f), "wd": dense(f, d)}
               if cfg.mlp == "swiglu" else
               {"w1": dense(d, f), "b1": zeros(f), "w2": dense(f, d),
                "b2": zeros(d)})
        blocks.append(DenseBlock(attn, _norm_leaves(cfg, d, dev),
                                 _norm_leaves(cfg, d, dev), mlp))
    return Transformer(cfg, embed, _norm_leaves(cfg, d, dev), lm_head,
                       blocks)


def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Transformer:
    """The model holding the values of the reference's parameter pytree,
    given as numpy arrays: ``embed``, ``final_norm``, ``lm_head`` (unless
    tied) and ``blocks.{attn, norm1, norm2, mlp}`` stacked with a leading
    L dim. A bfloat16 leaf becomes float32 exactly, and the cast to
    ``cfg.param_dtype`` gives back the same bits."""
    _check_family(cfg)
    dev = resolve_device(device)
    use_full_f32_matmul()

    def t(a) -> torch.Tensor:
        a32 = np.array(a, dtype=np.float32)     # a writable copy
        return torch.from_numpy(a32).to(device=dev, dtype=cfg.param_dtype)

    blk = tree["blocks"]
    layer = lambda group, i: {k: t(np.asarray(v)[i])
                              for k, v in blk[group].items()}
    blocks = [DenseBlock(layer("attn", i), layer("norm1", i),
                         layer("norm2", i), layer("mlp", i))
              for i in range(cfg.n_layers)]
    return Transformer(cfg, t(tree["embed"]),
                       {k: t(v) for k, v in tree["final_norm"].items()},
                       None if cfg.tie_embeddings else t(tree["lm_head"]),
                       blocks)


def params_to_numpy(params: Transformer) -> dict:
    """The reverse of :func:`params_from_numpy`: the reference's pytree
    layout as float32 numpy arrays, layer leaves stacked."""
    n = lambda x: x.detach().float().cpu().numpy()
    tree = {"embed": n(params.embed),
            "final_norm": {k: n(v) for k, v in params.final_norm.items()}}
    if params.lm_head is not None:
        tree["lm_head"] = n(params.lm_head)
    tree["blocks"] = {
        group: {k: np.stack([n(getattr(b, group)[k]) for b in params.blocks])
                for k in getattr(params.blocks[0], group).keys()}
        for group in ("attn", "norm1", "norm2", "mlp")}
    return tree


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------


def _norm(x: torch.Tensor, p: Mapping, cfg: ModelConfig) -> torch.Tensor:
    return L.apply_norm(x, p, cfg.norm, cfg.norm_eps)


def _dense_block(p: DenseBlock, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, *, window: Optional[int],
                 rope_theta: Optional[float], attn_impl: str = "cuda",
                 return_kv: bool = False):
    a = L.attention_block(
        p.attn, _norm(x, p.norm1, cfg), n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, hd=cfg.hd, rope_theta=rope_theta,
        positions=positions, causal=True, window=window,
        attn_impl=attn_impl, return_kv=return_kv)
    a, kv = a if return_kv else (a, None)
    h = x + a
    h = h + L.mlp_block(p.mlp, _norm(h, p.norm2, cfg), cfg.mlp)
    return (h, kv) if return_kv else h


def _embed(params: Transformer, tokens: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings; positions enter through RoPE (the absolute
    sinusoidal positions of the reference's whisper are not ported)."""
    return params.embed[tokens.long()].to(cfg.compute_dtype)


def _logits(params: Transformer, h: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    h = _norm(h, params.final_norm, cfg)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = h @ w.to(h.dtype)
    if cfg.vocab_padded != cfg.vocab:   # mask padded vocabulary ids
        real = torch.arange(cfg.vocab_padded, device=h.device) < cfg.vocab
        logits = logits.masked_fill(~real, -1e30)
    return logits


def _trunk(params: Transformer, h: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor, *,
           attn_impl: str = "cuda") -> torch.Tensor:
    """The layer stack over full-sequence hidden states (dense family)."""
    _check_family(cfg)
    for blk in params.blocks:
        h = blk(h, cfg, positions, attn_impl=attn_impl)
    return h


@torch.no_grad()
def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
            attn_impl: str = "cuda") -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, Vp): the logits of the reference's
    ``forward_train``, without its auxiliary loss (zero for dense
    models)."""
    positions = torch.arange(tokens.shape[1], device=params.device)
    h = _trunk(params, _embed(params, tokens, cfg), cfg, positions,
               attn_impl=attn_impl)
    return _logits(params, h, cfg)


# ---------------------------------------------------------------------------
# KV cache and the slot API of LLM serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Optional[Union[str, torch.device]] = None) -> Cache:
    """Decode state: ``pos`` and the (L, batch, T, KV, hd) K/V in the
    compute dtype; ``max_len`` is the sequence horizon (a sliding-window
    model allocates only its window)."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.kv_cache_len(max_len), cfg.n_kv_heads,
             cfg.hd)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "self_kv": {"k": torch.zeros(shape, dtype=cfg.compute_dtype,
                                         device=dev),
                        "v": torch.zeros(shape, dtype=cfg.compute_dtype,
                                         device=dev)}}


def init_slot_cache(cfg: ModelConfig, slots: int, max_len: int,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Cache:
    """A pooled decode cache: batch dim = scheduler slots, per-slot
    ``pos`` (slots,)."""
    cache = init_cache(cfg, slots, max_len, device)
    cache["pos"] = torch.zeros((slots,), dtype=torch.int32,
                               device=cache["pos"].device)
    return cache


@torch.no_grad()
def prefill_into_slot(params: Transformer, tokens: torch.Tensor,
                      length: int, cache: Cache, slot: int,
                      cfg: ModelConfig, *, attn_impl: str = "cuda"):
    """Prefill ONE prompt into cache slot ``slot``, in place.

    ``tokens`` is (1, Sp) right-padded to the static prompt capacity and
    ``length`` the real prompt length. Padded positions write K/V rows
    too, but decode masks each row's cache at its own ``pos``, so they
    are never attended. K and V are projected once per layer, for the
    attention and the cache alike. Returns ``(greedy_token (1,),
    last-real-position logits (1, 1, Vp), cache)``."""
    b, s = tokens.shape
    if b != 1:
        raise ValueError("one prompt per slot prefill")
    kv = cache["self_kv"]
    if s > kv["k"].shape[2]:
        raise ValueError(f"prompt capacity {s} exceeds KV cache length "
                         f"{kv['k'].shape[2]}")
    positions = torch.arange(s, device=params.device)
    h = _embed(params, tokens, cfg)
    for i, blk in enumerate(params.blocks):
        h, (k, v) = blk(h, cfg, positions, attn_impl=attn_impl,
                        return_kv=True)
        kv["k"][i, slot, :s] = k[0]
        kv["v"][i, slot, :s] = v[0]
    cache["pos"][slot] = length
    logits = _logits(params, h[:, length - 1:length], cfg)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    return tok, logits, cache


def _attn_decode_slots(p: Mapping, x: torch.Tensor, k_layer: torch.Tensor,
                       v_layer: torch.Tensor, pos: torch.Tensor,
                       cfg: ModelConfig,
                       rope_theta: Optional[float]) -> torch.Tensor:
    """One-token attention with per-row positions ``pos`` (slots,); writes
    the row's K/V into the layer's pool in place."""
    b = x.shape[0]
    q, k, v = L.attn_project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    if rope_theta is not None:
        posv = pos[:, None]                      # (slots, 1) per-row
        q = L.rope(q, posv, rope_theta)
        k = L.rope(k, posv, rope_theta)
    t = k_layer.shape[1]
    # every row writes, active or not; a full non-ring cache clamps to its
    # last row (a finished slot's write is garbage the mask never exposes)
    idx = (pos % t if cfg.sliding_window is not None
           else torch.clamp(pos, max=t - 1)).long()
    rows = torch.arange(b, device=x.device)
    k_layer[rows, idx] = k[:, 0]
    v_layer[rows, idx] = v[:, 0]
    out = L.decode_attention(q, k_layer, v_layer, (pos + 1)[:, None])
    return out.reshape(b, 1, cfg.n_heads * cfg.hd) @ p["wo"]


@torch.no_grad()
def decode_step_slots(params: Transformer, token: torch.Tensor, cache: Cache,
                      cfg: ModelConfig, active: torch.Tensor, *,
                      attn_impl: str = "cuda"):
    """One decode step over the whole slot pool, in place.

    ``token`` (slots, 1) is each slot's last token (garbage for free
    slots); ``active`` (slots,) bool gates which slots advance their
    ``pos``. Decode attention is plain PyTorch whatever ``attn_impl``
    says (the reference's is plain jnp); the argument is checked so that
    both paths take the same arguments. Returns ``(greedy_tokens (slots,),
    logits (slots, 1, Vp), cache)``."""
    L._check_impl(attn_impl)
    _check_family(cfg)
    pos = cache["pos"]
    h = _embed(params, token, cfg)
    kv = cache["self_kv"]
    for i, blk in enumerate(params.blocks):
        h = h + _attn_decode_slots(blk.attn, _norm(h, blk.norm1, cfg),
                                   kv["k"][i], kv["v"][i], pos, cfg,
                                   cfg.rope_theta)
        h = h + L.mlp_block(blk.mlp, _norm(h, blk.norm2, cfg), cfg.mlp)
    logits = _logits(params, h, cfg)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    pos += active.to(device=pos.device, dtype=pos.dtype)
    return tok, logits, cache
