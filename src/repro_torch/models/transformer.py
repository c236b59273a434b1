"""Language models: init, weights from the reference, the full-sequence
forward (for serving and, with gradients, for training), the LM loss, the
scalar-pos decode cache (``prefill`` / ``decode_step``) and the
slot-indexed KV cache of LLM serving.

Counterpart of ``repro/models/transformer.py`` for all six of its
families: ``dense`` (llama-style: pre-norm attention and MLP blocks, RoPE,
GQA; qwen2's QKV bias and tied embeddings), ``moe`` (mixtral,
llama4-scout: the MLP replaced by ``models/moe.py``'s capacity-dispatched
experts), ``ssm`` (mamba2: pre-norm Mamba2 blocks of ``models/ssm.py``),
``hybrid`` (zamba2: Mamba2 blocks with one weight-shared attention and MLP
block applied before every ``shared_attn_every`` of them), ``vlm``
(llama-3.2-vision: a gated cross-attention layer to the given image
embeddings before each group of self layers) and ``audio`` (whisper: a
non-causal encoder over the given frame embeddings, then decoder layers of
causal self-attention, cross-attention to the encoder's output and an
MLP; absolute sinusoidal positions in place of RoPE). The vlm and audio
families take that ``memory`` in ``forward_train`` and ``prefill``, and
``prefill`` projects its cross K/V once into the cache.

The model is an ``nn.Module`` (:class:`Transformer`) holding one
:class:`DenseBlock` (:class:`MoEBlock`, :class:`MambaBlock`,
:class:`AudioBlock`) per layer, zamba2's :class:`SharedAttnBlock` once,
the VLM's :class:`CrossBlock` per group and whisper's
:class:`EncoderBlock` per encoder layer, where the reference stacks every
layer leaf with a leading L dim and scans over it; the public functions
keep the reference's names and arguments (``params`` is the module).
Weights carry no gradient unless built with ``trainable=True``;
:func:`param_tree` lays them out in the reference's pytree order for the
optimizer.

Full-sequence attention (self, cross and encoder) goes through the CUDA
flash kernels, forward and backward (``attn_impl="cuda"``, the default),
or their plain versions (``attn_impl="torch"``); decode attention, over
the self and the cross K/V alike, is plain PyTorch in float32 on both.
Unlike the reference, which returns a new cache, the decode caches are
updated in place: :func:`decode_step`, :func:`prefill_into_slot` and
:func:`decode_step_slots` write into ``cache`` and return that same dict
(:func:`prefill` returns the cache it filled).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device, use_full_f32_matmul
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.obs import phase

Cache = Dict[str, Any]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# the families whose forward takes a memory: image embeddings (vlm) or
# frame embeddings, run through the encoder (audio)
MEMORY_FAMILIES = ("vlm", "audio")
# leaves kept in float32 whatever ``param_dtype`` is, as in the reference
F32_LEAVES = SSM.F32_LEAVES + ("gate_attn", "gate_mlp")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; known: {FAMILIES}")


def _device(device) -> torch.device:
    """``resolve_device``, and the meta device of the dry run (shapes
    only)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


# ---------------------------------------------------------------------------
# Run options: activation layout and rematerialisation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunOptions:
    """The reference's knobs, set around a step (``run_options``).

    ``act_sharding`` — the spec of the (B, S, D) hidden states between
    layers under a mesh (``models/sharded.py``): the reference's dry run
    gives ``P(dp, "model", None)``, the sequence over ``model``, the
    sharded step's layout; None (or a sequence the model axis does not
    divide) keeps every rank's rows whole. ``remat`` — each layer runs
    under ``torch.utils.checkpoint`` (non-reentrant), so the backward
    recomputes its activations, a sharded layer's weight gathers included.
    ``head_sharding`` and ``inner_act_sharding`` pin layouts for the
    reference's GSPMD (the logits weight; Megatron-style replicated block
    inputs); the port gathers every weight whole inside its block and keeps
    the block's rows local, so they are kept and change nothing."""
    act_sharding: Any = None
    remat: bool = False
    head_sharding: Any = None
    inner_act_sharding: Any = None


_RUN_OPTS = RunOptions()


@contextlib.contextmanager
def run_options(act_sharding=None, remat: bool = False, head_sharding=None,
                inner_act_sharding=None):
    global _RUN_OPTS
    prev = _RUN_OPTS
    _RUN_OPTS = RunOptions(act_sharding=act_sharding, remat=remat,
                           head_sharding=head_sharding,
                           inner_act_sharding=inner_act_sharding)
    try:
        yield
    finally:
        _RUN_OPTS = prev


def run_opts() -> RunOptions:
    """The options in force."""
    return _RUN_OPTS


def _layer(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` with ``remat``
    while gradients are on."""
    if _RUN_OPTS.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _mesh_path(cfg: ModelConfig, what: str):
    """The sharded step's module, for the families it covers."""
    from repro_torch.models import sharded
    sharded.check_family(cfg, what)
    return sharded


def _pdict(leaves: Mapping, trainable: bool) -> nn.ParameterDict:
    """A ``ParameterDict`` of ``leaves``; a nested mapping (the MoE
    group's ``shared``) becomes a nested ``ParameterDict``."""
    return nn.ParameterDict({
        k: (_pdict(v, trainable) if isinstance(v, Mapping)
            else nn.Parameter(v, requires_grad=trainable))
        for k, v in leaves.items()})


class DenseBlock(nn.Module):
    """One pre-norm layer: ``norm1`` -> attention -> residual, ``norm2``
    -> feed-forward (the group ``FFN``, an MLP here) -> residual."""

    FFN = "mlp"

    def __init__(self, attn: Mapping, norm1: Mapping, norm2: Mapping,
                 ffn: Mapping, trainable: bool = False):
        super().__init__()
        self.attn = _pdict(attn, trainable)
        self.norm1 = _pdict(norm1, trainable)
        self.norm2 = _pdict(norm2, trainable)
        setattr(self, self.FFN, _pdict(ffn, trainable))

    @classmethod
    def groups(cls) -> tuple:
        """The layer's parameter groups, as the reference's ``blocks``
        names them."""
        return ("attn", "norm1", "norm2", cls.FFN)

    def ffn(self, x: torch.Tensor, cfg: ModelConfig):
        """(output, aux): the MLP, and no auxiliary loss."""
        return L.mlp_block(self.mlp, x, cfg.mlp), None

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, attn_impl: str = "cuda",
                return_kv: bool = False):
        """``(h, aux)``, or ``(h, aux, (k, v))`` with ``return_kv``; aux
        is None for an MLP layer."""
        return _dense_block(self, x, cfg, positions,
                            window=cfg.sliding_window,
                            rope_theta=cfg.rope_theta, attn_impl=attn_impl,
                            return_kv=return_kv)


class MoEBlock(DenseBlock):
    """A layer of the ``moe`` family: the MLP is the group ``moe``
    (``router``, ``wg``, ``wu``, ``wd`` and llama4's ``shared``), run by
    ``models/moe.py``, whose auxiliary loss the layer returns."""

    FFN = "moe"

    def ffn(self, x: torch.Tensor, cfg: ModelConfig):
        return M.moe_ffn(self.moe, x, cfg)


class MambaBlock(nn.Module):
    """A layer of the ``ssm`` and ``hybrid`` families: ``norm`` -> the
    Mamba2 block (the group ``mamba``, run by ``models/ssm.py``) ->
    residual."""

    def __init__(self, mamba: Mapping, norm: Mapping,
                 trainable: bool = False):
        super().__init__()
        self.mamba = _pdict(mamba, trainable)
        self.norm = _pdict(norm, trainable)

    @classmethod
    def groups(cls) -> tuple:
        return ("mamba", "norm")

    def forward(self, x: torch.Tensor, cfg: ModelConfig, *,
                return_state: bool = False):
        """``h``, or ``(h, final ssm state, conv tail)`` with
        ``return_state``: the state a prefill hands to decode."""
        out = SSM.mamba2_block(self.mamba, _norm(x, self.norm, cfg), cfg,
                               return_conv_input=return_state)
        if not return_state:
            return x + out[0]
        y, state, conv_in = out
        return x + y, state, _conv_tail(conv_in, cfg)

    def decode(self, x: torch.Tensor, cfg: ModelConfig,
               conv_state: torch.Tensor, ssm_state: torch.Tensor):
        """One token: ``(h, conv_state', ssm_state')``."""
        y, conv, ssm = SSM.mamba2_decode(self.mamba, _norm(x, self.norm, cfg),
                                         cfg, conv_state, ssm_state)
        return x + y, conv, ssm


class SharedAttnBlock(nn.Module):
    """zamba2's shared transformer block, one set of weights applied before
    every ``shared_attn_every`` Mamba layers: ``norm`` -> causal
    self-attention (RoPE, no window) -> residual, ``norm2`` -> MLP ->
    residual."""

    GROUPS = ("attn", "norm", "mlp", "norm2")

    def __init__(self, attn: Mapping, norm: Mapping, mlp: Mapping,
                 norm2: Mapping, trainable: bool = False):
        super().__init__()
        for name, leaves in zip(self.GROUPS, (attn, norm, mlp, norm2)):
            setattr(self, name, _pdict(leaves, trainable))

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, attn_impl: str = "cuda",
                return_kv: bool = False):
        """``h``, or ``(h, (k, v))`` with ``return_kv``."""
        a = L.attention_block(
            self.attn, _norm(x, self.norm, cfg), n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, hd=cfg.hd, rope_theta=cfg.rope_theta,
            positions=positions, causal=True, attn_impl=attn_impl,
            return_kv=return_kv)
        a, kv = a if return_kv else (a, None)
        h = x + a
        h = h + L.mlp_block(self.mlp, _norm(h, self.norm2, cfg), cfg.mlp)
        return (h, kv) if return_kv else h

    def decode(self, x: torch.Tensor, cfg: ModelConfig,
               k_layer: torch.Tensor, v_layer: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
        """One token at the scalar position ``pos``, its K/V written into
        the application's cache in place."""
        h = x + _attn_decode_slots(self.attn, _norm(x, self.norm, cfg),
                                   k_layer, v_layer, pos.expand(x.shape[0]),
                                   cfg, cfg.rope_theta)
        return h + L.mlp_block(self.mlp, _norm(h, self.norm2, cfg), cfg.mlp)


class EncoderBlock(DenseBlock):
    """whisper's encoder layer: a :class:`DenseBlock`'s groups, its
    self-attention over the frames without a mask and without RoPE."""

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, attn_impl: str = "cuda"):
        h = x + L.attention_block(
            self.attn, _norm(x, self.norm1, cfg), n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, hd=cfg.hd, rope_theta=None,
            positions=positions, causal=False, attn_impl=attn_impl)
        return h + L.mlp_block(self.mlp, _norm(h, self.norm2, cfg), cfg.mlp)


class CrossBlock(nn.Module):
    """The VLM's gated cross-attention layer, run before each group of
    self layers: ``norm1`` -> cross-attention to the image embeddings ->
    ``h + tanh(gate_attn) * .``, ``norm2`` -> MLP -> ``h + tanh(gate_mlp)
    * .``. The gates are 0-d float32 leaves (the reference stacks them as
    (n_cross,)), zero at init, so that a fresh layer adds nothing."""

    GROUPS = ("attn", "mlp", "norm1", "norm2", "gate_attn", "gate_mlp")

    def __init__(self, attn: Mapping, mlp: Mapping, norm1: Mapping,
                 norm2: Mapping, gate_attn: torch.Tensor,
                 gate_mlp: torch.Tensor, trainable: bool = False):
        super().__init__()
        for name, leaves in zip(self.GROUPS[:4], (attn, mlp, norm1, norm2)):
            setattr(self, name, _pdict(leaves, trainable))
        self.gate_attn = nn.Parameter(gate_attn, requires_grad=trainable)
        self.gate_mlp = nn.Parameter(gate_mlp, requires_grad=trainable)

    @classmethod
    def groups(cls) -> tuple:
        return cls.GROUPS

    def _gated_mlp(self, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        m = L.mlp_block(self.mlp, _norm(h, self.norm2, cfg), cfg.mlp)
        return h + torch.tanh(self.gate_mlp).to(h.dtype) * m

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                memory: torch.Tensor, *, attn_impl: str = "cuda",
                return_kv: bool = False):
        """``h``, or ``(h, (k, v))`` with ``return_kv``: the memory's
        cross K/V, for the decode cache."""
        a = L.cross_attention_block(
            self.attn, _norm(x, self.norm1, cfg), memory,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
            attn_impl=attn_impl, return_kv=return_kv)
        a, kv = a if return_kv else (a, None)
        h = self._gated_mlp(x + torch.tanh(self.gate_attn).to(x.dtype) * a,
                            cfg)
        return (h, kv) if return_kv else h

    def decode(self, x: torch.Tensor, cfg: ModelConfig,
               k_layer: torch.Tensor, v_layer: torch.Tensor) -> torch.Tensor:
        """One token a row against the layer's cross K/V cache."""
        a = _cross_decode(self.attn, _norm(x, self.norm1, cfg), k_layer,
                          v_layer, cfg)
        return self._gated_mlp(x + torch.tanh(self.gate_attn).to(x.dtype)
                               * a, cfg)


class AudioBlock(nn.Module):
    """whisper's decoder layer: ``norm1`` -> causal self-attention (no
    RoPE: the positions are in the embedding) -> residual, ``norm2`` ->
    cross-attention to the encoder's output -> residual, ``norm3`` -> MLP
    -> residual."""

    GROUPS = ("attn", "cross", "mlp", "norm1", "norm2", "norm3")

    def __init__(self, attn: Mapping, cross: Mapping, mlp: Mapping,
                 norm1: Mapping, norm2: Mapping, norm3: Mapping,
                 trainable: bool = False):
        super().__init__()
        for name, leaves in zip(self.GROUPS,
                                (attn, cross, mlp, norm1, norm2, norm3)):
            setattr(self, name, _pdict(leaves, trainable))

    @classmethod
    def groups(cls) -> tuple:
        return cls.GROUPS

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, memory: torch.Tensor, *,
                attn_impl: str = "cuda", return_kv: bool = False):
        """``h``, or ``(h, (k, v), (cross k, cross v))`` with
        ``return_kv``."""
        a = L.attention_block(
            self.attn, _norm(x, self.norm1, cfg), n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, hd=cfg.hd, rope_theta=cfg.rope_theta,
            positions=positions, causal=True, attn_impl=attn_impl,
            return_kv=return_kv)
        a, kv = a if return_kv else (a, None)
        h = x + a
        c = L.cross_attention_block(
            self.cross, _norm(h, self.norm2, cfg), memory,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
            attn_impl=attn_impl, return_kv=return_kv)
        c, ckv = c if return_kv else (c, None)
        h = h + c
        h = h + L.mlp_block(self.mlp, _norm(h, self.norm3, cfg), cfg.mlp)
        return (h, kv, ckv) if return_kv else h

    def decode(self, x: torch.Tensor, cfg: ModelConfig,
               kv: Mapping, cross_kv: Mapping, i: int,
               pos: torch.Tensor) -> torch.Tensor:
        """One token a row at the scalar position ``pos``: layer ``i``'s
        K/V written into ``kv`` in place, its cross K/V read."""
        h = x + _attn_decode_slots(self.attn, _norm(x, self.norm1, cfg),
                                   kv["k"][i], kv["v"][i],
                                   pos.expand(x.shape[0]), cfg,
                                   cfg.rope_theta)
        h = h + _cross_decode(self.cross, _norm(h, self.norm2, cfg),
                              cross_kv["k"][i], cross_kv["v"][i], cfg)
        return h + L.mlp_block(self.mlp, _norm(h, self.norm3, cfg), cfg.mlp)


def _block_class(cfg: ModelConfig) -> type:
    return {"moe": MoEBlock, "ssm": MambaBlock, "hybrid": MambaBlock,
            "audio": AudioBlock}.get(cfg.family, DenseBlock)


def _shared_every(cfg: ModelConfig) -> Optional[int]:
    """The hybrid family's ``shared_attn_every`` (which must divide the
    layers, as in the reference), None for the other families."""
    if cfg.family != "hybrid":
        return None
    k = cfg.shared_attn_every
    if not k or cfg.n_layers % k:
        raise ValueError(f"{cfg.name}: shared_attn_every={k} does not divide "
                         f"{cfg.n_layers} layers")
    return k


def _cross_groups(cfg: ModelConfig) -> tuple:
    """The vlm family's ``(n_cross, per)``: one cross layer every
    ``cross_attn_every`` layers, each followed by ``per`` self layers (the
    self layers must split evenly, as the reference asserts)."""
    k = cfg.cross_attn_every
    n_cross = cfg.n_layers // k if k else 0
    if not n_cross or (cfg.n_layers - n_cross) % n_cross:
        raise ValueError(f"{cfg.name}: cross_attn_every={k} does not split "
                         f"{cfg.n_layers} layers into whole groups")
    return n_cross, (cfg.n_layers - n_cross) // n_cross


def _layer_counts(cfg: ModelConfig) -> dict:
    """The stacked groups of the reference's pytree and their layers:
    ``blocks`` (the vlm's self layers only), and ``cross_blocks`` (vlm) or
    ``enc_blocks`` (audio)."""
    if cfg.family == "vlm":
        n_cross, per = _cross_groups(cfg)
        return {"blocks": n_cross * per, "cross_blocks": n_cross}
    if cfg.family == "audio":
        return {"blocks": cfg.n_layers, "enc_blocks": cfg.encoder.n_layers}
    return {"blocks": cfg.n_layers}


class Transformer(nn.Module):
    """The model: embedding, the blocks, the final norm and the LM head
    (absent with tied embeddings), the hybrid family's shared block, the
    vlm family's cross layers and the audio family's encoder (its blocks
    and final norm). With ``trainable`` every weight requires grad (the
    blocks are built with the same flag)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 final_norm: Mapping, lm_head: Optional[torch.Tensor],
                 blocks: list, trainable: bool = False,
                 shared_attn: Optional[SharedAttnBlock] = None,
                 cross_blocks: Optional[list] = None,
                 enc_blocks: Optional[list] = None,
                 enc_norm: Optional[Mapping] = None):
        super().__init__()
        _check_family(cfg)
        for part, family in ((shared_attn, "hybrid"), (cross_blocks, "vlm"),
                             (enc_blocks, "audio"), (enc_norm, "audio")):
            if (part is None) != (cfg.family != family):
                raise ValueError(f"the {family} family's own blocks go with "
                                 f"it, and only with it ({cfg.family!r})")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=trainable)
        self.final_norm = _pdict(final_norm, trainable)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=trainable))
        self.blocks = nn.ModuleList(blocks)
        self.shared_attn = shared_attn
        self.cross_blocks = (None if cross_blocks is None
                             else nn.ModuleList(cross_blocks))
        self.enc_blocks = (None if enc_blocks is None
                           else nn.ModuleList(enc_blocks))
        self.enc_norm = (None if enc_norm is None
                         else _pdict(enc_norm, trainable))

    def stacked_groups(self) -> dict:
        """The reference's stacked groups (``blocks``, ``cross_blocks``,
        ``enc_blocks``) that this model has, each a list of its layers."""
        groups = {"blocks": self.blocks, "cross_blocks": self.cross_blocks,
                  "enc_blocks": self.enc_blocks}
        return {k: v for k, v in groups.items() if v is not None}

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
                device: Optional[Union[str, torch.device]] = None, *,
                trainable: bool = False) -> Transformer:
    """Random weights as the reference draws them: N(0, 0.02) matrices
    (drawn in float32 on the generator's device, then cast; a Mamba
    block's conv N(0, 0.2)), unit norm scales and zero biases; a Mamba
    block's ``a_log`` 0, ``d_skip`` 1 and ``dt_bias`` 0 in float32
    whatever ``param_dtype`` is. ``device`` None means the card;
    ``"meta"`` gives the shapes and types alone, drawing nothing
    (:func:`abstract_params`); ``trainable`` makes every weight require
    grad."""
    _check_family(cfg)
    dev = _device(device)
    use_full_f32_matmul()
    d, vp, f = cfg.d_model, cfg.vocab_padded, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd

    def dense(*shape, scale=0.02):
        if dev.type == "meta":
            return torch.empty(shape, dtype=cfg.param_dtype, device=dev)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale
        return w.to(device=dev, dtype=cfg.param_dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.param_dtype, device=dev)

    def attn():
        p = {"wq": dense(d, hq), "wk": dense(d, hkv), "wv": dense(d, hkv),
             "wo": dense(hq, d)}
        if cfg.qkv_bias:
            p.update(bq=zeros(hq), bk=zeros(hkv), bv=zeros(hkv))
        return p

    def mlp():
        if cfg.mlp == "swiglu":
            return {"wg": dense(d, f), "wu": dense(d, f), "wd": dense(f, d)}
        return {"w1": dense(d, f), "b1": zeros(f), "w2": dense(f, d),
                "b2": zeros(d)}

    def mamba():                        # the reference's _mamba_params
        din, gn, nh, k = SSM.mamba2_split_sizes(cfg)
        f32 = dict(dtype=torch.float32, device=dev)
        return {"in_proj": dense(d, 2 * din + 2 * gn + nh),
                "conv_w": dense(din + 2 * gn, k, scale=0.2),
                "a_log": torch.zeros(nh, **f32),
                "d_skip": torch.ones(nh, **f32),
                "dt_bias": torch.zeros(nh, **f32),
                "norm_scale": torch.ones(din, dtype=cfg.param_dtype,
                                         device=dev),
                "out_proj": dense(din, d)}

    norm = lambda: _norm_leaves(cfg, d, dev)
    gate = lambda: torch.zeros((), dtype=torch.float32, device=dev)
    embed = dense(vp, d)
    lm_head = None if cfg.tie_embeddings else dense(d, vp)
    counts = _layer_counts(cfg)
    blocks = []
    for _ in range(counts["blocks"]):
        if cfg.family in ("ssm", "hybrid"):
            blocks.append(MambaBlock(mamba(), norm(), trainable))
            continue
        if cfg.family == "audio":
            blocks.append(AudioBlock(attn(), attn(), mlp(), norm(), norm(),
                                     norm(), trainable))
            continue
        if cfg.family == "moe":         # the reference's _moe_params
            e = cfg.moe.num_experts
            ffn = {"router": dense(d, e), "wg": dense(e, d, f),
                   "wu": dense(e, d, f), "wd": dense(e, f, d)}
            if cfg.moe.shared_expert:
                ffn["shared"] = {"wg": dense(d, f), "wu": dense(d, f),
                                 "wd": dense(f, d)}
        else:
            ffn = mlp()
        blocks.append(_block_class(cfg)(attn(), norm(), norm(), ffn,
                                        trainable))
    extra = {}
    if cfg.family == "hybrid":
        extra["shared_attn"] = SharedAttnBlock(attn(), norm(), mlp(), norm(),
                                               trainable)
    if cfg.family == "vlm":
        extra["cross_blocks"] = [
            CrossBlock(attn(), mlp(), norm(), norm(), gate(), gate(),
                       trainable) for _ in range(counts["cross_blocks"])]
    if cfg.family == "audio":
        extra["enc_blocks"] = [
            EncoderBlock(attn(), norm(), norm(), mlp(), trainable)
            for _ in range(counts["enc_blocks"])]
        extra["enc_norm"] = norm()
    return Transformer(cfg, embed, norm(), lm_head, blocks, trainable,
                       **extra)


def abstract_params(cfg: ModelConfig, *, trainable: bool = False
                    ) -> Transformer:
    """The model on the meta device: every weight's shape and type, no
    storage and no draw (the dry run's; the reference's ``eval_shape`` of
    ``init_params``)."""
    return init_params(cfg, torch.Generator(), "meta", trainable=trainable)


def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device: Optional[Union[str, torch.device]] = None, *,
                      trainable: bool = False) -> Transformer:
    """The model holding the values of the reference's parameter pytree,
    given as numpy arrays: ``embed``, ``final_norm``, ``lm_head`` (unless
    tied) and ``blocks.{attn, norm1, norm2, mlp}`` stacked with a leading
    L dim, with ``blocks.moe.{router, wg, wu, wd, shared.{wg, wu, wd}}``
    in place of ``mlp`` for the ``moe`` family, ``blocks.{mamba, norm}``
    for the ``ssm`` and ``hybrid`` families and, for ``hybrid``, the
    unstacked ``shared_attn.{attn, norm, mlp, norm2}``; for ``vlm`` the
    self layers' ``blocks`` and the stacked ``cross_blocks.{attn, mlp,
    norm1, norm2, gate_attn, gate_mlp}`` (the gates (n_cross,)); for
    ``audio`` ``blocks.{attn, cross, mlp, norm1, norm2, norm3}``, the
    encoder's stacked ``enc_blocks.{attn, mlp, norm1, norm2}`` and
    ``enc_norm``. A bfloat16 leaf becomes float32 exactly, and the cast to
    ``cfg.param_dtype`` gives back the same bits; a Mamba block's
    ``a_log``, ``d_skip`` and ``dt_bias`` and a cross layer's gates stay
    float32, as in the reference. ``trainable`` as in :func:`init_params`."""
    _check_family(cfg)
    dev = resolve_device(device)
    use_full_f32_matmul()

    def t(a, name="") -> torch.Tensor:
        a32 = np.array(a, dtype=np.float32)     # a writable copy
        dtype = torch.float32 if name in F32_LEAVES else cfg.param_dtype
        return torch.from_numpy(a32).to(device=dev, dtype=dtype)

    def group(node, i=None, name=""):
        if not isinstance(node, Mapping):
            return t(np.asarray(node) if i is None else np.asarray(node)[i],
                     name)
        return {k: group(v, i, k) for k, v in node.items()}

    classes = {"blocks": _block_class(cfg), "cross_blocks": CrossBlock,
               "enc_blocks": EncoderBlock}
    layers = {name: [classes[name](*(group(tree[name][g], i, g)
                                     for g in classes[name].groups()),
                                   trainable) for i in range(n)]
              for name, n in _layer_counts(cfg).items()}
    extra = {}
    if cfg.family == "hybrid":
        extra["shared_attn"] = SharedAttnBlock(
            *(group(tree["shared_attn"][g]) for g in SharedAttnBlock.GROUPS),
            trainable)
    if cfg.family == "vlm":
        extra["cross_blocks"] = layers["cross_blocks"]
    if cfg.family == "audio":
        extra["enc_blocks"] = layers["enc_blocks"]
        extra["enc_norm"] = group(tree["enc_norm"])
    return Transformer(cfg, t(tree["embed"]), group(tree["final_norm"]),
                       None if cfg.tie_embeddings else t(tree["lm_head"]),
                       layers["blocks"], trainable, **extra)


def params_to_numpy(params: Transformer) -> dict:
    """The reverse of :func:`params_from_numpy`: the reference's pytree
    layout as float32 numpy arrays, layer leaves stacked."""
    n = lambda x: x.detach().float().cpu().numpy()
    tree = {"embed": n(params.embed),
            "final_norm": {k: n(v) for k, v in params.final_norm.items()}}
    if params.lm_head is not None:
        tree["lm_head"] = n(params.lm_head)
    for name, blocks in params.stacked_groups().items():
        tree[name] = _stacked(blocks, lambda leaves: np.stack(
            [n(x) for x in leaves]))
    if params.shared_attn is not None:
        tree["shared_attn"] = {
            g: {k: n(v) for k, v in getattr(params.shared_attn, g).items()}
            for g in SharedAttnBlock.GROUPS}
    if params.enc_norm is not None:
        tree["enc_norm"] = {k: n(v) for k, v in params.enc_norm.items()}
    return tree


def param_tree(params: Transformer) -> dict:
    """The model's weights (the tensors themselves) in the reference's
    pytree layout, each stacked leaf as a list of its layers' tensors, so
    that ``repro_torch.tree.leaves`` walks them in the reference's leaf
    order (each reference leaf giving its L layers in turn): the tree that
    the port's ``AdamW`` updates in place."""
    tree = {"embed": params.embed, "final_norm": dict(params.final_norm)}
    if params.lm_head is not None:
        tree["lm_head"] = params.lm_head
    for name, blocks in params.stacked_groups().items():
        tree[name] = _stacked(blocks, list)
    if params.shared_attn is not None:
        tree["shared_attn"] = {g: dict(getattr(params.shared_attn, g))
                               for g in SharedAttnBlock.GROUPS}
    if params.enc_norm is not None:
        tree["enc_norm"] = dict(params.enc_norm)
    return tree


def _stacked(blocks, stack) -> dict:
    """The groups of ``blocks`` (one stacked group's layers) with each
    leaf given as ``stack`` of its layers' tensors (nested groups, the
    MoE's ``shared``, as nested dicts; a cross layer's gates as leaves)."""
    def walk(nodes):
        if isinstance(nodes[0], (Mapping, nn.ParameterDict)):
            return {k: walk([nd[k] for nd in nodes]) for k in nodes[0].keys()}
        return stack(nodes)

    return {group: walk([getattr(b, group) for b in blocks])
            for group in blocks[0].groups()}


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
    y, aux = p.ffn(_norm(h, p.norm2, cfg), cfg)
    h = h + y
    return (h, aux, kv) if return_kv else (h, aux)


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The absolute sinusoidal table, (..., d) float32 of ``positions``
    (...): sines then cosines of ``half = d // 2`` frequencies
    ``exp(-i * log(10000) / max(half - 1, 1))``, as the reference's."""
    half = d // 2
    # the float32 quotient, exact as a Python float: no copy to the card
    step = (torch.log(torch.tensor(10000.0)) / max(half - 1, 1)).item()
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) * step)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor) -> torch.Tensor:
    """Token embeddings in the compute dtype; a model without RoPE
    (whisper) adds the sinusoidal table at ``positions`` ((S,), or (B, 1)
    in decode)."""
    h = params.embed[tokens.long()].to(cfg.compute_dtype)
    if cfg.rope_theta is None:
        h = h + _sinusoidal(positions, cfg.d_model).to(h.dtype)
    return h


def _check_memory(cfg: ModelConfig, memory: Optional[torch.Tensor],
                  batch: int) -> None:
    """The vlm and audio families need a (B, n, d_model) memory of the
    config's ``n_image_tokens`` / ``encoder.n_frames`` entries (the
    reference's decode attends to exactly that many); the vlm's in the
    compute dtype (the reference would promote ``memory @ wk`` to float32,
    a product that ``torch.matmul`` refuses to mix). The other families
    take none."""
    if cfg.family not in MEMORY_FAMILIES:
        if memory is not None:
            raise ValueError(f"{cfg.name}: the {cfg.family!r} family takes "
                             f"no memory")
        return
    what = "image" if cfg.family == "vlm" else "frame"
    n = cfg.n_image_tokens if cfg.family == "vlm" else cfg.encoder.n_frames
    if memory is None:
        raise ValueError(f"{cfg.name}: the {cfg.family!r} family needs a "
                         f"memory of {n} {what} embeddings")
    if tuple(memory.shape) != (batch, n, cfg.d_model):
        raise ValueError(f"{cfg.name}: memory of shape {tuple(memory.shape)}"
                         f", expected {(batch, n, cfg.d_model)} ({n} {what} "
                         f"embeddings a row)")
    if cfg.family == "vlm" and memory.dtype != cfg.compute_dtype:
        raise ValueError(f"{cfg.name}: image embeddings in {memory.dtype}, "
                         f"expected the compute dtype {cfg.compute_dtype}")


def _run_encoder(params: Transformer, frames: torch.Tensor,
                 cfg: ModelConfig, *, attn_impl: str = "cuda"
                 ) -> torch.Tensor:
    """The audio encoder over the given frame embeddings (B, F, D): cast
    to the compute dtype, the sinusoidal table added, the non-causal
    encoder layers, ``enc_norm``."""
    h = frames.to(cfg.compute_dtype)
    pos = torch.arange(frames.shape[1], device=h.device)
    h = h + _sinusoidal(pos, cfg.d_model).to(h.dtype)
    for blk in params.enc_blocks:
        h = blk(h, cfg, pos, attn_impl=attn_impl)
    return _norm(h, params.enc_norm, cfg)


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
           positions: torch.Tensor, *, memory: Optional[torch.Tensor] = None,
           attn_impl: str = "cuda"):
    """The layer stack over full-sequence hidden states: ``(h, aux)``,
    the layers' auxiliary losses summed in float32 (zero for every family
    but moe). The hybrid family applies its shared block before each group
    of ``shared_attn_every`` Mamba layers; the vlm family a cross layer to
    ``memory`` (the image embeddings) before each group of self layers;
    the audio family attends to ``memory`` (the encoder's output) in every
    layer."""
    _check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    kw = dict(attn_impl=attn_impl)
    if cfg.family in ("ssm", "hybrid"):
        every = _shared_every(cfg)
        for i, blk in enumerate(params.blocks):
            if every and i % every == 0:
                h = _layer(lambda x: params.shared_attn(x, cfg, positions,
                                                        **kw), h)
            h = _layer(lambda x, blk=blk: blk(x, cfg), h)
        return h, aux
    if cfg.family == "vlm":
        _, per = _cross_groups(cfg)
        for c, cross in enumerate(params.cross_blocks):
            h = _layer(lambda x, cross=cross: cross(x, cfg, memory, **kw), h)
            for blk in params.blocks[c * per:(c + 1) * per]:
                h = _layer(lambda x, blk=blk: blk(x, cfg, positions,
                                                  **kw)[0], h)
        return h, aux
    if cfg.family == "audio":
        for blk in params.blocks:
            h = _layer(lambda x, blk=blk: blk(x, cfg, positions, memory,
                                              **kw), h)
        return h, aux
    for blk in params.blocks:
        h, a = _layer(lambda x, blk=blk: blk(x, cfg, positions, **kw), h)
        if a is not None:
            aux = aux + a.float()
    return h, aux


def forward_train(params: Transformer, tokens: torch.Tensor,
                  cfg: ModelConfig, *, memory: Optional[torch.Tensor] = None,
                  attn_impl: str = "cuda", mesh=None):
    """tokens (B, S) -> ``(logits (B, S, Vp), aux)`` with gradients, as the
    reference's ``forward_train``: ``aux`` is the MoE auxiliary loss summed
    over the layers in float32 (a zero scalar for the other families).
    ``memory`` is the vlm family's (B, n_image_tokens, D) image embeddings
    or the audio family's (B, n_frames, D) frame embeddings, which the
    encoder runs over first; the other families take none
    (:func:`_check_memory`). With ``mesh`` (a ``sharding.LLMMesh``) the
    params are this rank's blocks (``sharded.shard_model``), ``tokens``
    this rank's batch rows, and the logits those of its rows of the
    sequence (``models/sharded.py``; the dense family)."""
    if mesh is not None:
        return _mesh_path(cfg, "forward_train").forward_train(
            params, tokens, cfg, mesh, attn_impl=attn_impl)
    _check_family(cfg)
    _check_memory(cfg, memory, tokens.shape[0])
    positions = torch.arange(tokens.shape[1], device=params.device)
    h = _embed(params, tokens, cfg, positions)
    if cfg.family == "audio":
        memory = _run_encoder(params, memory, cfg, attn_impl=attn_impl)
    h, aux = _trunk(params, h, cfg, positions, memory=memory,
                    attn_impl=attn_impl)
    return _logits(params, h, cfg), aux


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            vocab: int, *, mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy in float32: logsumexp over the
    (padded, masked) vocabulary minus the target's logit. ``vocab`` is
    the reference's argument, unused there too. With ``mesh``, the mean
    over the global batch from a rank's logits (``forward_train(mesh=)``)
    and its batch rows' ``targets`` (``sharded.lm_loss``)."""
    if mesh is not None:
        from repro_torch.models import sharded
        return sharded.lm_loss(logits, targets, mesh)
    del vocab
    x = logits.float()
    logz = torch.logsumexp(x, dim=-1)
    tgt = torch.gather(x, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - tgt)


@torch.no_grad()
def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
            memory: Optional[torch.Tensor] = None,
            attn_impl: str = "cuda") -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, Vp): the logits of the reference's
    ``forward_train`` (``memory`` as there), without its auxiliary loss,
    and without gradients."""
    return forward_train(params, tokens, cfg, memory=memory,
                         attn_impl=attn_impl)[0]


# ---------------------------------------------------------------------------
# Decode caches: the scalar-pos API (prefill / decode_step) and the slot API
# of LLM serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Optional[Union[str, torch.device]] = None) -> Cache:
    """Family-aware decode state, as the reference's: a 0-d int32 ``pos``;
    the dense and moe families' ``self_kv``, (L, batch, T, KV, hd) K/V in
    the compute dtype; the ssm and hybrid families' ``conv`` (L, batch,
    d_conv - 1, conv channels) in the compute dtype and ``ssm`` (L, batch,
    heads, head_dim, d_state) in float32, and the hybrid's ``shared_kv``,
    one K/V per application of the shared block; the vlm family's
    ``self_kv`` of its self layers only and ``cross_kv``, (n_cross, batch,
    n_image_tokens, KV, hd), the audio family's ``self_kv`` and
    ``cross_kv`` (L, batch, n_frames, KV, hd), the cross K/V in the compute
    dtype, filled once by :func:`prefill`. ``max_len`` is the sequence
    horizon (a sliding-window model allocates only its window, a ring);
    ``device`` may be ``"meta"``."""
    _check_family(cfg)
    dev = _device(device)
    t = cfg.kv_cache_len(max_len)
    cache: Cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}

    def kv(layers: int, length: int = t) -> dict:
        shape = (layers, batch, length, cfg.n_kv_heads, cfg.hd)
        return {name: torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)
                for name in ("k", "v")}

    if cfg.family in ("dense", "moe"):
        cache["self_kv"] = kv(cfg.n_layers)
        return cache
    if cfg.family in MEMORY_FAMILIES:
        counts = _layer_counts(cfg)
        cache["self_kv"] = kv(counts["blocks"])
        cache["cross_kv"] = (
            kv(counts["cross_blocks"], max(cfg.n_image_tokens, 1))
            if cfg.family == "vlm" else kv(cfg.n_layers, cfg.encoder.n_frames))
        return cache
    din, gn, nh, k = SSM.mamba2_split_sizes(cfg)
    cache["conv"] = torch.zeros((cfg.n_layers, batch, k - 1, din + 2 * gn),
                                dtype=cfg.compute_dtype, device=dev)
    cache["ssm"] = torch.zeros(
        (cfg.n_layers, batch, nh, cfg.ssm.head_dim, cfg.ssm.d_state),
        dtype=torch.float32, device=dev)
    every = _shared_every(cfg)
    if every:
        cache["shared_kv"] = kv(cfg.n_layers // every)
    return cache


def _bulk_insert(kv: Mapping, layer: int, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int]) -> None:
    """Insert a layer's (B, S, KV, hd) prefill keys/values into its rows
    of the (L, B, T, KV, hd) cache, in place. A prompt longer than a
    window's ring keeps its last T positions, each at its ring slot
    (position % T), as the reference's reorder does."""
    t, s = kv["k"].shape[2], k.shape[1]
    if s > t:
        if window is None:
            raise ValueError(f"prompt of {s} tokens exceeds the KV cache "
                             f"length {t}")
        idx = torch.arange(s - t, s, device=k.device) % t
        kv["k"][layer][:, idx] = k[:, s - t:].to(kv["k"].dtype)
        kv["v"][layer][:, idx] = v[:, s - t:].to(kv["v"].dtype)
        return
    kv["k"][layer, :, :s] = k
    kv["v"][layer, :, :s] = v


def _conv_tail(conv_in: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The last (d_conv - 1) pre-activation conv inputs — carried into the
    decode conv state at prefill handoff. The reference projects the
    normed prompt through ``in_proj`` again for them; the port takes the
    block's own projection (``mamba2_block(..., return_conv_input=True)``)."""
    k = cfg.ssm.d_conv
    if conv_in.shape[1] < k - 1:
        raise ValueError(f"a prompt of {conv_in.shape[1]} tokens is shorter "
                         f"than the conv state's {k - 1}")
    return conv_in[:, conv_in.shape[1] - (k - 1):]


@torch.no_grad()
def prefill(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, *, memory: Optional[torch.Tensor] = None,
            attn_impl: str = "cuda", mesh=None):
    """Process the (B, S) prompts, build the decode cache for a horizon of
    ``max_len`` tokens, return ``(last-position logits (B, 1, Vp),
    cache)``, as the reference's ``prefill``: the full-sequence trunk
    (the flash kernel on the attention layers, which hand back their roped
    K/V), the K/V written into the cache (a ring for a window), the Mamba
    layers' final ``ssm`` state and ``conv`` tail carried, ``pos`` = S.
    ``memory`` as in :func:`forward_train`: the vlm family's cross layers
    and the audio family's decoder layers (after the encoder) project it
    once into ``cross_kv``. With ``mesh`` as in :func:`forward_train`:
    the cache is this rank's block of ``sharding.cache_pspecs``'s layout
    and the logits are every rank's, for its batch rows."""
    if mesh is not None:
        return _mesh_path(cfg, "prefill").prefill(
            params, tokens, cfg, max_len, mesh, attn_impl=attn_impl)
    _check_family(cfg)
    L._check_impl(attn_impl)
    b, s = tokens.shape
    _check_memory(cfg, memory, b)
    cache = init_cache(cfg, b, max_len, params.device)
    positions = torch.arange(s, device=params.device)

    def self_layer(i: int, h: torch.Tensor) -> torch.Tensor:
        h, _, (k, v) = params.blocks[i](h, cfg, positions,
                                        attn_impl=attn_impl, return_kv=True)
        _bulk_insert(cache["self_kv"], i, k, v, cfg.sliding_window)
        return h

    def cross_into(i: int, kv: tuple) -> None:
        cache["cross_kv"]["k"][i] = kv[0]
        cache["cross_kv"]["v"][i] = kv[1]

    with phase("llm_prefill"):
        h = _embed(params, tokens, cfg, positions)
        if cfg.family in ("dense", "moe"):
            for i in range(len(params.blocks)):
                h = self_layer(i, h)
        elif cfg.family == "vlm":
            _, per = _cross_groups(cfg)
            for c, cross in enumerate(params.cross_blocks):
                h, kv = cross(h, cfg, memory, attn_impl=attn_impl,
                              return_kv=True)
                cross_into(c, kv)
                for i in range(c * per, (c + 1) * per):
                    h = self_layer(i, h)
        elif cfg.family == "audio":
            enc = _run_encoder(params, memory, cfg, attn_impl=attn_impl)
            for i, blk in enumerate(params.blocks):
                h, (k, v), kv = blk(h, cfg, positions, enc,
                                    attn_impl=attn_impl, return_kv=True)
                _bulk_insert(cache["self_kv"], i, k, v, None)
                cross_into(i, kv)
        else:
            every = _shared_every(cfg)
            for i, blk in enumerate(params.blocks):
                if every and i % every == 0:
                    h, (k, v) = params.shared_attn(
                        h, cfg, positions, attn_impl=attn_impl,
                        return_kv=True)
                    _bulk_insert(cache["shared_kv"], i // every, k, v, None)
                h, cache["ssm"][i], cache["conv"][i] = blk(
                    h, cfg, return_state=True)
        cache["pos"].fill_(s)
        logits = _logits(params, h[:, -1:], cfg)
    return logits, cache


@torch.no_grad()
def decode_step(params: Transformer, token: torch.Tensor, cache: Cache,
                cfg: ModelConfig, *, attn_impl: str = "cuda", mesh=None):
    """token (B, 1) + cache -> ``(logits (B, 1, Vp), cache)``, every row at
    the cache's scalar ``pos``, as the reference's ``decode_step`` (a model
    without RoPE adds the sinusoidal table at ``pos``); the cache is
    updated in place (K/V rows, conv and ssm states, ``pos`` + 1; the
    cross K/V only read) and returned. Decode attention, over the self and
    the cross K/V, is plain PyTorch in float32 whatever ``attn_impl`` says
    (the reference's is plain jnp); the argument is checked so that both
    paths take the same arguments. With ``mesh`` the cache is the block
    that :func:`prefill` with the mesh gives (``models/sharded.py``)."""
    L._check_impl(attn_impl)
    if mesh is not None:
        return _mesh_path(cfg, "decode_step").decode_step(
            params, token, cache, cfg, mesh)
    _check_family(cfg)
    pos = cache["pos"]
    rows = pos.expand(token.shape[0])
    with phase("llm_decode"):
        h = _embed(params, token, cfg, rows[:, None])
        if cfg.family in ("dense", "moe"):
            h = _decode_layers(params, h, cache["self_kv"], rows, cfg)
        elif cfg.family == "vlm":
            _, per = _cross_groups(cfg)
            ckv = cache["cross_kv"]
            for c, cross in enumerate(params.cross_blocks):
                h = cross.decode(h, cfg, ckv["k"][c], ckv["v"][c])
                h = _decode_layers(params, h, cache["self_kv"], rows, cfg,
                                   range(c * per, (c + 1) * per))
        elif cfg.family == "audio":
            for i, blk in enumerate(params.blocks):
                h = blk.decode(h, cfg, cache["self_kv"], cache["cross_kv"],
                               i, pos)
        else:
            every = _shared_every(cfg)
            for i, blk in enumerate(params.blocks):
                if every and i % every == 0:
                    skv = cache["shared_kv"]
                    h = params.shared_attn.decode(
                        h, cfg, skv["k"][i // every], skv["v"][i // every],
                        pos)
                h, cache["conv"][i], cache["ssm"][i] = blk.decode(
                    h, cfg, cache["conv"][i], cache["ssm"][i])
        logits = _logits(params, h, cfg)
        pos += 1
    return logits, cache


def init_slot_cache(cfg: ModelConfig, slots: int, max_len: int,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Cache:
    """A pooled decode cache: batch dim = scheduler slots, per-slot
    ``pos`` (slots,). Dense/MoE only, as in the reference: the SSM and
    hybrid families' recurrent states and the VLM and audio families'
    cross K/V need per-slot handling that neither package has, and they
    serve through the scalar-pos API."""
    _check_family(cfg)
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"slot-scheduled serving supports dense/moe families; "
            f"{cfg.family!r} decode carries extra per-request state "
            f"(use repro_torch.launch.serve_llm --legacy-loop)")
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
    log = M.active_log()
    if log is not None:
        log.mark_real(positions < length)
    with phase("llm_prefill"):
        h = _embed(params, tokens, cfg, positions)
        for i, blk in enumerate(params.blocks):
            h, _, (k, v) = blk(h, cfg, positions, attn_impl=attn_impl,
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
    """One-token attention with per-row positions ``pos`` (B,): a slot
    pool's, or the scalar-pos API's one position expanded over the batch;
    writes each row's K/V into the layer's cache in place."""
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


def _cross_decode(p: Mapping, x: torch.Tensor, k_layer: torch.Tensor,
                  v_layer: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One token a row against a layer's (B, n_mem, KV, hd) cross K/V, every
    entry valid (the reference's ``_cross_decode``: q without bias, no
    RoPE)."""
    b = x.shape[0]
    q = (x @ p["wq"]).reshape(b, 1, cfg.n_heads, cfg.hd)
    out = L.decode_attention(q, k_layer, v_layer, k_layer.shape[1])
    return out.reshape(b, 1, cfg.n_heads * cfg.hd) @ p["wo"]


def _decode_layers(params: Transformer, h: torch.Tensor, kv: Mapping,
                   pos: torch.Tensor, cfg: ModelConfig,
                   layers: Optional[range] = None) -> torch.Tensor:
    """The dense and moe families' layers (the vlm family's self layers
    ``layers``) for one token a row at the per-row positions ``pos`` (B,),
    each layer's K/V written into ``kv`` in place."""
    for i in range(len(params.blocks)) if layers is None else layers:
        blk = params.blocks[i]
        h = h + _attn_decode_slots(blk.attn, _norm(h, blk.norm1, cfg),
                                   kv["k"][i], kv["v"][i], pos, cfg,
                                   cfg.rope_theta)
        # every row is routed, a free slot's too, as in the reference
        h = h + blk.ffn(_norm(h, blk.norm2, cfg), cfg)[0]
    return h


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
    log = M.active_log()
    if log is not None:
        log.mark_real(active)
    with phase("llm_decode"):
        h = _decode_layers(params, _embed(params, token, cfg, pos[:, None]),
                           cache["self_kv"], pos, cfg)
        logits = _logits(params, h, cfg)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        pos += active.to(device=pos.device, dtype=pos.dtype)
    return tok, logits, cache
