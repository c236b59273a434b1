"""Decoder-only language models: init, weights from the reference, the
full-sequence forward (for serving and, with gradients, for training), the
LM loss, the scalar-pos decode cache (``prefill`` / ``decode_step``) and
the slot-indexed KV cache of LLM serving.

Counterpart of ``repro/models/transformer.py`` for the ``dense`` family
(llama-style: pre-norm attention and MLP blocks, RoPE, GQA; qwen2's QKV
bias and tied embeddings), the ``moe`` family (mixtral, llama4-scout: the
MLP replaced by ``models/moe.py``'s capacity-dispatched experts), the
``ssm`` family (mamba2: pre-norm Mamba2 blocks of ``models/ssm.py``) and
the ``hybrid`` family (zamba2: Mamba2 blocks with one weight-shared
attention and MLP block applied before every ``shared_attn_every`` of
them). The ``vlm`` and ``audio`` families raise ``NotImplementedError``
naming their ROADMAP item.

The model is an ``nn.Module`` (:class:`Transformer`) holding one
:class:`DenseBlock` (:class:`MoEBlock`, :class:`MambaBlock`) per layer,
and zamba2's :class:`SharedAttnBlock` once, where the reference stacks
every layer leaf with a leading L dim and scans over it; the public
functions keep the reference's names and arguments (``params`` is the
module). Weights carry no gradient unless built with ``trainable=True``;
:func:`param_tree` lays them out in the reference's pytree order for the
optimizer.

Full-sequence attention goes through the CUDA flash kernels, forward and
backward (``attn_impl="cuda"``, the default), or their plain versions
(``attn_impl="torch"``); decode attention is plain PyTorch in float32 on
both. Unlike the reference, which returns a new cache, the decode caches
are updated in place: :func:`decode_step`, :func:`prefill_into_slot` and
:func:`decode_step_slots` write into ``cache`` and return that same dict
(:func:`prefill` returns the cache it filled).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device, use_full_f32_matmul
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.obs import phase

Cache = Dict[str, Any]

LLM_ITEM = '"The LLM stack beyond the dense serving path"'

FAMILIES = ("dense", "moe", "ssm", "hybrid")

# the part of ROADMAP queue 1, "The LLM stack beyond the dense serving
# path", that ports each other family
_FAMILY_TODO = {
    "vlm": "VLM and audio",
    "audio": "VLM and audio",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet: ROADMAP queue 1, "
            f'{LLM_ITEM} ({_FAMILY_TODO.get(cfg.family, cfg.family)})')


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


def _block_class(cfg: ModelConfig) -> type:
    return {"moe": MoEBlock, "ssm": MambaBlock,
            "hybrid": MambaBlock}.get(cfg.family, DenseBlock)


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


class Transformer(nn.Module):
    """The model: embedding, the blocks, the final norm and the LM head
    (absent with tied embeddings), and the hybrid family's shared block.
    With ``trainable`` every weight requires grad (the blocks are built
    with the same flag)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 final_norm: Mapping, lm_head: Optional[torch.Tensor],
                 blocks: list, trainable: bool = False,
                 shared_attn: Optional[SharedAttnBlock] = None):
        super().__init__()
        _check_family(cfg)
        if (shared_attn is None) != (cfg.family != "hybrid"):
            raise ValueError("a shared attention block goes with the hybrid "
                             "family, and only with it")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=trainable)
        self.final_norm = _pdict(final_norm, trainable)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=trainable))
        self.blocks = nn.ModuleList(blocks)
        self.shared_attn = shared_attn

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
    ``trainable`` makes every weight require grad."""
    _check_family(cfg)
    dev = resolve_device(device)
    use_full_f32_matmul()
    d, vp, f = cfg.d_model, cfg.vocab_padded, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd

    def dense(*shape, scale=0.02):
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

    embed = dense(vp, d)
    lm_head = None if cfg.tie_embeddings else dense(d, vp)
    blocks = []
    for _ in range(cfg.n_layers):
        if cfg.family in ("ssm", "hybrid"):
            blocks.append(MambaBlock(mamba(), _norm_leaves(cfg, d, dev),
                                     trainable))
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
        blocks.append(_block_class(cfg)(
            attn(), _norm_leaves(cfg, d, dev), _norm_leaves(cfg, d, dev), ffn,
            trainable))
    shared = None
    if cfg.family == "hybrid":
        shared = SharedAttnBlock(attn(), _norm_leaves(cfg, d, dev), mlp(),
                                 _norm_leaves(cfg, d, dev), trainable)
    return Transformer(cfg, embed, _norm_leaves(cfg, d, dev), lm_head,
                       blocks, trainable, shared)


def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device: Optional[Union[str, torch.device]] = None, *,
                      trainable: bool = False) -> Transformer:
    """The model holding the values of the reference's parameter pytree,
    given as numpy arrays: ``embed``, ``final_norm``, ``lm_head`` (unless
    tied) and ``blocks.{attn, norm1, norm2, mlp}`` stacked with a leading
    L dim, with ``blocks.moe.{router, wg, wu, wd, shared.{wg, wu, wd}}``
    in place of ``mlp`` for the ``moe`` family, ``blocks.{mamba, norm}``
    for the ``ssm`` and ``hybrid`` families and, for ``hybrid``, the
    unstacked ``shared_attn.{attn, norm, mlp, norm2}``. A bfloat16 leaf
    becomes float32 exactly, and the cast to ``cfg.param_dtype`` gives
    back the same bits; a Mamba block's ``a_log``, ``d_skip`` and
    ``dt_bias`` stay float32, as in the reference. ``trainable`` as in
    :func:`init_params`."""
    _check_family(cfg)
    dev = resolve_device(device)
    use_full_f32_matmul()

    def t(a, name="") -> torch.Tensor:
        a32 = np.array(a, dtype=np.float32)     # a writable copy
        dtype = torch.float32 if name in SSM.F32_LEAVES else cfg.param_dtype
        return torch.from_numpy(a32).to(device=dev, dtype=dtype)

    def group(node, i=None):
        return {k: group(v, i) if isinstance(v, Mapping)
                else t(np.asarray(v) if i is None else np.asarray(v)[i], k)
                for k, v in node.items()}

    blk, block = tree["blocks"], _block_class(cfg)
    blocks = [block(*(group(blk[g], i) for g in block.groups()), trainable)
              for i in range(cfg.n_layers)]
    shared = None
    if cfg.family == "hybrid":
        shared = SharedAttnBlock(*(group(tree["shared_attn"][g])
                                   for g in SharedAttnBlock.GROUPS),
                                 trainable)
    return Transformer(cfg, t(tree["embed"]), group(tree["final_norm"]),
                       None if cfg.tie_embeddings else t(tree["lm_head"]),
                       blocks, trainable, shared)


def params_to_numpy(params: Transformer) -> dict:
    """The reverse of :func:`params_from_numpy`: the reference's pytree
    layout as float32 numpy arrays, layer leaves stacked."""
    n = lambda x: x.detach().float().cpu().numpy()
    tree = {"embed": n(params.embed),
            "final_norm": {k: n(v) for k, v in params.final_norm.items()}}
    if params.lm_head is not None:
        tree["lm_head"] = n(params.lm_head)
    tree["blocks"] = _stacked(params, lambda leaves: np.stack(
        [n(x) for x in leaves]))
    if params.shared_attn is not None:
        tree["shared_attn"] = {
            g: {k: n(v) for k, v in getattr(params.shared_attn, g).items()}
            for g in SharedAttnBlock.GROUPS}
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
    tree["blocks"] = _stacked(params, list)
    if params.shared_attn is not None:
        tree["shared_attn"] = {g: dict(getattr(params.shared_attn, g))
                               for g in SharedAttnBlock.GROUPS}
    return tree


def _stacked(params: Transformer, stack) -> dict:
    """The blocks' groups with each leaf given as ``stack`` of its layers'
    tensors (nested groups, the MoE's ``shared``, as nested dicts)."""
    def walk(nodes):
        if isinstance(nodes[0], (Mapping, nn.ParameterDict)):
            return {k: walk([nd[k] for nd in nodes]) for k in nodes[0].keys()}
        return stack(nodes)

    return {group: walk([getattr(b, group) for b in params.blocks])
            for group in params.blocks[0].groups()}


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
           positions: torch.Tensor, *, attn_impl: str = "cuda"):
    """The layer stack over full-sequence hidden states: ``(h, aux)``,
    the layers' auxiliary losses summed in float32 (zero for the dense,
    ssm and hybrid families). The hybrid family applies its shared block
    before each group of ``shared_attn_every`` Mamba layers."""
    _check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family in ("ssm", "hybrid"):
        every = _shared_every(cfg)
        for i, blk in enumerate(params.blocks):
            if every and i % every == 0:
                h = params.shared_attn(h, cfg, positions,
                                       attn_impl=attn_impl)
            h = blk(h, cfg)
        return h, aux
    for blk in params.blocks:
        h, a = blk(h, cfg, positions, attn_impl=attn_impl)
        if a is not None:
            aux = aux + a.float()
    return h, aux


def forward_train(params: Transformer, tokens: torch.Tensor,
                  cfg: ModelConfig, *, memory: Optional[torch.Tensor] = None,
                  attn_impl: str = "cuda"):
    """tokens (B, S) -> ``(logits (B, S, Vp), aux)`` with gradients, as the
    reference's ``forward_train``: ``aux`` is the MoE auxiliary loss summed
    over the layers in float32 (a zero scalar for the other families).
    ``memory`` (image embeddings or encoder frames) belongs to families not
    ported yet and raises."""
    if memory is not None:
        raise NotImplementedError(
            f"forward_train: memory is for the families not ported yet: "
            f"ROADMAP queue 1, {LLM_ITEM} (VLM and audio)")
    positions = torch.arange(tokens.shape[1], device=params.device)
    h, aux = _trunk(params, _embed(params, tokens, cfg), cfg, positions,
                    attn_impl=attn_impl)
    return _logits(params, h, cfg), aux


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            vocab: int) -> torch.Tensor:
    """Mean next-token cross-entropy in float32: logsumexp over the
    (padded, masked) vocabulary minus the target's logit. ``vocab`` is
    the reference's argument, unused there too."""
    del vocab
    x = logits.float()
    logz = torch.logsumexp(x, dim=-1)
    tgt = torch.gather(x, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - tgt)


@torch.no_grad()
def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
            attn_impl: str = "cuda") -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, Vp): the logits of the reference's
    ``forward_train``, without its auxiliary loss, and without
    gradients."""
    return forward_train(params, tokens, cfg, attn_impl=attn_impl)[0]


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
    one K/V per application of the shared block. ``max_len`` is the
    sequence horizon (a sliding-window model allocates only its window, a
    ring)."""
    _check_family(cfg)
    dev = resolve_device(device)
    t = cfg.kv_cache_len(max_len)
    cache: Cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}

    def kv(layers: int) -> dict:
        shape = (layers, batch, t, cfg.n_kv_heads, cfg.hd)
        return {name: torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)
                for name in ("k", "v")}

    if cfg.family in ("dense", "moe"):
        cache["self_kv"] = kv(cfg.n_layers)
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
            attn_impl: str = "cuda"):
    """Process the (B, S) prompts, build the decode cache for a horizon of
    ``max_len`` tokens, return ``(last-position logits (B, 1, Vp),
    cache)``, as the reference's ``prefill``: the full-sequence trunk
    (the flash kernel on the attention layers, which hand back their roped
    K/V), the K/V written into the cache (a ring for a window), the Mamba
    layers' final ``ssm`` state and ``conv`` tail carried, ``pos`` = S.
    ``memory`` belongs to the families not ported yet and raises."""
    _check_family(cfg)
    L._check_impl(attn_impl)
    if memory is not None:
        raise NotImplementedError(
            f"prefill: memory is for the families not ported yet: ROADMAP "
            f"queue 1, {LLM_ITEM} (VLM and audio)")
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, params.device)
    positions = torch.arange(s, device=params.device)
    with phase("llm_prefill"):
        h = _embed(params, tokens, cfg)
        if cfg.family in ("dense", "moe"):
            for i, blk in enumerate(params.blocks):
                h, _, (k, v) = blk(h, cfg, positions, attn_impl=attn_impl,
                                   return_kv=True)
                _bulk_insert(cache["self_kv"], i, k, v, cfg.sliding_window)
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
                cfg: ModelConfig, *, attn_impl: str = "cuda"):
    """token (B, 1) + cache -> ``(logits (B, 1, Vp), cache)``, every row at
    the cache's scalar ``pos``, as the reference's ``decode_step``; the
    cache is updated in place (K/V rows, conv and ssm states, ``pos`` + 1)
    and returned. Decode attention is plain PyTorch in float32 whatever
    ``attn_impl`` says (the reference's is plain jnp); the argument is
    checked so that both paths take the same arguments."""
    L._check_impl(attn_impl)
    _check_family(cfg)
    pos = cache["pos"]
    with phase("llm_decode"):
        h = _embed(params, token, cfg)
        if cfg.family in ("dense", "moe"):
            h = _decode_layers(params, h, cache["self_kv"],
                               pos.expand(h.shape[0]), cfg)
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
    hybrid families' recurrent states need per-slot handling that neither
    package has, and they serve through the scalar-pos API."""
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
        h = _embed(params, tokens, cfg)
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


def _decode_layers(params: Transformer, h: torch.Tensor, kv: Mapping,
                   pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The dense and moe families' layers for one token a row at the
    per-row positions ``pos`` (B,), each layer's K/V written into ``kv``
    in place."""
    for i, blk in enumerate(params.blocks):
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
        h = _decode_layers(params, _embed(params, token, cfg),
                           cache["self_kv"], pos, cfg)
        logits = _logits(params, h, cfg)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        pos += active.to(device=pos.device, dtype=pos.dtype)
    return tok, logits, cache
