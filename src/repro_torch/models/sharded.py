"""The sharded dense step on the LLM mesh: ``forward_train``, the global
``lm_loss``, ``prefill`` and ``decode_step`` of one rank.

What the reference leaves to GSPMD (its dry run's ``build_step``: params
under ``param_pspecs``, the batch under ``batch_pspec``, the decode cache
under ``cache_pspecs``, the hidden states sequence-sharded over ``model``)
the port writes out, in a layout that works whatever the head counts (no
dense config has KV heads that 16 divides, and qwen2's 14 q heads do not
either, so the reference's own specs cut ``wk``/``wv`` inside heads):

* Parameters live on a rank as their block (:func:`shard_model`), and a
  layer gathers each of its weights whole just in time
  (``sharding.gather_weight``, scope ``"weights"``); with ``remat`` the
  recompute gathers again. The gather's backward sums the gradient onto
  the block (reduce-scatters) and all-reduces it over the axes the spec
  replicates the leaf on (scope ``"grads"``).
* Hidden states between layers, in training and prefill, are the batch
  rows of this rank's DP coordinates and, under ``run_options``'s
  ``act_sharding = P(dp, "model", None)``, the sequence rows [r S / tp,
  (r + 1) S / tp) of its model coordinate r; every layer computes on its
  own rows.
* Attention: the rank projects q, k and v of its rows, all-gathers k and v
  over ``model`` (``pmm3d.all_gather``, scope ``"kv"``) and attends with
  ``blockwise_attention(q_offset = r S / tp)`` over all S keys: the flash
  kernels' query offset. A causal shard does up to tp - 1 times more work
  on the last model rank than on the first, as the reference's layout.
* Loss: each rank sums its tokens' cross-entropy and all-reduces the sum
  over every axis (scope ``"loss"``); the mean over the global batch is
  the reference's ``lm_loss``.
* Decode: the cache is this rank's block of ``cache_pspecs`` (batch over
  DP; the KV heads, or the head dim, over ``model``). The new token's q,
  k and v come from the gathered weights; the rank writes its slice of k
  and v into its block, scores its slice (a head-dim slice's partial
  scores all-reduced over ``model``, scope ``"scores"``), and the
  outputs' slices are all-gathered over ``model`` (scope ``"scores"``).
  Decode attention is plain PyTorch in float32, as unsharded.

The batch rows are this rank's block over the DP axes
(``data.shard_batch_for_mesh``), so the global batch is the local one
times the DP size. Only the dense family runs here; the others raise and
name their ROADMAP item.
"""
from __future__ import annotations

import types
from typing import Mapping, Tuple

import torch

from repro_torch.core import pmm3d
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (LLMMesh, _all_reduce, _axes_size,
                                         _layer_spec, _names, all_reduce_sum,
                                         cache_pspecs, dp_axes, gather_weight,
                                         model_axis_size, param_pspecs, shard)
from repro_torch.obs import comm

ROADMAP_ITEM = "The sharded LLM step beyond the dense family"


def check_family(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what} over a mesh: the {cfg.family!r} family ({cfg.name}) is "
            f"not ported: ROADMAP queue 1, \"{ROADMAP_ITEM}\"")


def _dp_size(mesh: LLMMesh) -> int:
    return _axes_size(mesh, dp_axes(mesh))


def shard_model(params: TT.Transformer, mesh: LLMMesh, fsdp=None
                ) -> TT.Transformer:
    """``params`` in place, each weight replaced by this rank's block under
    ``param_pspecs`` (``fsdp`` None: above 3e9 parameters, as the
    reference's dry run); the specs are kept as ``params.mesh_specs``."""
    cfg = params.cfg
    check_family(cfg, "shard_model")
    if fsdp is None:
        fsdp = cfg.num_params() > 3e9
    tree = TT.param_tree(params)
    specs = param_pspecs(cfg, mesh, tree, fsdp)
    blocks = shard(tree, specs, mesh)

    def put(node, blk):
        if isinstance(node, dict):
            for k in node:
                put(node[k], blk[k])
        elif isinstance(node, list):
            for p, b in zip(node, blk):
                p.data = b
        else:
            node.data = blk
    put(tree, blocks)
    params.mesh_specs = specs
    return params


def _specs(params: TT.Transformer):
    specs = getattr(params, "mesh_specs", None)
    if specs is None:
        raise ValueError("the params hold whole weights: cut them to this "
                         "rank's blocks first (sharded.shard_model)")
    return specs


def _gather(group: Mapping, specs: Mapping, mesh: LLMMesh,
            stacked: bool) -> dict:
    """A parameter group's weights, gathered whole."""
    return {k: gather_weight(v, _layer_spec(specs[k]) if stacked
                             else specs[k], mesh)
            for k, v in group.items()}


def seq_layout(mesh: LLMMesh, s: int) -> Tuple[int, int, int]:
    """(shards, first row, rows) of this rank's part of an S-token
    sequence: the model coordinate's block under ``run_options``'s
    ``act_sharding`` when it puts the sequence on ``model`` and S divides,
    else the whole sequence (1, 0, S)."""
    act = TT.run_opts().act_sharding
    tp = model_axis_size(mesh)
    if act is None or len(act) < 2 or "model" not in _names(act[1]) \
            or s % tp:
        return 1, 0, s
    rows = s // tp
    return tp, mesh.coords["model"] * rows, rows


def _head(params: TT.Transformer, mesh: LLMMesh, what: Tuple[str, ...]):
    """A stand-in for the model in ``TT._embed`` / ``TT._logits`` holding
    the gathered ``what`` of ``embed``, ``lm_head`` and ``final_norm``."""
    sp = _specs(params)
    ns = types.SimpleNamespace()
    for name in what:
        if name == "final_norm":
            ns.final_norm = _gather(params.final_norm, sp["final_norm"], mesh,
                                    False)
        elif name == "lm_head" and params.lm_head is None:
            ns.lm_head = None
        else:
            setattr(ns, name, gather_weight(getattr(params, name), sp[name],
                                            mesh))
    return ns


def _embed(params, tokens, cfg, positions, mesh):
    return TT._embed(_head(params, mesh, ("embed",)), tokens, cfg, positions)


def _logits(params, h, cfg, mesh):
    names = ("final_norm", "embed") if cfg.tie_embeddings \
        else ("final_norm", "lm_head")
    ns = _head(params, mesh, names)
    if not cfg.tie_embeddings:
        ns.embed = None
    return TT._logits(ns, h, cfg)


def _layer(blk, bspecs: Mapping, x: torch.Tensor, cfg: ModelConfig,
           mesh: LLMMesh, positions: torch.Tensor, layout: tuple,
           attn_impl: str):
    """One dense layer over this rank's rows ``x`` (B, rows, D):
    ``(h, (k, v))``, the K/V of the whole sequence, roped."""
    n_seq, off, rows = layout
    w = {g: _gather(getattr(blk, g), bspecs[g], mesh, True)
         for g in blk.groups()}
    b = x.shape[0]
    q, k, v = L.attn_project_qkv(w["attn"], TT._norm(x, w["norm1"], cfg),
                                 cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    if cfg.rope_theta is not None:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    if n_seq > 1:
        model = mesh.axis("model")
        with comm.scope("kv"):
            k = pmm3d.all_gather(k.contiguous(), model, 1)
            v = pmm3d.all_gather(v.contiguous(), model, 1)
    out = L.blockwise_attention(q, k, v, causal=True,
                                window=cfg.sliding_window, q_offset=off,
                                attn_impl=attn_impl)
    h = x + out.reshape(b, rows, cfg.n_heads * cfg.hd) @ w["attn"]["wo"]
    h = h + L.mlp_block(w["mlp"], TT._norm(h, w["norm2"], cfg), cfg.mlp)
    return h, (k, v)


def forward_train(params: TT.Transformer, tokens: torch.Tensor,
                  cfg: ModelConfig, mesh: LLMMesh, *,
                  attn_impl: str = "cuda"):
    """This rank's batch rows ``tokens`` (B, S) -> ``(logits (B, rows,
    Vp) of its sequence rows, aux = 0)``, with gradients to its blocks."""
    check_family(cfg, "forward_train")
    sp = _specs(params)
    layout = seq_layout(mesh, tokens.shape[1])
    _, off, rows = layout
    positions = torch.arange(off, off + rows, device=params.device)
    h = _embed(params, tokens[:, off:off + rows], cfg, positions, mesh)
    for blk in params.blocks:
        h = TT._layer(lambda x, blk=blk: _layer(
            blk, sp["blocks"], x, cfg, mesh, positions, layout,
            attn_impl)[0], h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _logits(params, h, cfg, mesh), aux


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            mesh: LLMMesh) -> torch.Tensor:
    """The reference's ``lm_loss`` over the global batch from one rank:
    ``logits`` of its rows (``forward_train``) and its batch rows'
    ``targets`` (B, S). Its tokens' summed cross-entropy over the global
    token count (times the model ranks that hold the same rows, when the
    sequence is not sharded) is all-reduced over every axis (scope
    ``"loss"``); the value is the global mean, the gradient this rank's
    share, which the weights' gathers sum over the ranks."""
    b, s = targets.shape
    n_seq, off, rows = seq_layout(mesh, s)
    tg = targets[:, off:off + rows].long()
    x = logits.float()
    part = (torch.logsumexp(x, dim=-1)
            - torch.gather(x, -1, tg[..., None])[..., 0]).sum()
    part = part / (b * _dp_size(mesh) * s * (model_axis_size(mesh)
                                             // n_seq))
    total = all_reduce_sum(part, mesh, "loss")
    return part + (total - part).detach()


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

def _block_shape(shape, spec, mesh: LLMMesh) -> Tuple[int, ...]:
    return tuple(n // mesh.index(e)[1] if e is not None else n
                 for n, e in zip(shape, spec))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               mesh: LLMMesh) -> TT.Cache:
    """This rank's block of the decode cache of its ``batch`` rows (the
    global batch is ``batch`` times the DP size), zeros on the mesh's
    device, laid out by ``cache_pspecs``."""
    check_family(cfg, "init_cache")
    glob = batch * _dp_size(mesh)
    kv_shape = (cfg.n_layers, glob, cfg.kv_cache_len(max_len),
                cfg.n_kv_heads, cfg.hd)
    shapes = {"pos": types.SimpleNamespace(shape=()), "self_kv": {
        n: types.SimpleNamespace(shape=kv_shape) for n in ("k", "v")}}
    specs = cache_pspecs(cfg, mesh, shapes, glob)
    return {"pos": torch.zeros((), dtype=torch.int32, device=mesh.device),
            "self_kv": {n: torch.zeros(
                _block_shape(kv_shape, specs["self_kv"][n], mesh),
                dtype=cfg.compute_dtype, device=mesh.device)
                for n in ("k", "v")}}


def _kv_slice(cfg: ModelConfig, kv_block: torch.Tensor, mesh: LLMMesh):
    """Which dim of a (.., KV, hd) K/V this rank's cache block cuts (3 for
    the KV heads, 4 for the head dim, None), and the slice of it."""
    kvl, hdl = kv_block.shape[-2], kv_block.shape[-1]
    r = mesh.coords["model"]
    if kvl < cfg.n_kv_heads:
        return "heads", slice(r * kvl, (r + 1) * kvl)
    if hdl < cfg.hd:
        return "hd", slice(r * hdl, (r + 1) * hdl)
    return None, slice(None)


def _cache_kv(cfg, k, v, kv_block, mesh):
    """This rank's part of K/V (B, S, KV, hd) for its cache block."""
    cut, sl = _kv_slice(cfg, kv_block, mesh)
    if cut == "heads":
        return k[:, :, sl], v[:, :, sl]
    if cut == "hd":
        return k[..., sl], v[..., sl]
    return k, v


@torch.no_grad()
def prefill(params: TT.Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, mesh: LLMMesh, *, attn_impl: str = "cuda"):
    """This rank's batch rows (B, S) of the prompts -> ``(last-position
    logits (B, 1, Vp), cache block)``: the training trunk, each layer's
    gathered K/V cut to the cache block, ``pos`` = S; the last position's
    hidden state is all-gathered from the last model rank (scope
    ``"kv"``)."""
    check_family(cfg, "prefill")
    sp = _specs(params)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, mesh)
    kv = cache["self_kv"]
    layout = seq_layout(mesh, s)
    n_seq, off, rows = layout
    positions = torch.arange(off, off + rows, device=params.device)
    h = _embed(params, tokens[:, off:off + rows], cfg, positions, mesh)
    for i, blk in enumerate(params.blocks):
        h, (k, v) = _layer(blk, sp["blocks"], h, cfg, mesh, positions,
                           layout, attn_impl)
        TT._bulk_insert(kv, i, *_cache_kv(cfg, k, v, kv["k"], mesh),
                        cfg.sliding_window)
    cache["pos"].fill_(s)
    last = h[:, -1:]
    if n_seq > 1:
        with comm.scope("kv"):
            last = pmm3d.all_gather(last.contiguous(), mesh.axis("model"),
                                    1)[:, -1:]
    return _logits(params, last, cfg, mesh), cache


def _decode_attention(cfg: ModelConfig, q, k, v, k_layer, v_layer, pos,
                      mesh: LLMMesh) -> torch.Tensor:
    """One token a row against this rank's cache block, its new k and v
    written at ``pos`` first: (B, 1, H, hd) in q's type."""
    b = q.shape[0]
    t = k_layer.shape[1]
    cut, sl = _kv_slice(cfg, k_layer, mesh)
    kl, vl = _cache_kv(cfg, k, v, k_layer, mesh)
    idx = (pos % t if cfg.sliding_window is not None
           else torch.clamp(pos, max=t - 1)).long()
    k_layer.index_copy_(1, idx.view(1), kl.to(k_layer.dtype))
    v_layer.index_copy_(1, idx.view(1), vl.to(v_layer.dtype))
    if cut == "heads":                   # this rank's kv heads' q heads
        g = cfg.n_heads // cfg.n_kv_heads
        ql = q[:, :, sl.start * g:sl.stop * g]
    elif cut == "hd":
        ql = q[..., sl]
    else:
        ql = q
    if cut != "hd":
        out = L.decode_attention(ql.contiguous(), k_layer, v_layer, pos + 1)
    else:                # partial scores over this rank's head-dim slice
        kvh = k_layer.shape[2]
        qg = ql.reshape(b, kvh, cfg.n_heads // kvh, -1).float()
        s = torch.einsum("bkgd,btkd->bkgt", qg, k_layer.float()) \
            * cfg.hd ** -0.5
        with comm.scope("scores"):
            s = _all_reduce(s, mesh.axis("model"))
        valid = torch.arange(t, device=q.device) < torch.clamp(pos + 1,
                                                               max=t)
        p = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)
        out = torch.einsum("bkgt,btkd->bkgd", p, v_layer.float()).reshape(
            b, 1, cfg.n_heads, -1).to(q.dtype)
    if cut is None:
        return out
    with comm.scope("scores"):
        return pmm3d.all_gather(out.contiguous(), mesh.axis("model"),
                                2 if cut == "heads" else 3)


@torch.no_grad()
def decode_step(params: TT.Transformer, token: torch.Tensor, cache: TT.Cache,
                cfg: ModelConfig, mesh: LLMMesh):
    """This rank's rows (B, 1) + its cache block -> ``(logits (B, 1, Vp),
    cache)``, the block updated in place and ``pos`` + 1."""
    check_family(cfg, "decode_step")
    sp = _specs(params)
    pos = cache["pos"]
    b = token.shape[0]
    rows = pos.expand(b)[:, None]
    h = _embed(params, token, cfg, rows, mesh)
    kv = cache["self_kv"]
    for i, blk in enumerate(params.blocks):
        w = {g: _gather(getattr(blk, g), sp["blocks"][g], mesh, True)
             for g in blk.groups()}
        q, k, v = L.attn_project_qkv(w["attn"], TT._norm(h, w["norm1"], cfg),
                                     cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        if cfg.rope_theta is not None:
            q = L.rope(q, rows, cfg.rope_theta)
            k = L.rope(k, rows, cfg.rope_theta)
        out = _decode_attention(cfg, q, k, v, kv["k"][i], kv["v"][i], pos,
                                mesh)
        h = h + out.reshape(b, 1, cfg.n_heads * cfg.hd) @ w["attn"]["wo"]
        h = h + L.mlp_block(w["mlp"], TT._norm(h, w["norm2"], cfg), cfg.mlp)
    logits = _logits(params, h, cfg, mesh)
    pos += 1
    return logits, cache
