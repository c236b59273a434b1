"""The paper's GNN model (§III): GCN with input projection, L layers of
[SpMM -> GEMM -> RMSNorm -> ReLU -> Dropout -> Residual], output head.

Counterpart of ``repro/core/gcn_model.py``: the single-device model over a
dense mini-batch adjacency. Parameters are a plain dict of tensors in the
JAX layout — weights are ``(fan_in, fan_out)`` and used as ``x @ w`` — so
carrying weights across from the JAX package is a copy
(:func:`params_from_numpy`), not a transpose.

The dense products (``x @ w_in``, ``agg @ w``, ``h @ w_out`` and a dense
``adj @ h``) are plain ``torch.matmul``, as the JAX package leaves them to
XLA. The aggregation follows ``spmm_impl``: a dense ``(B, B)`` block, a
block-ELL ``(tiles, colidx)`` pair through the SpMM kernel (``"ell"``), or
a ``(rp, ci, val)`` CSR triple over the whole graph (``"csr"``, full-graph
eval — the reference's ``ForwardEngine`` backend of that name). The layer
tail is the fused CUDA kernel when ``elementwise_impl="cuda"``. Both
kernels carry autograd rules (``kernels/ops.py``), so the model trains.
:func:`sage_forward` runs the same network over a GraphSAGE batch
(``core/baselines.py``).

Every architectural component can be toggled (paper §III-A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    d_in: int
    d_hidden: int
    num_layers: int
    num_classes: int
    dropout: float = 0.3
    use_rmsnorm: bool = True
    use_residual: bool = True
    use_relu: bool = True
    rms_eps: float = 1e-6
    # kernel selection: "torch" (plain ops) or "cuda" (fused tail kernel)
    elementwise_impl: str = "torch"
    spmm_impl: str = "dense"      # "dense" | "ell" (block-ELL kernel) | "csr"

    def __post_init__(self):
        if self.elementwise_impl not in ("torch", "cuda"):
            raise ValueError(
                f"elementwise_impl={self.elementwise_impl!r}: 'torch' | 'cuda'")
        if self.spmm_impl not in ("dense", "ell", "csr"):
            raise ValueError(
                f"spmm_impl={self.spmm_impl!r}: 'dense' | 'ell' | 'csr'")


Params = Dict[str, Any]


def init_params(cfg: GCNConfig, generator: torch.Generator,
                device: Union[str, torch.device, None] = None) -> Params:
    """Glorot-initialized parameters for the §III model, drawn on the CPU
    from ``generator`` and placed on ``device`` (the card by default)."""
    dev = resolve_device(device)

    def glorot(fan_in, fan_out):
        scale = float(np.sqrt(2.0 / (fan_in + fan_out)))
        w = scale * torch.randn((fan_in, fan_out), generator=generator,
                                dtype=torch.float32)
        return w.to(dev)

    w_in = glorot(cfg.d_in, cfg.d_hidden)                          # Eq. 4
    w_out = glorot(cfg.d_hidden, cfg.num_classes)                  # Eq. 11
    layers = [{"w": glorot(cfg.d_hidden, cfg.d_hidden),           # Eq. 6
               "rms_scale": torch.ones(cfg.d_hidden, device=dev)}  # Eq. 7
              for _ in range(cfg.num_layers)]
    return {"w_in": w_in, "w_out": w_out, "layers": layers}


def params_from_numpy(tree: Params,
                      device: Union[str, torch.device, None] = None
                      ) -> Params:
    """The JAX param pytree (``{"w_in", "w_out", "layers": [{"w",
    "rms_scale"}, ...]}``, as numpy arrays) as the port's params on
    ``device`` (the card by default)."""
    dev = resolve_device(device)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return {"w_in": t(tree["w_in"]), "w_out": t(tree["w_out"]),
            "layers": [{"w": t(layer["w"]), "rms_scale": t(layer["rms_scale"])}
                       for layer in tree["layers"]]}


def params_to(params: Params, device: torch.device) -> Params:
    """The same params with every tensor on ``device``."""
    return {"w_in": params["w_in"].to(device),
            "w_out": params["w_out"].to(device),
            "layers": [{k: v.to(device) for k, v in layer.items()}
                       for layer in params["layers"]]}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Eq. 7 — root-mean-square normalization over the feature dim."""
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * scale


def _elementwise_tail(x: torch.Tensor, residual: torch.Tensor,
                      scale: torch.Tensor, cfg: GCNConfig,
                      keep_mask: Optional[torch.Tensor],
                      train: bool,
                      key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm -> ReLU -> Dropout -> Residual (Eqs. 7-10). Dropout applies
    when training with ``cfg.dropout > 0`` and a keep-mask or a dropout key
    is given (the JAX model draws from its dropout key; the port is handed
    the mask, or the 0-d int64 key of ``counter_rng.keep_mask``, which the
    fused tail draws from in its kernels and the plain tail through that
    function)."""
    dropping = train and cfg.dropout > 0
    mask = keep_mask if dropping else None
    key = key if dropping else None
    if cfg.elementwise_impl == "cuda":
        from repro_torch.kernels import ops as kops
        return kops.fused_layer_tail(
            x, residual if cfg.use_residual else None, scale,
            dropout_mask=mask, dropout_key=key, dropout_rate=cfg.dropout,
            eps=cfg.rms_eps, use_rmsnorm=cfg.use_rmsnorm,
            use_relu=cfg.use_relu)
    if key is not None:
        from repro_torch.kernels import counter_rng as crng
        mask = crng.keep_mask(key, x.shape[0], x.shape[-1], cfg.dropout)

    h = rmsnorm(x, scale, cfg.rms_eps) if cfg.use_rmsnorm else x
    if cfg.use_relu:
        h = torch.relu(h)                                          # Eq. 8
    if mask is not None:
        h = torch.where(mask, h / (1.0 - cfg.dropout),
                        torch.zeros_like(h))                       # Eq. 9
    if cfg.use_residual:
        h = h + residual                                           # Eq. 10
    return h


def _spmm(adj, x: torch.Tensor, cfg: GCNConfig) -> torch.Tensor:
    """Eq. 5 — neighborhood aggregation in the ``cfg.spmm_impl`` format."""
    if cfg.spmm_impl == "ell":
        from repro_torch.kernels import ops as kops
        return kops.spmm_ell(*adj, x)
    if cfg.spmm_impl == "csr":
        from repro_torch.core.pmm3d import csr_spmm_local
        rp, ci, val = adj
        return csr_spmm_local(rp, ci, val, x, rp.shape[0] - 1)
    return adj @ x


def _per_layer(cfg: GCNConfig, keep_masks, dropout_keys) -> tuple:
    """(masks, keys), one entry (or None) per layer."""
    none = [None] * cfg.num_layers
    for what, got in (("keep-masks", keep_masks),
                      ("dropout keys", dropout_keys)):
        if got is not None and len(got) != cfg.num_layers:
            raise ValueError(f"{len(got)} {what} for {cfg.num_layers} "
                             "layers")
    if keep_masks is not None and dropout_keys is not None:
        raise ValueError("give keep_masks or dropout_keys, not both")
    return (none if keep_masks is None else keep_masks,
            none if dropout_keys is None else dropout_keys)


def forward(params: Params, adj, x: torch.Tensor,
            cfg: GCNConfig, *, train: bool = False,
            keep_masks: Optional[Sequence[torch.Tensor]] = None,
            dropout_keys: Optional[Sequence[torch.Tensor]] = None
            ) -> torch.Tensor:
    """Forward pass §III-B. ``adj`` is a dense ``(B, B)`` block, a
    block-ELL ``(tiles, colidx)`` pair or a CSR triple, as
    ``cfg.spmm_impl`` says. Returns logits (B, num_classes).
    ``keep_masks`` holds one (B, d_hidden) bool dropout keep-mask per
    layer, or ``dropout_keys`` one 0-d int64 key per layer, whose
    ``counter_rng.keep_mask`` bits the tail draws; without either no
    dropout is applied."""
    h = x @ params["w_in"]                                         # Eq. 4
    masks, keys = _per_layer(cfg, keep_masks, dropout_keys)
    for layer, mask, key in zip(params["layers"], masks, keys):
        agg = _spmm(adj, h, cfg)                                   # Eq. 5
        conv = agg @ layer["w"]                                    # Eq. 6
        h = _elementwise_tail(conv, h, layer["rms_scale"], cfg, mask, train,
                              key)
    return h @ params["w_out"]                                     # Eq. 11


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Masked (label == -1 ignored) mean cross-entropy, Eq. 12."""
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - torch.gather(logits, -1, safe[:, None])[:, 0]
    w = valid.to(logits.dtype)
    if weights is not None:
        w = w * weights
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    valid = labels >= 0
    if mask is not None:
        valid = valid & mask
    correct = (torch.argmax(logits, dim=-1) == labels) & valid
    return torch.sum(correct) / torch.clamp(torch.sum(valid), min=1)


# ---------------------------------------------------------------------------
# GraphSAGE variant of the same network (the baseline of Table I, Fig. 6)
# ---------------------------------------------------------------------------

def sage_forward(params: Params, batch, cfg: GCNConfig, *,
                 train: bool = False,
                 keep_masks: Optional[Sequence[torch.Tensor]] = None,
                 dropout_keys: Optional[Sequence[torch.Tensor]] = None
                 ) -> torch.Tensor:
    """SAGE-style forward over a ``baselines.SageBatch``: the parameters
    and layers of :func:`forward`, but layer l aggregates by the mean over
    the sampled neighbors (``baselines.sage_aggregate``) instead of the
    rescaled induced-subgraph SpMM, walking inward from the outermost
    frontier. The tail is :func:`forward`'s (the fused kernel when
    ``elementwise_impl="cuda"``); ``keep_masks[l]`` is layer l's
    (|frontier l|, d_hidden) keep-mask, or ``dropout_keys[l]`` its key. The
    layer count must equal ``len(batch.neighbors)``."""
    from repro_torch.core import baselines as bl
    if cfg.num_layers != len(batch.neighbors):
        raise ValueError(f"{cfg.num_layers} layers for a batch of "
                         f"{len(batch.neighbors)} fan-outs")
    masks, keys = _per_layer(cfg, keep_masks, dropout_keys)
    h = batch.feats @ params["w_in"]
    # layer li consumes frontier li + 1's embeddings and produces frontier
    # li's (its self vertices are the prefix of frontier li + 1)
    for li in reversed(range(cfg.num_layers)):
        layer = params["layers"][li]
        n_inner = batch.frontiers[li].shape[0]
        agg = bl.sage_aggregate(h, batch.neighbors[li])
        conv = agg @ layer["w"]
        h = _elementwise_tail(conv, h[:n_inner], layer["rms_scale"], cfg,
                              masks[li], train, keys[li])
    return h @ params["w_out"]
