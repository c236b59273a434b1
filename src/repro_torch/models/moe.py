"""Mixture-of-Experts layer (mixtral 8x top-2, llama4-scout 16x top-1):
counterpart of ``repro/models/moe.py``, with the same capacity dispatch.

Tokens are routed to per-expert buffers of static capacity
``C = max(int(ceil(T * k / E) * capacity_factor), 1)`` by a cumulative-sum
position over the (token, choice) pairs in token-major order; a pair past
its expert's capacity is dropped (the Switch rule), so an output depends
on the whole batch, not on its token alone. The experts' SwiGLU runs as
three batched products over (E, C, D) (``torch.bmm``, where the reference
has ``einsum``s that XLA computes outside any Pallas kernel), and the
results gather back weighted by the router. Every shape is static and no
step reads the device from the host, so a decode step stays capturable
in a CUDA graph.

:class:`RouteLog` records each call's routing for a caller that checks
or counts it (the card's smoke test), and can replay another log's
experts; without one, nothing is recorded.
"""
from __future__ import annotations

import contextvars
import dataclasses
from typing import List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.obs import phase


def router_topk(logits: torch.Tensor, k: int, *,
                ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, E) logits -> (weights (T, k), ids (T, k), aux_loss scalar).

    Softmax in float32, then the k largest probabilities, the lower expert
    id first on ties (as ``jax.lax.top_k``; a stable descending sort, since
    ``torch.topk`` promises no order among equal values). The weights are
    renormalised over the k and cast to the logits' type; ``aux`` is the
    Switch load-balancing loss ``E * sum_e mean_prob_e * top1_load_e``.
    With ``ids`` (a replayed route, :class:`RouteLog`), those experts and
    their probabilities in place of the top k."""
    probs = torch.softmax(logits.float(), dim=-1)
    if ids is None:
        w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, ids = w[:, :k], ids[:, :k]
    else:
        w = torch.gather(probs, 1, ids)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    e = logits.shape[-1]
    me = probs.mean(dim=0)                                   # mean prob
    ce = (ids[:, :1] == torch.arange(e, device=ids.device)).float().mean(0)
    aux = e * torch.sum(me * ce)
    return w.to(logits.dtype), ids, aux


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Each expert's buffer rows for a call over ``tokens`` tokens."""
    moe = cfg.moe
    cap = int(-(-tokens * moe.top_k // moe.num_experts)
              * moe.capacity_factor)
    return max(cap, 1)


def moe_ffn(p: Mapping, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> ((B, S, D), aux_loss).

    Params: ``router`` (D, E); ``wg``/``wu`` (E, D, F), ``wd`` (E, F, D)
    [SwiGLU experts]; ``shared`` (optional, llama4) ``wg``/``wu`` (D, F),
    ``wd`` (F, D)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = capacity(t, cfg)
    xt = x.reshape(t, d)
    log = active_log()
    with phase("moe_router"):
        logits = xt @ p["router"]
        w, ids, aux = router_topk(
            logits, k, ids=None if log is None else log._forced_ids())

    with phase("moe_dispatch"):
        # each (token, choice) pair's row in its expert's buffer
        flat_ids = ids.reshape(-1)                            # (t*k,)
        onehot = (flat_ids[:, None]
                  == torch.arange(e, device=x.device)).long()  # (t*k, e)
        pos = (torch.cumsum(onehot, dim=0) * onehot - 1).amax(dim=-1)
        keep = pos < cap
        dest = torch.where(keep, flat_ids * cap + pos,
                           torch.full_like(pos, e * cap))     # drop -> pad
        # scatter into (E*C + 1, D); the last row absorbs the drops
        src = torch.repeat_interleave(xt, k, dim=0)           # (t*k, d)
        buf = xt.new_zeros((e * cap + 1, d)).index_copy(0, dest, src)
        buf = buf[:e * cap].view(e, cap, d)

    with phase("moe_experts"):
        h = torch.bmm(buf, p["wg"])
        u = torch.bmm(buf, p["wu"])
        y = torch.bmm(F.silu(h) * u, p["wd"])

    with phase("moe_combine"):
        y_flat = y.reshape(e * cap, d)
        gathered = y_flat[torch.clamp(dest, max=e * cap - 1)]   # (t*k, d)
        gathered = torch.where(keep[:, None], gathered,
                               torch.zeros((), dtype=gathered.dtype,
                                           device=x.device))
        out = (gathered.view(t, k, d)
               * w[..., None].to(gathered.dtype)).sum(dim=1)
        if cfg.moe.shared_expert:
            out = out + L.swiglu_mlp(p["shared"], xt)

    if log is not None:
        log._record(ids, logits.float(), keep.view(t, k))
    return out.view(b, s, d), aux


# ---------------------------------------------------------------------------
# Routing records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Route:
    """One ``moe_ffn`` call's routing, as device tensors: the router's
    ``logits`` (T, E, in float32), ``ids`` (T, k), ``keep`` (T, k) bool
    (False: dropped by capacity) and ``real`` (T,) bool, the rows that
    carry a real token (a prompt's tokens in a prefill, the active slots
    in a decode step)."""
    logits: torch.Tensor
    ids: torch.Tensor
    keep: torch.Tensor
    real: torch.Tensor


class RouteLog:
    """While entered (``with RouteLog() as log:``, in the calling thread),
    every ``moe_ffn`` call appends its :class:`Route` to ``log.routes``;
    the model's entry points declare which rows are real
    (:meth:`mark_real`), all rows otherwise. Nothing is read to the
    host.

    With ``force`` (another log's routes, in call order) the calls replay
    them: each takes the recorded call's experts in place of its own top
    k, weighted by its own probabilities of them, renormalised, so that
    two runs of the same calls route alike whatever their rounding."""

    def __init__(self, force: Optional[Sequence[Route]] = None):
        self.routes: List[Route] = []
        self._real: Optional[torch.Tensor] = None
        self._token = None
        self._force = None if force is None else list(force)

    def __enter__(self) -> "RouteLog":
        self._token = _ROUTE_LOG.set(self)
        return self

    def __exit__(self, *exc) -> None:
        _ROUTE_LOG.reset(self._token)

    def mark_real(self, real: torch.Tensor) -> None:
        """Declare the (T,) rows of the next calls that carry a real
        token."""
        self._real = real.to(torch.bool).reshape(-1)

    def _forced_ids(self) -> Optional[torch.Tensor]:
        if self._force is None:
            return None
        if len(self.routes) >= len(self._force):
            raise RuntimeError(f"RouteLog: {len(self._force)} routes to "
                               f"replay, and a call more")
        return self._force[len(self.routes)].ids

    def _record(self, ids, logits, keep) -> None:
        real = self._real
        if real is None or real.shape[0] != ids.shape[0]:
            real = torch.ones(ids.shape[0], dtype=torch.bool,
                              device=ids.device)
        self.routes.append(Route(logits, ids, keep, real))


_ROUTE_LOG: contextvars.ContextVar[Optional[RouteLog]] = \
    contextvars.ContextVar("repro_torch_moe_route_log", default=None)


def active_log() -> Optional[RouteLog]:
    """The :class:`RouteLog` entered in this thread, if any."""
    return _ROUTE_LOG.get()
