"""Public wrappers of the port's kernels with their autograd rules
(counterpart of ``repro/kernels/ops.py``).

The SpMM and the tail are ``torch.autograd.Function``s: the forward is the
CUDA kernel for CUDA tensors (its plain version for CPU tensors); the
backward is plain PyTorch in the reference's order of operations, as the
reference's custom VJPs are plain jnp (``_spmm_bwd``, ``_fused_bwd``) with
no Pallas kernel. Attention is forward only so far.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_layer as _fused
from repro_torch.kernels import spmm_ell as _spmm

# ---------------------------------------------------------------------------
# Block-ELL SpMM
# ---------------------------------------------------------------------------


class _SpmmEll(torch.autograd.Function):
    """out = A @ x for A = (tiles, colidx); colidx gets no gradient."""

    @staticmethod
    def forward(ctx, tiles, colidx, x):
        ctx.save_for_backward(tiles, colidx, x)
        return _spmm.spmm_ell(tiles, colidx, x)

    @staticmethod
    def backward(ctx, g):
        tiles, colidx, x = ctx.saved_tensors
        n_rb, n_slots, bm, bn = tiles.shape
        d = x.shape[1]
        n_cb = x.shape[0] // bn
        c = colidx.long().clamp(0, max(n_cb - 1, 0))
        gblocks = g.reshape(n_rb, bm, d)
        dtiles = dx = None
        if ctx.needs_input_grad[2]:
            # dX = A^T g: each slot's tile^T @ g_rowblock, batched, summed
            # into its column block (index_add_ uses atomics on the card)
            contrib = torch.matmul(tiles.transpose(-1, -2),
                                   gblocks[:, None]).float()
            dx = torch.zeros((n_cb, bn, d), dtype=torch.float32,
                             device=x.device)
            dx.index_add_(0, c.reshape(-1), contrib.reshape(-1, bn, d))
            dx = dx.reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[0]:
            # dTiles = g_rowblock @ x_colblock^T per slot
            xb = x.reshape(n_cb, bn, d)[c]                 # (n_rb, S, bn, d)
            dtiles = torch.matmul(gblocks[:, None],
                                  xb.transpose(-1, -2)).to(tiles.dtype)
        return dtiles, None, dx


def spmm_ell(tiles: torch.Tensor, colidx: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Block-ELL SpMM (paper Eq. 5) with its autograd rule."""
    return _SpmmEll.apply(tiles, colidx, x)


# ---------------------------------------------------------------------------
# Fused element-wise layer tail
# ---------------------------------------------------------------------------


class _FusedTail(torch.autograd.Function):
    """RMSNorm -> ReLU -> dropout -> residual; the mask gets no gradient."""

    @staticmethod
    def forward(ctx, x, scale, mask, residual, dropout_rate, eps,
                use_rmsnorm, use_relu):
        ctx.save_for_backward(x, scale, mask)
        ctx.cfg = (residual is not None, dropout_rate, eps, use_rmsnorm,
                   use_relu)
        return _fused.fused_layer(
            x, scale, mask, residual, dropout_rate=dropout_rate, eps=eps,
            use_rmsnorm=use_rmsnorm, use_relu=use_relu)

    @staticmethod
    def backward(ctx, g):
        """Recompute the forward up to the ReLU input; d_res is g before
        the mask, d_scale is summed over rows (zeros without RMSNorm)."""
        x, scale, mask = ctx.saved_tensors
        has_res, dropout_rate, eps, use_rmsnorm, use_relu = ctx.cfg
        g = g.float()
        x32 = x.float()
        d_res = g if has_res else None
        if mask is not None:
            g = torch.where(mask, g / (1.0 - dropout_rate),
                            torch.zeros_like(g))
        if use_rmsnorm:
            ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
            inv = torch.rsqrt(ms + eps)
            normed = x32 * inv
            pre_relu = normed * scale
        else:
            pre_relu = x32
        if use_relu:
            g = torch.where(pre_relu > 0, g, torch.zeros_like(g))
        if use_rmsnorm:
            d_scale = torch.sum(g * normed, dim=0)
            gs = g * scale
            d = x.shape[-1]
            dot = torch.sum(gs * x32, dim=-1, keepdim=True)
            dx = inv * gs - x32 * (inv ** 3) * dot / d
        else:
            d_scale = torch.zeros_like(scale)
            dx = g
        return (dx.to(x.dtype), d_scale.to(scale.dtype), None,
                None if d_res is None else d_res.to(x.dtype),
                None, None, None, None)


def fused_layer_tail(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    scale: torch.Tensor,
    *,
    dropout_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    eps: float = 1e-6,
    use_rmsnorm: bool = True,
    use_relu: bool = True,
) -> torch.Tensor:
    """Fused RMSNorm+ReLU+dropout+residual (paper §V-C) with its autograd
    rule: the CUDA kernel for CUDA tensors, its plain version for CPU
    tensors."""
    rate = float(dropout_rate) if dropout_mask is not None else 0.0
    return _FusedTail.apply(x, scale, dropout_mask, residual, rate,
                            float(eps), use_rmsnorm, use_relu)


# ---------------------------------------------------------------------------
# Flash attention (forward only)
# ---------------------------------------------------------------------------

_FLASH_BWD_TODO = ("the flash-attention backward (ops._fa_bwd and "
                   "layers._flash_bwd of the JAX package) is not ported yet: "
                   "ROADMAP queue 1, item 10 (LLM training)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Grouped-query attention with a running softmax; returns ``out``
    (B, Sq, H, hd) in q's type: the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors. No autograd rule yet: an input that requires
    grad raises."""
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise NotImplementedError(_FLASH_BWD_TODO)
    return _flash.flash_attention(q, k, v, causal, window)[0]
