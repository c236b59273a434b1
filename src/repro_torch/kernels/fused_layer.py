"""Fused element-wise layer tail — the paper's §V-C kernel fusion in CUDA —
and its backward.

Counterpart of ``repro/kernels/fused_layer.py``. One pass over each row
applies

    RMSNorm (Eq. 7) -> ReLU (Eq. 8) -> dropout via a keep-mask (Eq. 9)
    -> residual add (Eq. 10)

in float32 and writes the row once (``csrc/fused_layer.cu``): on the vector
route (:func:`vector_chunks`) each input is read once with 16-byte loads and
the row stays in registers; the scalar route takes any width and
alignment. Both divide a kept element by ``keep_prob`` correctly rounded,
as the reference does. The keep bits come from a (B, d) bool mask
(``dropout_mask``) or from the counter (``dropout_key``, the 0-d int64 key
of ``counter_rng.keep_mask``: the kernel draws lane ``row * d + col`` in
its registers, the bits that function's mask holds, so the two give the
same output bit for bit and the counter moves no mask through memory).
:func:`fused_layer_bwd` is the backward (dx and d_scale) as a kernel of the
same routes, deterministic (no float atomics); the reference's backward
(``_fused_bwd``) is plain jnp. :func:`fused_layer` and
:func:`fused_layer_bwd` launch their kernels for CUDA tensors and run
:func:`fused_layer_plain` and :func:`fused_layer_bwd_plain`, the same
functions in plain PyTorch (a counter key drawn by
``counter_rng.keep_mask_plain``), for CPU tensors; on the meta device they
return outputs of the right shape and compute nothing.
:func:`fused_layer_cost` and :func:`fused_layer_bwd_cost` count their work
(each input read once, each output written once). The autograd rule is
``kernels.ops.fused_layer_tail``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _observe
from repro_torch.kernels import counter_rng as crng

# kernel launches so far (a run zeroes them to show that a path used the
# kernels): the forward's in total, by route and by the keep bits' source,
# and the backward's in total and by route
LAUNCHES = 0
ROUTE_LAUNCHES = {"vector": 0, "scalar": 0}
SOURCE_LAUNCHES = {"none": 0, "bytes": 0, "counter": 0}
BWD_LAUNCHES = 0
BWD_ROUTE_LAUNCHES = {"vector": 0, "scalar": 0}

ROWS_PER_CTA = 8             # one warp a row
MAX_CHUNKS = 8               # float4 a lane holds on the vector route
BWD_MAX_CTAS = 256           # the backward's grid: rows per warp grow past


def vector_chunks(d: int, float_ptrs, mask_ptr: Optional[int]) -> int:
    """The float4 a lane holds on the vector route, ``ceil(d / 128)``, or 0
    for the scalar route. The vector route needs ``d % 4 == 0``, ``d <=
    1024``, every float tensor 16-byte aligned (x, scale, residual, out;
    g, x, scale, dx for the backward) and the mask 4-byte aligned; then
    every row is aligned too."""
    if d % 4 or d > 128 * MAX_CHUNKS:
        return 0
    if any(p % 16 for p in float_ptrs) or (mask_ptr or 0) % 4:
        return 0
    return -(-d // 128)


def bwd_grid(rows: int) -> tuple:
    """The backward's launch: (grid, rows_per_warp), at most
    ``BWD_MAX_CTAS`` CTAs of ``ROWS_PER_CTA`` warps, each warp
    ``rows_per_warp`` consecutive rows. A function of the row count only,
    so d_scale's order of summation is too."""
    rpw = max(1, -(-rows // (ROWS_PER_CTA * BWD_MAX_CTAS)))
    return max(1, -(-rows // (ROWS_PER_CTA * rpw))), rpw


def _keep(dropout_mask: Optional[torch.Tensor],
          dropout_key: Optional[torch.Tensor], rows: int, cols: int,
          rate: float) -> Optional[torch.Tensor]:
    """The keep-mask of either source, for the plain versions: the mask
    itself, or the counter's bits drawn by ``keep_mask_plain``."""
    if dropout_mask is not None and dropout_key is not None:
        raise ValueError("fused_layer: give dropout_mask or dropout_key, "
                         "not both")
    if dropout_key is None:
        return dropout_mask
    return crng.keep_mask_plain(dropout_key, rows, cols, rate)


def fused_layer_plain(x: torch.Tensor, scale: torch.Tensor,
                      dropout_mask: Optional[torch.Tensor],
                      residual: Optional[torch.Tensor], *,
                      dropout_rate: float = 0.0, eps: float = 1e-6,
                      use_rmsnorm: bool = True, use_relu: bool = True,
                      dropout_key: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the Pallas kernel's
    order of operations."""
    dropout_mask = _keep(dropout_mask, dropout_key, x.shape[0], x.shape[-1],
                         dropout_rate)
    h = x.float()
    if use_rmsnorm:
        ms = torch.mean(torch.square(h), dim=-1, keepdim=True)
        h = h * torch.rsqrt(ms + eps) * scale.float()
    if use_relu:
        h = torch.relu(h)
    if dropout_mask is not None:
        h = torch.where(dropout_mask, h / (1.0 - dropout_rate),
                        torch.zeros_like(h))
    if residual is not None:
        h = h + residual.float()
    return h.to(x.dtype)


def fused_layer_bwd_plain(g: torch.Tensor, x: torch.Tensor,
                          scale: torch.Tensor,
                          dropout_mask: Optional[torch.Tensor], *,
                          dropout_rate: float = 0.0, eps: float = 1e-6,
                          use_rmsnorm: bool = True, use_relu: bool = True,
                          dropout_key: Optional[torch.Tensor] = None
                          ) -> tuple:
    """The backward kernel's function in plain PyTorch, the reference's
    ``_fused_bwd`` in its order of operations: ``(dx, d_scale)`` for the
    cotangent ``g`` (d_scale summed over rows; zeros without RMSNorm). The
    residual's gradient is ``g`` itself."""
    mask = _keep(dropout_mask, dropout_key, x.shape[0], x.shape[-1],
                 dropout_rate)
    g = g.float()
    x32 = x.float()
    if mask is not None:
        g = torch.where(mask, g / (1.0 - dropout_rate), torch.zeros_like(g))
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
    return dx.to(x.dtype), d_scale.to(scale.dtype)


def _keep_bytes(dropout_mask, dropout_key) -> int:
    """Bytes of the keep bits' source: the bool mask, or the 8-byte key."""
    if dropout_key is not None:
        return 8
    return 0 if dropout_mask is None else dropout_mask.numel()


def fused_layer_cost(x: torch.Tensor, scale: torch.Tensor,
                     dropout_mask: Optional[torch.Tensor],
                     residual: Optional[torch.Tensor], *,
                     dropout_rate: float = 0.0, eps: float = 1e-6,
                     use_rmsnorm: bool = True, use_relu: bool = True,
                     dropout_key: Optional[torch.Tensor] = None,
                     out=None) -> tuple:
    """(operations, bytes) of :func:`fused_layer`: per element the
    RMSNorm's square-add and two products, the ReLU, the dropout and the
    residual add (7 with every part on); x, the scale, the residual and
    the keep source read once, the output written once."""
    n_el = x.numel()
    per = (4 * use_rmsnorm + use_relu
           + (dropout_mask is not None or dropout_key is not None)
           + (residual is not None))
    n_bytes = (4 * n_el * (2 + (residual is not None)) + 4 * scale.numel()
               + _keep_bytes(dropout_mask, dropout_key))
    return per * n_el, n_bytes


def fused_layer_bwd_cost(g: torch.Tensor, x: torch.Tensor,
                         scale: torch.Tensor,
                         dropout_mask: Optional[torch.Tensor], *,
                         dropout_rate: float = 0.0, eps: float = 1e-6,
                         use_rmsnorm: bool = True, use_relu: bool = True,
                         dropout_key: Optional[torch.Tensor] = None,
                         out=None) -> tuple:
    """(operations, bytes) of :func:`fused_layer_bwd`: 14 per element (the
    norm recomputed, the gate, the row's dot, d_scale's sum and dx); g, x,
    the scale and the keep source read once, dx and d_scale written once."""
    n_el = x.numel()
    return 14 * n_el, (12 * n_el + 8 * scale.numel()
                       + _keep_bytes(dropout_mask, dropout_key))


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"fused_layer: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}")


def _check_launch(x: torch.Tensor, scale: torch.Tensor,
                  dropout_mask: Optional[torch.Tensor],
                  dropout_key: Optional[torch.Tensor],
                  dropout_rate: float) -> tuple:
    """The checks both kernels share: (b, d) of a 2-D float32 ``x`` on the
    card (or the meta device), its (d,) scale, a (b, d) bool mask or a 0-d
    int64 key (not both) with a rate in [0, 1)."""
    dev = x.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"fused_layer: unsupported device {dev}")
    if x.dim() != 2:
        raise ValueError(f"fused_layer: x must be 2-D, got {tuple(x.shape)}")
    b, d = x.shape
    _check(x, "x", torch.float32, (b, d), dev)
    _check(scale, "scale", torch.float32, (d,), dev)
    if dropout_mask is not None and dropout_key is not None:
        raise ValueError("fused_layer: give dropout_mask or dropout_key, "
                         "not both")
    if dropout_mask is not None:
        _check(dropout_mask, "dropout_mask", torch.bool, (b, d), dev)
    if dropout_key is not None:
        _check(dropout_key, "dropout_key", torch.int64, (), dev)
    if (dropout_mask is not None or dropout_key is not None) \
            and not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"fused_layer: dropout_rate={dropout_rate}")
    return b, d


def _source(dropout_mask, dropout_key) -> tuple:
    """(mask pointer, key pointer, the source's name)."""
    if dropout_key is not None:
        return None, dropout_key.data_ptr(), "counter"
    if dropout_mask is not None:
        return dropout_mask.data_ptr(), None, "bytes"
    return None, None, "none"


def _threshold(dropout_key, dropout_rate: float) -> int:
    return crng.keep_threshold(dropout_rate) if dropout_key is not None \
        else 0


@_observe.counted(fused_layer_cost)
def fused_layer(x: torch.Tensor, scale: torch.Tensor,
                dropout_mask: Optional[torch.Tensor],
                residual: Optional[torch.Tensor], *,
                dropout_rate: float = 0.0, eps: float = 1e-6,
                use_rmsnorm: bool = True, use_relu: bool = True,
                dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm+ReLU+dropout+residual of ``x`` (B, d) float32 with the
    ``(d,)`` RMSNorm scale; the keep bits come from ``dropout_mask``, a
    (B, d) bool keep-mask, or ``dropout_key``, the 0-d int64 key of
    ``counter_rng.keep_mask`` (at most one of the two); ``residual`` is a
    (B, d) float32 tensor; each is optional."""
    if x.device.type == "cpu":
        return fused_layer_plain(x, scale, dropout_mask, residual,
                                 dropout_rate=dropout_rate, eps=eps,
                                 use_rmsnorm=use_rmsnorm, use_relu=use_relu,
                                 dropout_key=dropout_key)
    b, d = _check_launch(x, scale, dropout_mask, dropout_key, dropout_rate)
    dev = x.device
    if residual is not None:
        _check(residual, "residual", torch.float32, (b, d), dev)
    out = torch.empty_like(x)
    if b == 0 or d == 0 or dev.type == "meta":
        return out
    mask_ptr, key_ptr, source = _source(dropout_mask, dropout_key)
    res_ptr = None if residual is None else residual.data_ptr()
    chunks = vector_chunks(d, [p for p in (x.data_ptr(), scale.data_ptr(),
                                           res_ptr, out.data_ptr())
                               if p is not None], mask_ptr)
    lib = _build.load()
    rc = lib.repro_fused_layer(
        x.data_ptr(), scale.data_ptr(), mask_ptr, key_ptr, res_ptr,
        out.data_ptr(), b, d, float(eps), float(1.0 - dropout_rate),
        _threshold(dropout_key, dropout_rate), int(use_rmsnorm),
        int(use_relu), chunks, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_layer")
    global LAUNCHES
    LAUNCHES += 1
    ROUTE_LAUNCHES["vector" if chunks else "scalar"] += 1
    SOURCE_LAUNCHES[source] += 1
    return out


@_observe.counted(fused_layer_bwd_cost)
def fused_layer_bwd(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                    dropout_mask: Optional[torch.Tensor], *,
                    dropout_rate: float = 0.0, eps: float = 1e-6,
                    use_rmsnorm: bool = True, use_relu: bool = True,
                    dropout_key: Optional[torch.Tensor] = None) -> tuple:
    """The tail's backward: ``(dx, d_scale)`` for the cotangent ``g``
    (B, d) of :func:`fused_layer`'s output at ``x``, with the forward's
    scale, keep source and flags (d_scale zeros without RMSNorm; the
    residual's gradient is ``g``). The kernels (two launches, counted as
    one call) for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return fused_layer_bwd_plain(g, x, scale, dropout_mask,
                                     dropout_rate=dropout_rate, eps=eps,
                                     use_rmsnorm=use_rmsnorm,
                                     use_relu=use_relu,
                                     dropout_key=dropout_key)
    b, d = _check_launch(x, scale, dropout_mask, dropout_key, dropout_rate)
    dev = x.device
    _check(g, "g", torch.float32, (b, d), dev)
    dx = torch.empty_like(x)
    if b == 0 or d == 0:
        return dx, torch.zeros_like(scale)
    d_scale = torch.empty_like(scale)
    if dev.type == "meta":
        return dx, d_scale
    mask_ptr, key_ptr, _ = _source(dropout_mask, dropout_key)
    chunks = vector_chunks(d, [g.data_ptr(), x.data_ptr(), scale.data_ptr(),
                               dx.data_ptr()], mask_ptr)
    grid, rpw = bwd_grid(b)
    partial = (torch.empty((grid * (1 if chunks else ROWS_PER_CTA), d),
                           dtype=torch.float32, device=dev)
               if use_rmsnorm else None)
    lib = _build.load()
    rc = lib.repro_fused_layer_bwd(
        g.data_ptr(), x.data_ptr(), scale.data_ptr(), mask_ptr, key_ptr,
        dx.data_ptr(), None if partial is None else partial.data_ptr(),
        d_scale.data_ptr(), b, d, float(eps), float(1.0 - dropout_rate),
        _threshold(dropout_key, dropout_rate), int(use_rmsnorm),
        int(use_relu), chunks, grid, rpw,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_layer_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    BWD_ROUTE_LAUNCHES["vector" if chunks else "scalar"] += 1
    return dx, d_scale
