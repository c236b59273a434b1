"""Mamba2 / SSD (state-space duality) block  [arXiv:2405.21060].

Counterpart of ``repro/models/ssm.py``, in plain PyTorch: the reference's
SSD is plain jnp and reaches no Pallas kernel. The sequence is split into
chunks of length Q; within a chunk the quadratic (attention-like) form
with the 1-semiseparable decay mask, and from chunk to chunk the (heads,
head_dim, d_state) recurrent state, carried by a loop over the chunks
where the reference runs a ``lax.scan``. Decode keeps (conv_state,
ssm_state) and advances both in O(1).

Numerics as in the reference: A, dt, x * dt, the decay masks and the
carried state in float32 whatever the input type, the output cast to x's
type; the gated RMSNorm with eps 1e-5; ``in_proj`` split z | xBC | dt.
Shapes: d_inner = expand * d_model, heads nh = d_inner / head_dim, B and C
per group (n_groups * d_state), repeated over the heads of a group. The
depthwise causal conv (width d_conv) runs over the (x, B, C) channels.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.models.layers import rmsnorm

# the leaves of a Mamba2 block that are float32 whatever the model's
# param_dtype, as the reference initialises them
F32_LEAVES = ("a_log", "d_skip", "dt_bias")


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular cumulative segment sums: out[..., i, j] =
    sum_{j < k <= i} a[..., k] for j < i; 0 on the diagonal; -inf above
    (which ``exp`` turns into exactly 0)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # sum_(j, i]
    ii = torch.arange(q, device=a.device)
    return diff.masked_fill(ii[:, None] < ii[None, :], float("-inf"))


def _repeat_heads(x: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(x, rep, axis=dim)``: each group's entry once for each
    of its ``rep`` heads, as a broadcast and a reshape."""
    if rep == 1:
        return x
    shape = list(x.shape)
    y = x.unsqueeze(dim + 1).expand(*shape[:dim + 1], rep, *shape[dim + 1:])
    return y.reshape(*shape[:dim], shape[dim] * rep, *shape[dim + 1:])


def ssd_chunked(
    x: torch.Tensor,       # (B, S, H, P)   inputs (already conv'd + activated)
    dt: torch.Tensor,      # (B, S, H)      softplus'd step sizes
    a_log: torch.Tensor,   # (H,)           A = -exp(a_log)
    b: torch.Tensor,       # (B, S, G, N)
    c: torch.Tensor,       # (B, S, G, N)
    d_skip: torch.Tensor,  # (H,)           skip connection
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) in x's type, final_state (B, H, P, N)
    float32)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk != 0:
        # pad to a chunk multiple: dt=0 at padded steps makes the decay 1
        # and the input contribution 0, so the carried state is unchanged
        pad = chunk - s % chunk
        y_pad, st = ssd_chunked(
            F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), a_log,
            F.pad(b, (0, 0, 0, 0, 0, pad)), F.pad(c, (0, 0, 0, 0, 0, pad)),
            d_skip, chunk, init_state)
        return y_pad[:, :s], st
    nc = s // chunk
    rep = h // g

    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))                       # (H,) negative
    da = dt.to(f32) * a                                 # (B, S, H)
    xdt = x.to(f32) * dt.to(f32)[..., None]             # discretized input

    # chunked views
    da_c = da.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)  # (B,H,nc,Q)
    x_c = xdt.reshape(bsz, nc, chunk, h, p)
    b_c = b.to(f32).reshape(bsz, nc, chunk, g, n)
    c_c = c.to(f32).reshape(bsz, nc, chunk, g, n)

    # within-chunk (diagonal blocks): attention-like with the decay mask;
    # scores C_i . B_j per group, repeated over the group's heads
    lmask = torch.exp(_segsum(da_c))                    # (B,H,nc,Q,Q)
    cb = torch.einsum("bnigx,bnjgx->bgnij", c_c, b_c)   # (B,G,nc,Q,Q)
    cb = _repeat_heads(cb, rep, 1)                      # (B,H,nc,Q,Q)
    y_diag = torch.einsum("bhnij,bnjhp->bnihp", cb * lmask, x_c)
    del cb, lmask

    # chunk states: sum_j exp(sum_{k>j} da) B_j x_j
    cum = torch.cumsum(da_c, dim=-1)                    # (B,H,nc,Q)
    decay_to_end = torch.exp(cum[..., -1:] - cum)       # (B,H,nc,Q)
    bg = _repeat_heads(b_c, rep, 3)                     # (B,nc,Q,H,N)
    states = torch.einsum("bnjhx,bnjhp->bnhpx",
                          bg * decay_to_end.permute(0, 2, 3, 1)[..., None],
                          x_c)                          # (B,nc,H,P,N)

    # inter-chunk recurrence: the state before each chunk, then the last
    chunk_decay = torch.exp(cum[..., -1])               # (B,H,nc)
    st = (init_state.to(f32) if init_state is not None
          else torch.zeros((bsz, h, p, n), dtype=f32, device=x.device))
    prev = []
    for i in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)              # (B,nc,H,P,N)

    # contribution of the carried state into each chunk
    state_decay = torch.exp(cum).permute(0, 2, 3, 1)    # (B,nc,Q,H)
    cg = _repeat_heads(c_c, rep, 3)
    y_off = torch.einsum("bnihx,bnhpx->bnihp", cg, prev_states) \
        * state_decay[..., None]

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    y = y + x.to(f32) * d_skip.to(f32)[None, None, :, None]
    return y.to(x.dtype), st


def ssd_decode_step(
    x: torch.Tensor,       # (B, H, P)  one token (conv'd)
    dt: torch.Tensor,      # (B, H)
    a_log: torch.Tensor,   # (H,)
    b: torch.Tensor,       # (B, G, N)
    c: torch.Tensor,       # (B, G, N)
    d_skip: torch.Tensor,  # (H,)
    state: torch.Tensor,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent update: s' = exp(dt*A) s + dt * x B^T; y = C . s'.
    Returns (y (B, H, P) in x's type, s' in the state's type)."""
    f32 = torch.float32
    rep = x.shape[1] // b.shape[1]
    a = -torch.exp(a_log.to(f32))
    da = torch.exp(dt.to(f32) * a)                      # (B, H)
    bg = _repeat_heads(b.to(f32), rep, 1)               # (B, H, N)
    cg = _repeat_heads(c.to(f32), rep, 1)
    xdt = x.to(f32) * dt.to(f32)[..., None]             # (B, H, P)
    new_state = (state.to(f32) * da[..., None, None]
                 + xdt[..., None] * bg[:, :, None, :])  # (B,H,P,N)
    y = torch.einsum("bhpn,bhn->bhp", new_state, cg)
    y = y + x.to(f32) * d_skip.to(f32)[None, :, None]
    return y.to(x.dtype), new_state.to(state.dtype)


# ---------------------------------------------------------------------------
# Full Mamba2 block (projections + conv + SSD + gate + out)
# ---------------------------------------------------------------------------

def _conv1d_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (C, K). The sum of K shifted
    slices in float32, as the reference unrolls it."""
    k = w.shape[-1]
    s = x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + pad[:, i:i + s].float() * w[:, i].float()
    return out.to(x.dtype)


def mamba2_split_sizes(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, n_groups * d_state, ssm heads, d_conv)."""
    s: SSMConfig = cfg.ssm
    din = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    nh = s.n_heads(cfg.d_model)
    return din, gn, nh, s.d_conv


def _split(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """z | xBC | dt of ``in_proj``'s output."""
    din, gn, nh, _ = mamba2_split_sizes(cfg)
    return torch.split(zxbcdt, [din, din + 2 * gn, nh], dim=-1)


def _gate_out(p: Mapping, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The gated RMSNorm (norm(y * silu(z))) and ``out_proj``."""
    y = y * F.silu(z.float()).to(y.dtype)
    return rmsnorm(y, p["norm_scale"], 1e-5) @ p["out_proj"]


def mamba2_block(p: Mapping, x: torch.Tensor, cfg: ModelConfig,
                 init_state: Optional[torch.Tensor] = None, *,
                 return_conv_input: bool = False):
    """Full-sequence Mamba2 block. x: (B, S, D). Returns (y, final_ssm_state),
    and with ``return_conv_input`` also the conv's (B, S, C_conv) input
    (xBC before the conv), whose last K-1 rows a prefill carries into the
    decode conv state.

    Params: in_proj (D, 2*din + 2*gn + nh), conv_w (din + 2*gn, K),
    a_log (nh,), d_skip (nh,), dt_bias (nh,), norm_scale (din,),
    out_proj (din, D).
    """
    s: SSMConfig = cfg.ssm
    din, gn, nh, _ = mamba2_split_sizes(cfg)
    bsz, sl, _ = x.shape

    z, xbc_in, dt = _split(x @ p["in_proj"], cfg)
    xbc = F.silu(_conv1d_causal(xbc_in, p["conv_w"]))
    xin, b, c = torch.split(xbc, [din, gn, gn], dim=-1)
    # jax.nn.softplus; torch's returns x above 20, where log1p(e^-x) lies
    # below float32's resolution of x
    dt = F.softplus(dt.float() + p["dt_bias"].float())

    y, state = ssd_chunked(
        xin.reshape(bsz, sl, nh, s.head_dim), dt, p["a_log"],
        b.reshape(bsz, sl, s.n_groups, s.d_state),
        c.reshape(bsz, sl, s.n_groups, s.d_state),
        p["d_skip"], chunk=min(s.chunk, sl), init_state=init_state)
    y = _gate_out(p, y.reshape(bsz, sl, din), z)
    return (y, state, xbc_in) if return_conv_input else (y, state)


def mamba2_decode(p: Mapping, x: torch.Tensor, cfg: ModelConfig,
                  conv_state: torch.Tensor, ssm_state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token Mamba2 step. x: (B, 1, D). conv_state: (B, K-1, C_conv).
    Returns (y (B, 1, D), conv_state', ssm_state')."""
    s: SSMConfig = cfg.ssm
    din, gn, nh, _ = mamba2_split_sizes(cfg)
    bsz = x.shape[0]

    z, xbc, dt = _split(x[:, 0] @ p["in_proj"], cfg)
    # the conv over the stored last K-1 inputs and this one
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)  # (B,K,C)
    conv_out = torch.einsum("bkc,ck->bc", window.float(),
                            p["conv_w"].float())
    xbc = F.silu(conv_out).to(x.dtype)
    xin, b, c = torch.split(xbc, [din, gn, gn], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())    # (B, nh)

    y, new_ssm = ssd_decode_step(
        xin.reshape(bsz, nh, s.head_dim), dt, p["a_log"],
        b.reshape(bsz, s.n_groups, s.d_state),
        c.reshape(bsz, s.n_groups, s.d_state), p["d_skip"], ssm_state)
    return (_gate_out(p, y.reshape(bsz, din), z)[:, None, :], window[:, 1:],
            new_ssm)
