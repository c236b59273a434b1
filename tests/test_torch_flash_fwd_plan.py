"""The flash forward's work plan, on the CPU.

``flash_attention.fwd_plan`` states, in Python, how the CUDA kernels of
``csrc/flash_attention.cu`` spread the forward over the card: one CTA per
(batch row, q head, 64 query rows), (batch row, q head) fastest in the grid
and the query tile slowest, the last tile first where that is the heaviest.
The kernels run only on a card (``test_torch_cuda_kernels.py``); here
``fwd_steps`` lists the key blocks the plan gives each CTA, as the kernels
index them, and the tests hold it against the (query, key) pairs the mask
lets through: each visible block exactly once, in a fixed order, nothing
outside the mask, and under a causal mask no CTA launched after a lighter
one. The plan's block
size and shared memory are the source's, and the cost function, the
yardstick of PERF.md's rows 4a and 4b, is pinned at the training shapes.
"""
import heapq
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tflash  # noqa: E402

SOURCE = (Path(tflash.__file__).resolve().parent / "csrc"
          / "flash_attention.cu")

# (b, sq, t, h, kv, hd, causal, window): the training shape's kind cut down,
# causal, a window (causal and not), non-causal, ragged Sq and T, T shorter
# and longer than Sq, MHA, every head dim (hd 80: zamba2's prefill heads,
# causal, and a window over a ragged T longer than Sq), a window that
# leaves whole tiles with no key
SHAPES = [
    (1, 256, 256, 32, 4, 64, True, None),
    (2, 300, 300, 4, 4, 64, True, None),
    (2, 333, 333, 8, 2, 64, True, 100),
    (2, 77, 130, 4, 2, 16, True, 40),
    (3, 100, 77, 4, 2, 64, False, None),
    (2, 32, 96, 4, 4, 16, False, None),
    (1, 200, 64, 4, 2, 64, False, 32),
    (1, 192, 192, 16, 8, 128, True, None),
    (1, 130, 130, 4, 1, 128, True, 50),
    (1, 1000, 700, 8, 2, 32, True, None),
    (1, 500, 500, 8, 2, 64, False, 128),
    (1, 512, 512, 32, 32, 80, True, None),
    (2, 150, 333, 4, 2, 80, False, 100),
]
DTYPES = [torch.bfloat16, torch.float32]


def _visible(b, sq, t, h, qn, kn, causal, window, q_offset=0):
    """Every (batch row, q head, query block of qn, key block of kn) that
    holds at least one pair the mask allows."""
    allow = tflash.attention_mask(sq, t, causal, window, "cpu", q_offset)
    blocks = set()
    for qb in range(-(-sq // qn)):
        for kb in range(-(-t // kn)):
            if allow[qb * qn:(qb + 1) * qn, kb * kn:(kb + 1) * kn].any():
                blocks.update((bi, head, qb, kb) for bi in range(b)
                              for head in range(h))
    return blocks


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("b,sq,t,h,kv,hd,causal,window", SHAPES)
def test_plan_covers_every_visible_block_once(b, sq, t, h, kv, hd, causal,
                                              window, dtype):
    """The CTAs together walk each visible (query tile, key block) once and
    no other; a CTA is one (batch row, q head, tile), walks its key blocks
    in increasing order, and sits at the launch position the grid gives it
    ((batch row, q head) fastest); the same shape gives the same plan."""
    plan = tflash.fwd_plan(b, sq, t, h, kv, hd, dtype, causal, window)
    ctas = tflash.fwd_steps(plan, b, sq, t, h, kv, causal, window)
    assert plan.n_qt == -(-sq // tflash.FWD_TILE)
    assert len(ctas) == plan.n_ctas == b * h * plan.n_qt
    flat = [s for cta in ctas for s in cta]
    assert len(flat) == len(set(flat))
    assert set(flat) == _visible(b, sq, t, h, tflash.FWD_TILE, plan.k_block,
                                 causal, window)
    for i, cta in enumerate(ctas):
        y, x = divmod(i, b * h)
        tile = plan.n_qt - 1 - y if plan.reverse else y
        assert all(s[:3] == (x // h, x % h, tile) for s in cta)
        kbs = [s[3] for s in cta]
        assert kbs == list(range(kbs[0], kbs[0] + len(kbs)) if kbs else [])
    assert tflash.fwd_plan(b, sq, t, h, kv, hd, dtype, causal,
                           window) == plan
    assert tflash.fwd_steps(plan, b, sq, t, h, kv, causal, window) == ctas


@pytest.mark.parametrize("b,sq,t,h,kv,hd,causal,window", SHAPES)
def test_f32_plan_launches_heaviest_first(b, sq, t, h, kv, hd, causal,
                                          window):
    """Under a causal mask without a window, where the tiles differ in work
    up to T / 64-fold, no CTA is launched after one with fewer key blocks
    (the last tile first, on both routes); under a causal window no tile
    walks more blocks than the window spans, so the CTAs differ little,
    whatever their order; under a window alone the float32 route launches
    the first tile, which sees the most keys, first; with no mask every
    tile walks every block. The float32 route reverses the tiles exactly
    under a causal mask."""
    for dtype in DTYPES:
        plan = tflash.fwd_plan(b, sq, t, h, kv, hd, dtype, causal, window)
        work = [len(cta) for cta in tflash.fwd_steps(plan, b, sq, t, h, kv,
                                                     causal, window)]
        if causal and window is not None:
            span = tflash.FWD_TILE + window - 1
            assert max(work) <= -(-span // plan.k_block) + 1
        elif causal or (window is not None and dtype == torch.float32):
            assert work == sorted(work, reverse=True), plan
        elif window is None:
            assert set(work) == {-(-t // plan.k_block)}
    plan = tflash.fwd_plan(b, sq, t, h, kv, hd, torch.float32, causal,
                           window)
    assert plan.reverse == causal


def _makespan(work, slots):
    """Greedy list scheduling: each CTA, in launch order, to the slot that
    frees first (as the card's block scheduler hands out CTAs)."""
    free = [0] * slots
    for w in work:
        heapq.heappush(free, heapq.heappop(free) + w)
    return max(free)


def test_training_shape_is_balanced_over_the_card():
    """At LLM training's f32 shape (tinyllama-1.1b: 2 x 2048, 32/4 heads of
    64, causal) the tiles differ in work 32-fold; launched heaviest first
    over the 2 x 132 slots of two CTAs an SM, the last slot frees within 1 %
    of the mean, where the tiles in their own order (the grid before the
    plan) leave the card waiting 12.5 % longer."""
    plan = tflash.fwd_plan(2, 2048, 2048, 32, 4, 64, torch.float32, True)
    work = [len(c) for c in tflash.fwd_steps(plan, 2, 2048, 2048, 32, 4)]
    assert (plan.k_block, plan.n_ctas, max(work), min(work)) == \
        (64, 2048, 32, 1)
    slots = tflash.SMS * 2
    mean = sum(work) / slots
    assert _makespan(work, slots) <= 1.01 * mean
    assert _makespan(work[::-1], slots) >= 1.125 * mean


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
def test_plan_blocks_and_smem_are_the_sources(hd):
    """The float32 route's key block is the source's (32 at hd 80 and 128,
    else 64) and its shared memory the q tile, K and V double-buffered and
    p^T (rows padded by 16 bytes): two CTAs fit an SM's 228 KB at every
    head dim, as the source note states for hd 64, 80 and 128."""
    note = re.sub(r"\n// ?", " ", SOURCE.read_text())
    assert "return HD >= 80 ? 32 : 64;" in note
    assert ("Shared memory is 102 KB a CTA at hd 64, 71 KB at hd 80 and 107 "
            "KB at hd 128: two CTAs an SM or more") in note
    plan = tflash.fwd_plan(1, 128, 128, 4, 2, hd, torch.float32)
    assert plan.k_block == (32 if hd >= 80 else 64)
    kb = plan.k_block
    assert plan.smem_bytes == 4 * ((64 + 4 * kb) * (hd + 4) + kb * 68)
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    if hd in (64, 80, 128):
        assert plan.smem_bytes // 1024 == {64: 102, 80: 71, 128: 107}[hd]
    bf = tflash.fwd_plan(1, 128, 128, 4, 2, hd, torch.bfloat16)
    assert (bf.route, bf.k_block, bf.reverse) == ("mma", 64, True)
    assert bf.kernel() == "flash_attention_mma_kernel"
    assert plan.kernel() == "flash_attention_kernel"


@pytest.mark.parametrize("b,dtype,gflop,bound", [
    (2, torch.float32, 34.376515584, 0.513082),
    (4, torch.bfloat16, 68.753031168, 0.069518)],
    ids=["f32-2x2048", "bf16-4x2048"])
def test_fwd_cost_is_pinned_at_training_shapes(b, dtype, gflop, bound):
    """The yardstick does not move with the kernel: two products of 2 hd a
    visible pair and q head (34.4 and 68.8 GFLOP at tinyllama-1.1b's 32/4
    heads of 64, causal, 2048 tokens), operation-bound at 67 TFLOP/s (f32
    CUDA cores) and 989 TFLOP/s (bf16 tensor cores), whatever computes
    them; q, k, v and out read or written once, and the lse."""
    q = torch.empty((b, 2048, 32, 64), dtype=dtype, device="meta")
    kv = torch.empty((b, 2048, 4, 64), dtype=dtype, device="meta")
    n_ops, n_bytes = tflash.flash_attention_cost(q, kv, kv, True, None)
    assert n_ops == round(gflop * 1e9)
    es = q.element_size()
    assert n_bytes == es * 2 * b * 2048 * 64 * (32 + 4) + 4 * b * 32 * 2048
    peak = 989e12 if dtype == torch.bfloat16 else 67e12
    assert n_bytes / 3.35e12 < n_ops / peak
    assert round(n_ops / peak * 1e3, 6) == bound


def test_hd_80_plan_and_the_backward_refusal():
    """At hd 80 the float32 route stages 32-key blocks (64 would take 122 KB
    of shared memory, one CTA an SM), the bfloat16 route 64-key blocks;
    the backward refuses hd 80 no longer: on the meta device, which checks
    as the card does, it returns dq, dk and dv of the inputs' shapes."""
    f32 = tflash.fwd_plan(8, 512, 512, 32, 32, 80, torch.float32)
    bf16 = tflash.fwd_plan(8, 512, 512, 32, 32, 80, torch.bfloat16)
    assert (f32.k_block, f32.smem_bytes) == (32, 73216)
    assert (bf16.k_block, bf16.smem_bytes) == (64, 56320)
    assert 80 in tflash.HEAD_DIMS
    q = torch.empty((1, 64, 2, 80), device="meta")
    kv = torch.empty((1, 96, 1, 80), device="meta")
    out, lse = tflash.flash_attention(q, kv, kv)
    assert out.shape == q.shape and lse.shape == (1, 2, 64)
    dq, dk, dv = tflash.flash_attention_bwd(q, kv, kv, out, lse, out)
    assert dq.shape == q.shape and dk.shape == dv.shape == kv.shape


# (b, sq, t, h, kv, hd, window, q_offset), causal: a sequence shard of
# tinyllama-1.1b's S 4096 over 16 ranks (the first, a middle and the last
# rank's offsets), the reference's q chunk of 2048 at its second chunk,
# offsets that are no multiple of a block, a window under an offset
OFFSET_SHAPES = [
    (1, 256, 4096, 32, 4, 64, None, 0),
    (1, 256, 4096, 32, 4, 64, None, 1792),
    (1, 256, 4096, 32, 4, 64, None, 3840),
    (1, 2048, 4096, 8, 2, 64, None, 2048),
    (2, 40, 128, 4, 2, 64, None, 24),
    (2, 64, 128, 4, 2, 80, 32, 88),
    (2, 100, 300, 4, 2, 128, None, 77),
    (1, 77, 500, 4, 1, 16, 40, 300),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("b,sq,t,h,kv,hd,window,q_offset", OFFSET_SHAPES)
def test_offset_plan_walks_only_the_visible_blocks(b, sq, t, h, kv, hd,
                                                   window, q_offset, dtype):
    """Under a query offset each CTA walks exactly the key blocks its rows
    can see (none past its last row's position), in order, each visible
    block once; under a causal mask without a window the last tile still
    comes first and no CTA is launched after a lighter one; the cost
    counts the visible pairs alone and the K/V rows they read."""
    plan = tflash.fwd_plan(b, sq, t, h, kv, hd, dtype, True, window)
    ctas = tflash.fwd_steps(plan, b, sq, t, h, kv, True, window, q_offset)
    flat = [s for cta in ctas for s in cta]
    assert len(flat) == len(set(flat))
    assert set(flat) == _visible(b, sq, t, h, tflash.FWD_TILE, plan.k_block,
                                 True, window, q_offset)
    if window is None:
        work = [len(cta) for cta in ctas]
        assert work == sorted(work, reverse=True)
    pairs = int(tflash.attention_mask(sq, t, True, window, "cpu",
                                      q_offset).sum())
    assert tflash.visible_pairs(sq, t, True, window, q_offset) == pairs
    q = torch.empty((b, sq, h, hd), dtype=dtype, device="meta")
    kvt = torch.empty((b, t, kv, hd), dtype=dtype, device="meta")
    n_ops, n_bytes = tflash.flash_attention_cost(q, kvt, kvt, True, window,
                                                 q_offset)
    assert n_ops == 4 * hd * pairs * b * h
    seen = min(t, q_offset + sq) - (max(0, q_offset - window + 1)
                                    if window else 0)
    es = q.element_size()
    assert n_bytes == es * (2 * b * sq * h * hd + 2 * b * seen * kv * hd) \
        + 4 * b * h * sq
