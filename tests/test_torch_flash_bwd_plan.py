"""The flash backward's work plan, on the CPU.

``flash_attention.bwd_plan`` chooses, in Python, how the CUDA kernels of
``csrc/flash_attention_bwd.cu`` spread the backward over the card: a dq
kernel per (batch row, q head, 64 query rows), and a dk/dv kernel whose
units pair key blocks under a causal mask and may share a kv head's q
heads out, with float32 partials summed in a fixed order. The kernels run
only on a card (``test_torch_cuda_kernels.py``); here ``bwd_steps`` lists
the work the plan gives each CTA, as the kernels index it, and the tests
hold it against the (query, key) pairs the mask lets through: each visible
block exactly once, in a fixed order, with the scratch the source note
states. The cost function, the yardstick of PERF.md's rows 4c and 4d, is
pinned at both training shapes.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tflash  # noqa: E402

SOURCE = (Path(tflash.__file__).resolve().parent / "csrc"
          / "flash_attention_bwd.cu")

# (b, sq, t, h, kv, hd, causal, window): both training shapes' kinds cut
# down, causal (pairs), a window, non-causal, ragged Sq and T, MHA, hd 128
# and hd 80
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
    # hd 80: zamba2-2.7b's shared attention (32/32 heads), GQA under a
    # window with Sq != T, and without a mask over a ragged T
    (1, 1024, 1024, 32, 32, 80, True, None),
    (2, 300, 333, 8, 2, 80, True, 100),
    (1, 90, 200, 4, 4, 80, False, None),
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
    """Both kernels' CTAs together walk each visible block once and no
    other; a unit walks its key blocks, then its q heads, then its query
    blocks in increasing order; and the same shape gives the same plan."""
    plan = tflash.bwd_plan(b, sq, t, h, kv, hd, dtype, causal, window)
    dq, dkdv = tflash.bwd_steps(plan, b, sq, t, h, kv, causal, window)
    assert len(dq) == b * h * -(-sq // tflash.BWD_TILE)
    assert len(dkdv) == plan.n_units
    for steps, qn, kn in ((dq, tflash.BWD_TILE, plan.k_block),
                          (dkdv, plan.q_block, tflash.BWD_TILE)):
        flat = [s for cta in steps for s in cta]
        assert len(flat) == len(set(flat))
        assert set(flat) == _visible(b, sq, t, h, qn, kn, causal, window)
    for cta in dq:        # one (batch row, q head, query block) a CTA
        assert len({s[:3] for s in cta}) <= 1
        assert [s[3] for s in cta] == sorted(s[3] for s in cta)
    g = h // kv
    for unit in dkdv:     # one batch row and kv head; g / split q heads
        assert len({(s[0], s[1] // g) for s in unit}) <= 1
        assert len({s[1] for s in unit}) <= g // plan.split
        kbs = list(dict.fromkeys(s[3] for s in unit))
        order = [(kbs.index(s[3]), s[1], s[2]) for s in unit]
        assert order == sorted(order)
    assert tflash.bwd_plan(b, sq, t, h, kv, hd, dtype, causal,
                           window) == plan
    assert tflash.bwd_steps(plan, b, sq, t, h, kv, causal,
                            window) == (dq, dkdv)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("b,sq,t,h,kv,hd,causal,window", SHAPES)
def test_plan_scratch_is_what_the_source_note_states(b, sq, t, h, kv, hd,
                                                     causal, window, dtype):
    """stats: (B * H, sq_pad) float2 with sq_pad = Sq rounded up to 64;
    part: 2 x split x B x T x KV x hd floats when the heads are split,
    none otherwise; the split divides g and the third kernel runs only
    then."""
    note = SOURCE.read_text()
    assert "(B * H, sq_pad) float2" in note
    assert re.search(r"partials to `part` \(2 x split x B x T x KV x hd\s+"
                     r"floats", note)
    plan = tflash.bwd_plan(b, sq, t, h, kv, hd, dtype, causal, window)
    sq_pad = -(-sq // 64) * 64
    assert (plan.sq_pad, plan.stats_floats) == (sq_pad, 2 * b * h * sq_pad)
    assert (h // kv) % plan.split == 0
    assert plan.part_floats == (2 * plan.split * b * t * kv * hd
                                if plan.split > 1 else 0)
    assert plan.kernels()[-1] == ("flash_bwd_reduce_kernel"
                                  if plan.split > 1
                                  else plan.kernels()[1])
    assert plan.pair == (causal and window is None and t > 64)


@pytest.mark.parametrize("b,dtype,split", [(4, torch.bfloat16, 1),
                                           (2, torch.float32, 2)],
                         ids=["bf16-4x2048", "f32-2x2048"])
def test_training_shapes_run_one_balanced_wave(b, dtype, split):
    """At LLM training's shapes (tinyllama-1.1b: 32/4 heads of 64, causal,
    2048 tokens) the dk/dv units pair key blocks j and 31 - j, fill one
    wave of the card's 2 x 132 slots, and each walks the same number of
    steps: no SM waits on a heaviest CTA."""
    plan = tflash.bwd_plan(b, 2048, 2048, 32, 4, 64, dtype, True, None)
    assert plan.pair and plan.split == split
    assert plan.n_units == 256 <= tflash.SMS * tflash.BWD_CTAS_PER_SM
    _, dkdv = tflash.bwd_steps(plan, b, 2048, 2048, 32, 4, True, None)
    assert len({len(unit) for unit in dkdv}) == 1
    n_qb = 2048 // plan.q_block       # pairs see n_qb + 64 / q_block blocks
    assert len(dkdv[0]) == 32 // split // 4 * (n_qb + 64 // plan.q_block)


@pytest.mark.parametrize("hd", tflash.HEAD_DIMS)
def test_plan_q_block_is_the_kernels(hd):
    """The dk/dv query block that ``bwd_plan`` lays out is the one the
    kernels compile at each head dim: ``dkdv_q_block`` (bfloat16) and
    ``dkdv_f32_q_block`` (float32), read from the source."""
    src = SOURCE.read_text()
    for fn, dtype in (("dkdv_q_block", torch.bfloat16),
                      ("dkdv_f32_q_block", torch.float32)):
        m = re.search(r"constexpr int " + fn + r"\(\) \{\s*return HD == "
                      r"(\d+) \? (\d+) : (\d+);", src)
        want = int(m.group(2)) if hd == int(m.group(1)) else int(m.group(3))
        plan = tflash.bwd_plan(1, 64, 64, 1, 1, hd, dtype)
        assert plan.q_block == want, fn


@pytest.mark.parametrize("dtype,seq,units", [(torch.bfloat16, 1024, 256),
                                             (torch.float32, 512, 128)],
                         ids=["bf16-1x1024", "f32-1x512"])
def test_zamba2_training_shapes_plan(dtype, seq, units):
    """At zamba2-2.7b's training shapes (its shared attention: 32/32 heads
    of 80, causal, one sequence) the dk/dv units pair key blocks, the
    heads are not split (g = 1), every unit walks the same number of
    steps, and one wave of the card's 2 x 132 slots holds them."""
    plan = tflash.bwd_plan(1, seq, seq, 32, 32, 80, dtype, True, None)
    assert plan.pair and plan.split == 1 and plan.part_floats == 0
    assert plan.n_units == units <= tflash.SMS * tflash.BWD_CTAS_PER_SM
    _, dkdv = tflash.bwd_steps(plan, 1, seq, seq, 32, 32, True, None)
    n_qb = seq // plan.q_block        # pairs see n_qb + 64 / q_block blocks
    assert {len(unit) for unit in dkdv} == {n_qb + 64 // plan.q_block}


@pytest.mark.parametrize("b,dtype,gflop,bound", [
    (4, torch.bfloat16, 171.882577920, 0.173794),
    (2, torch.float32, 85.941288960, 1.282706)],
    ids=["bf16-4x2048", "f32-2x2048"])
def test_bwd_cost_is_pinned_at_training_shapes(b, dtype, gflop, bound):
    """The yardstick does not move with the kernels: five products of 2 hd
    a visible pair and q head (172 and 86 GFLOP), operation-bound at 989
    TFLOP/s (bf16 tensor cores) and 67 TFLOP/s (f32 CUDA cores), whatever
    computes them."""
    q = torch.empty((b, 2048, 32, 64), dtype=dtype, device="meta")
    kv = torch.empty((b, 2048, 4, 64), dtype=dtype, device="meta")
    lse = torch.empty((b, 32, 2048), device="meta")
    n_ops, n_bytes = tflash.flash_attention_bwd_cost(q, kv, kv, q, lse, q)
    assert n_ops == round(gflop * 1e9)
    peak = 989e12 if dtype == torch.bfloat16 else 67e12
    assert n_bytes / 3.35e12 < n_ops / peak
    assert round(n_ops / peak * 1e3, 6) == bound


# (b, sq, t, h, kv, hd, window, q_offset), causal: as the forward's
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
def test_offset_plan_covers_every_visible_block_once(b, sq, t, h, kv, hd,
                                                     window, q_offset,
                                                     dtype):
    """Under a query offset both kernels walk each visible block once and
    no other; without a window the key blocks every row sees whole run one
    a unit, the ones the diagonal crosses are paired so that no live unit
    walks more than one query block a head more than another, and the
    blocks past the last row's position get no unit (their dk and dv are
    zeroed by the launch)."""
    plan = tflash.bwd_plan(b, sq, t, h, kv, hd, dtype, True, window,
                           q_offset)
    dq, dkdv = tflash.bwd_steps(plan, b, sq, t, h, kv, True, window,
                                q_offset)
    assert len(dkdv) == plan.n_units
    for steps, qn, kn in ((dq, tflash.BWD_TILE, plan.k_block),
                          (dkdv, plan.q_block, tflash.BWD_TILE)):
        flat = [s for cta in steps for s in cta]
        assert len(flat) == len(set(flat))
        assert set(flat) == _visible(b, sq, t, h, qn, kn, True, window,
                                     q_offset)
    if window is None:
        last = q_offset + sq - 1
        assert plan.pair_lo == min(plan.n_kb, (q_offset + 1) // 64)
        assert plan.pair_hi == min(plan.n_kb, last // 64 + 1)
        assert {s[3] for u in dkdv for s in u} == set(range(plan.pair_hi))
        per_head = (h // kv) // plan.split
        work = [len(u) / per_head for u in dkdv]
        step = 64 // plan.q_block
        assert max(work) - min(work) <= 2 * step, (max(work), min(work))
    pairs = int(tflash.attention_mask(sq, t, True, window, "cpu",
                                      q_offset).sum())
    q = torch.empty((b, sq, h, hd), dtype=dtype, device="meta")
    kvt = torch.empty((b, t, kv, hd), dtype=dtype, device="meta")
    lse = torch.empty((b, h, sq), device="meta")
    n_ops, _ = tflash.flash_attention_bwd_cost(q, kvt, kvt, q, lse, q, True,
                                               window, q_offset)
    assert n_ops == 10 * hd * pairs * b * h
