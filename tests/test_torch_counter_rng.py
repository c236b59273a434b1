"""The port's counter-based draws (``kernels/counter_rng.py``) and the
samplers built on them, on the CPU.

The reference draws with XLA's threefry, whose bits the port does not
reproduce, so these hold the port to its own definition and to the
reference's sampler properties: the tensor ``fold_in`` / ``step_key`` /
``epoch_key`` give the Python ones' bits (keys at and above 2^63
included); the plain ``hash_keys`` and ``keep_mask`` are pure functions
of their key with the documented bits; the keep rate is ``1 - p``; and
the counter samplers cover, stay disjoint across ranges, sort within each
range and draw uniformly (a chi-square test over 200 draws). The kernels
themselves are held to these plain versions on the card
(``tests/test_torch_cuda_kernels.py``).
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

torch = pytest.importorskip("torch")

from repro_torch.core import minibatch as tmb  # noqa: E402
from repro_torch.core import sampling as tsmp  # noqa: E402
from repro_torch.kernels import counter_rng as crng  # noqa: E402

U64 = hst.integers(0, 2 ** 64 - 1)
# chi-square critical values at p = 0.001 (scipy.stats.chi2.ppf(0.999, df))
CHI2_999 = {63: 103.4424, 127: 181.9930}


def _u64(t: torch.Tensor) -> int:
    return int(t.item()) & crng.MASK64


def _key(k: int) -> torch.Tensor:
    return tsmp.key_tensor(k, "cpu")


@settings(max_examples=200, deadline=None)
@given(U64, U64)
def test_tensor_fold_in_gives_the_python_bits(key, data):
    want = tsmp.fold_in(key, data)
    assert 0 <= want < 2 ** 64
    assert _u64(tsmp.fold_in(_key(key), data)) == want
    assert _u64(tsmp.fold_in(key, _key(data))) == want
    assert _u64(tsmp.fold_in(_key(key), _key(data))) == want


@settings(max_examples=100, deadline=None)
@given(hst.integers(0, 2 ** 40), hst.integers(0, 2 ** 31 - 1),
       hst.integers(0, 63))
def test_tensor_step_and_epoch_keys_give_the_python_bits(seed, step, dp):
    for dtype in (torch.int32, torch.int64):
        t = torch.tensor(step, dtype=dtype)
        assert _u64(tsmp.step_key(seed, t, dp)) == \
            tsmp.step_key(seed, step, dp)
        assert _u64(tsmp.epoch_key(seed, t, dp)) == \
            tsmp.epoch_key(seed, step, dp)


def test_key_tensor_round_trips_keys_at_and_above_2_63():
    for k in (0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, 0x9E3779B97F4A7C15):
        t = tsmp.key_tensor(k, "cpu")
        assert t.dtype == torch.int64 and t.dim() == 0 and _u64(t) == k


@pytest.mark.parametrize("key", [0, 7, 2 ** 63, 2 ** 64 - 1])
def test_hash_keys_plain_is_fold_in_over_the_counter(key):
    n = 257
    got = crng.hash_keys_plain(_key(key), n)
    assert got.dtype == torch.int64 and got.shape == (n,)
    for i in (0, 1, 128, 256):
        assert _u64(got[i]) == tsmp.fold_in(key, i)
    assert torch.equal(got, crng.hash_keys(_key(key), n))
    assert torch.equal(got, crng.hash_keys_plain(_key(key), n))
    # a bijection in i: the keys the sampler argsorts have no ties
    assert torch.unique(got).numel() == n


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.3, 0.5])
def test_keep_mask_plain_bits_and_purity(rate):
    rows, cols = 33, 70
    key = tsmp.fold_in(tsmp.fold_in(5, 2), 9)
    got = crng.keep_mask_plain(_key(key), rows, cols, rate)
    assert got.dtype == torch.bool and got.shape == (rows, cols)
    # the documented test in float32: (fold_in(key, r*cols+c) >> 40)
    # * 2^-24 < float32(1 - rate)
    u = np.array([tsmp.fold_in(key, i) >> 40 for i in range(rows * cols)],
                 dtype=np.float32)
    want = (u * np.float32(2.0 ** -24) < np.float32(1.0 - rate))
    np.testing.assert_array_equal(got.numpy().reshape(-1), want)
    assert torch.equal(got, crng.keep_mask(_key(key), rows, cols, rate))
    other = crng.keep_mask_plain(_key(key + 1), rows, cols, rate)
    assert rate == 0.0 or not torch.equal(got, other)


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("key", [0, 0xC0FFEE, 2 ** 64 - 3])
def test_keep_lanes4_on_32_bit_halves_gives_the_keep_mask_bits(rate, key):
    """The fused tail's draw of four lanes at once (``keep_lanes4`` in
    ``csrc/splitmix64.cuh``), its arithmetic in numpy uint64: lanes i0 ..
    i0 + 3 (i0 % 4 == 0) start from k ^ i0 with e in its two low bits, and
    bits 40-63 of the last product come from 32-bit halves,
    umulhi(lo, C_lo) + lo * C_hi + hi * C_lo mod 2^32, shifted by 8; the
    bits are ``keep_mask_plain``'s."""
    rows, cols = 33, 64
    k = np.uint64(_u64(crng.splitmix64(_key(key))))
    threshold = crng.keep_threshold(rate)
    i0 = np.arange(0, rows * cols, 4, dtype=np.uint64)
    low32 = np.uint64(0xFFFFFFFF)
    c_lo, c_hi = np.uint64(0x133111EB), np.uint64(0x94D049BB)
    got = np.zeros(rows * cols, dtype=bool)
    for e in range(4):
        x = ((k ^ i0) ^ np.uint64(e)) + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        lo, hi = x & low32, x >> np.uint64(32)
        top = (((lo * c_lo) >> np.uint64(32)) + lo * c_hi + hi * c_lo) & low32
        got[i0.astype(np.int64) + e] = (top >> np.uint64(8)) < threshold
    want = crng.keep_mask_plain(_key(key), rows, cols, rate)
    np.testing.assert_array_equal(got, want.numpy().reshape(-1))


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_keep_rate_is_one_minus_p(rate):
    rates = [crng.keep_mask(_key(tsmp.step_key(3, s)), 256, 256,
                            rate).float().mean().item() for s in range(3)]
    assert all(abs(r - (1.0 - rate)) < 0.01 for r in rates), rates
    assert len(set(rates)) == 3


def test_keep_threshold_rejects_rates_outside_0_1():
    for rate in (-0.1, 1.0, 1.5):
        with pytest.raises(ValueError, match="rate"):
            crng.keep_threshold(rate)


def test_wrappers_count_no_launch_on_the_cpu_and_reject_meta():
    h0, m0 = crng.HASH_LAUNCHES, crng.MASK_LAUNCHES
    crng.hash_keys(_key(1), 10)
    crng.keep_mask(_key(1), 4, 4, 0.5)
    assert (crng.HASH_LAUNCHES, crng.MASK_LAUNCHES) == (h0, m0)
    # a meta key: outputs of the right shape and type, no launch
    meta = torch.zeros((), dtype=torch.int64, device="meta")
    h, m = crng.hash_keys(meta, 10), crng.keep_mask(meta, 4, 4, 0.5)
    assert (h.device.type, h.shape, h.dtype) == ("meta", (10,), torch.int64)
    assert (m.device.type, m.shape, m.dtype) == ("meta", (4, 4), torch.bool)
    assert (crng.HASH_LAUNCHES, crng.MASK_LAUNCHES) == (h0, m0)
    with pytest.raises(ValueError, match="0-d int64"):
        crng.hash_keys(torch.zeros(1, dtype=torch.int64), 10)


# ---------------------------------------------------------------------------
# The counter samplers keep the reference's sampler properties
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(hst.integers(16, 64), hst.integers(1, 4), U64)
def test_stratified_sample_is_partition_balanced(n_per, g, key):
    """Each range's ids lie in the range, are distinct and sorted; the
    ranges are disjoint (the reference's property test)."""
    cfg = tsmp.SampleConfig(n_pad=n_per * g * 2, g=g, batch=2 * g, e_cap=8)
    s2d = tsmp.sample_stratified(_key(key), cfg).numpy()
    assert s2d.shape == (g, 2) and s2d.dtype == np.int32
    for i in range(g):
        lo, hi = i * cfg.n_local, (i + 1) * cfg.n_local
        assert np.all((s2d[i] >= lo) & (s2d[i] < hi))
        assert np.all(np.diff(s2d[i]) > 0)
    assert len(np.unique(s2d)) == s2d.size


@pytest.mark.parametrize("mode", ["exact", "stratified"])
def test_epoch_slices_are_disjoint_and_cover(mode):
    """The slices of one epoch's permutation are disjoint, sorted, and
    cover every vertex once, with the slice index a Python int or a
    device counter."""
    g = 1 if mode == "exact" else 3
    cfg = tsmp.SampleConfig(n_pad=96, g=g, batch=12, e_cap=1)
    key = _key(tsmp.epoch_key(5, 1, 0))
    draw = (lambda t: tsmp.sample_epoch_exact(key, 96, 12, t)[None]) \
        if mode == "exact" else \
        (lambda t: tsmp.sample_epoch_stratified(key, cfg, t))
    parts = [draw(t) for t in range(8)]
    for t, p in enumerate(parts):
        assert torch.equal(p, draw(torch.tensor(t, dtype=torch.int32)))
        assert bool((p[:, 1:] > p[:, :-1]).all())
    seen = torch.cat([p.reshape(-1) for p in parts]).sort().values
    assert torch.equal(seen, torch.arange(96, dtype=torch.int32))


@pytest.mark.parametrize("mode,n,batch,g", [("exact", 64, 16, 1),
                                            ("stratified", 128, 32, 2)])
def test_sampler_is_uniform_chi_square_over_200_draws(mode, n, batch, g):
    """Each vertex is drawn with probability batch / n: over 200 step
    keys, the counts pass a chi-square test at p = 0.001."""
    cfg = tsmp.SampleConfig(n_pad=n, g=g, batch=batch, e_cap=1)
    b = tmb.MinibatchBuilder(cfg, mode=mode, seed=11)
    counts = np.zeros(n)
    for step in range(200):
        np.add.at(counts, b.sample_ids(step, None, 0, device="cpu").numpy()
                  .reshape(-1), 1)
    expect = 200 * batch / n
    chi2 = float(np.sum((counts - expect) ** 2 / expect))
    assert counts.sum() == 200 * batch
    assert chi2 < CHI2_999[n - 1], chi2


def test_sample_ids_with_a_device_counter_draw_the_int_steps_ids():
    cfg = tsmp.SampleConfig(n_pad=240, g=2, batch=24, e_cap=1)
    for schedule in ("step", "epoch"):
        b = tmb.MinibatchBuilder(cfg, schedule=schedule, seed=2)
        for step in (0, 9, 10, 23):
            t = torch.tensor(step, dtype=torch.int32)
            want = b.sample_ids(step, None, 1, device="cpu")
            assert torch.equal(b.sample_ids(t, None, 1), want)
            assert torch.equal(b.sample_ids(t, b.epoch_of(t), 1), want)
            assert int(b.epoch_of(t)) == b.epoch_of(step)
