"""The port's CUDA kernels against their plain PyTorch versions, on a card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU and
skips without one. This file imports neither ``jax`` nor ``repro``, so it
runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graphs import make_synthetic_dataset  # noqa: E402
from repro_torch.kernels import extract_gather as teg  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import fused_layer as tfl  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import spmm_ell as tspmm  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graph():
    return make_synthetic_dataset(n=512, num_classes=4, d_in=8,
                                  avg_degree=10, seed=4).adj_norm


def _extraction_case(graph, diag, per_col, seed=0):
    rng = np.random.default_rng(seed)
    # vertex 0 included: its first edge is CSR slot 0
    pick = lambda k: np.union1d(rng.choice(graph.n_rows, size=k,
                                           replace=False),
                                [0]).astype(np.int32)
    rows = pick(48)
    cols = rows if diag else pick(64)
    scale = (rng.uniform(0.5, 9.0, cols.shape[0]).astype(np.float32)
             if per_col else 3.7)
    return rows, cols, scale


def _tail_case(b, d, has_mask, has_res, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, d)).astype(np.float32) * 2.0
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    mask = rng.random((b, d)) < 0.7 if has_mask else None
    res = rng.normal(size=(b, d)).astype(np.float32) if has_res else None
    return x, scale, mask, res


@pytest.mark.cuda
@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("per_col", [True, False])
def test_cuda_extraction_bitmatches_plain(graph, cuda, diag, per_col):
    rows, cols, scale = _extraction_case(graph, diag, per_col)
    args = [torch.from_numpy(a).to(cuda)
            for a in (graph.indptr, graph.indices, graph.data, rows, cols)]
    sc = (torch.from_numpy(scale).to(cuda) if isinstance(scale, np.ndarray)
          else scale)
    for max_deg in (graph.max_row_nnz(), 3, 0):
        n0 = teg.LAUNCHES
        got = teg.extract_dense_fused(*args, col_scale=sc, diag=diag,
                                      max_deg=max_deg)
        torch.cuda.synchronize()
        assert teg.LAUNCHES == n0 + 1
        ref = teg.extract_dense_plain(*args, col_scale=sc, diag=diag,
                                      max_deg=max_deg)
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_extraction_wide_batch_uses_large_shared_memory(cuda):
    """b_c = 8192 columns: 32 KB of columns staged in shared memory once
    per CTA, 128 rows."""
    big = make_synthetic_dataset(n=8192, num_classes=4, d_in=4,
                                 avg_degree=8, seed=0).adj_norm
    ids = torch.arange(8192, dtype=torch.int32, device=cuda)
    rows = ids[::64].contiguous()
    args = [torch.from_numpy(a).to(cuda)
            for a in (big.indptr, big.indices, big.data)]
    got = teg.extract_dense_fused(*args, rows, ids, col_scale=2.0, diag=True,
                                  max_deg=big.max_row_nnz())
    ref = teg.extract_dense_plain(*args, rows, ids, col_scale=2.0, diag=True,
                                  max_deg=big.max_row_nnz())
    assert torch.equal(got, ref)


@pytest.fixture(scope="module")
def big_graph():
    return make_synthetic_dataset(n=65536, num_classes=4, d_in=4,
                                  avg_degree=8, seed=1).adj_norm


# (b_r, b_c, diag, cols at an odd element offset): the training shape; b_c
# above 29,056 columns, more than 227 KB of shared memory can stage
# (searched in global memory); b_c % 4 != 0, so rows start off 16-byte
# alignment, with the columns staged by 4-byte loads from a view one
# element in
@pytest.mark.cuda
@pytest.mark.parametrize("b_r,b_c,diag,odd_cols", [
    (8192, 8192, True, False), (256, 40000, False, False),
    (300, 1027, False, True)])
def test_cuda_extraction_large_and_ragged_bitmatch_plain(
        big_graph, cuda, b_r, b_c, diag, odd_cols):
    rng = np.random.default_rng(b_c)
    cols_np = np.sort(rng.choice(big_graph.n_rows, size=b_c,
                                 replace=False)).astype(np.int32)
    rows_np = cols_np if diag else np.sort(rng.choice(
        big_graph.n_rows, size=b_r, replace=False)).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda)
            for a in (big_graph.indptr, big_graph.indices, big_graph.data)]
    rows = torch.from_numpy(rows_np).to(cuda)
    cols = torch.from_numpy(cols_np).to(cuda)
    if odd_cols:
        flat = torch.zeros(b_c + 1, dtype=torch.int32, device=cuda)
        flat[1:] = cols
        cols = flat[1:]
        assert cols.data_ptr() % 16 != 0 and cols.is_contiguous()
    kw = dict(col_scale=3.7, diag=diag, max_deg=big_graph.max_row_nnz())
    n0 = teg.LAUNCHES
    got = teg.extract_dense_fused(*args, rows, cols, **kw)
    torch.cuda.synchronize()
    assert teg.LAUNCHES == n0 + 1
    ref = teg.extract_dense_plain(*args, rows, cols, **kw)
    assert torch.count_nonzero(ref) > 0
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("diag", [True, False])
def test_cuda_extraction_duplicate_edges_within_rounding(graph, cuda, diag):
    """A CSR whose rows repeat edges: the kernel adds ``val * scale`` per
    edge, the plain version scales the sum, so a repeated cell differs by
    rounding only: within 1e-6 of the largest |output|."""
    indptr, indices, data = graph.indptr, graph.indices, graph.data
    rp, ci, val = [0], [], []
    for r in range(graph.n_rows):
        lo, hi = indptr[r], indptr[r + 1]
        # each row's first two edges once more, at the row's end
        ci.extend(indices[lo:hi].tolist() + indices[lo:min(hi, lo + 2)]
                  .tolist())
        val.extend(data[lo:hi].tolist() + (data[lo:min(hi, lo + 2)] * 0.37)
                   .tolist())
        rp.append(len(ci))
    csr = [torch.tensor(a, dtype=t, device=cuda)
           for a, t in ((rp, torch.int32), (ci, torch.int32),
                        (val, torch.float32))]
    rows, cols, scale = _extraction_case(graph, diag, True)
    args = [*csr, torch.from_numpy(rows).to(cuda),
            torch.from_numpy(cols).to(cuda)]
    kw = dict(col_scale=torch.from_numpy(scale).to(cuda), diag=diag,
              max_deg=int(np.diff(rp).max()))
    n0 = teg.LAUNCHES
    got = teg.extract_dense_fused(*args, **kw)
    torch.cuda.synchronize()
    assert teg.LAUNCHES == n0 + 1
    ref = teg.extract_dense_plain(*args, **kw)
    once = teg.extract_dense_plain(
        *[torch.from_numpy(a).to(cuda) for a in (indptr, indices, data)],
        *args[3:], **kw)
    assert not torch.equal(ref, once)       # some repeated edge was kept
    err = (got - ref).abs().max().item()
    assert err <= 1e-6 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", [(256, 256), (300, 33), (5, 1), (8192, 256),
                                 (64, 130)])
@pytest.mark.parametrize("has_mask,has_res", [(False, False), (True, True)])
@pytest.mark.parametrize("use_rmsnorm", [True, False])
def test_cuda_fused_tail_matches_plain(cuda, b, d, has_mask, has_res,
                                       use_rmsnorm):
    """f32, the sum of squares reduced in another order: 1e-5 relative.
    d = 256 takes the vector route, 33, 1 and 130 (d % 4 != 0) the scalar
    one; the launch is counted once, on its route."""
    x, scale, mask, res = _tail_case(b, d, has_mask, has_res)
    t = lambda a: None if a is None else torch.from_numpy(a).to(cuda)
    kw = dict(dropout_rate=0.3 if has_mask else 0.0, eps=1e-6,
              use_rmsnorm=use_rmsnorm, use_relu=True)
    route = "vector" if d % 4 == 0 else "scalar"
    n0, r0 = tfl.LAUNCHES, dict(tfl.ROUTE_LAUNCHES)
    got = tfl.fused_layer(t(x), t(scale), t(mask), t(res), **kw)
    torch.cuda.synchronize()
    assert tfl.LAUNCHES == n0 + 1
    assert tfl.ROUTE_LAUNCHES == {**r0, route: r0[route] + 1}
    ref = tfl.fused_layer_plain(t(x), t(scale), t(mask), t(res), **kw)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("odd", ["x", "residual", "mask"])
def test_cuda_fused_tail_odd_offset_view_takes_scalar_route(cuda, odd):
    """A contiguous view one element into its storage is not 16-byte (or,
    for the mask, 4-byte) aligned: the call takes the scalar route and
    matches the plain version (1e-5 relative)."""
    x, scale, mask, res = (None if a is None else torch.from_numpy(a).to(cuda)
                           for a in _tail_case(96, 256, True, True))
    views = {"x": x, "residual": res, "mask": mask}
    a = views[odd]
    flat = torch.zeros(a.numel() + 1, dtype=a.dtype, device=cuda)
    flat[1:] = a.reshape(-1)
    views[odd] = flat[1:].view(a.shape)
    assert views[odd].is_contiguous() and torch.equal(views[odd], a)
    kw = dict(dropout_rate=0.3, eps=1e-6)
    n0, r0 = tfl.LAUNCHES, dict(tfl.ROUTE_LAUNCHES)
    got = tfl.fused_layer(views["x"], scale, views["mask"], views["residual"],
                          **kw)
    torch.cuda.synchronize()
    assert tfl.LAUNCHES == n0 + 1
    assert tfl.ROUTE_LAUNCHES == {**r0, "scalar": r0["scalar"] + 1}
    ref = tfl.fused_layer_plain(x, scale, mask, res, **kw)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 33])
@pytest.mark.parametrize("dropout_rate", [0.3, 0.1, 2.0 / 3.0])
def test_cuda_fused_tail_dropout_divides_correctly_rounded(cuda, d,
                                                           dropout_rate):
    """With the norm, the ReLU and the residual off, a kept element is
    v / keep_prob correctly rounded on both routes (the vector route at
    d = 256 from the corrected reciprocal product, the scalar one at
    d = 33 by division): bit for bit the float32 quotient numpy gives."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(512, d)) * 10.0).astype(np.float32)
    mask = rng.random((512, d)) < 0.5
    keep = np.float32(1.0 - dropout_rate)
    want = np.where(mask, x / keep, np.float32(0.0))
    r0 = dict(tfl.ROUTE_LAUNCHES)
    got = tfl.fused_layer(torch.from_numpy(x).to(cuda),
                          torch.ones(d, device=cuda),
                          torch.from_numpy(mask).to(cuda), None,
                          dropout_rate=dropout_rate, use_rmsnorm=False,
                          use_relu=False)
    route = "vector" if d % 4 == 0 else "scalar"
    assert tfl.ROUTE_LAUNCHES == {**r0, route: r0[route] + 1}
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def _key(cuda, key=0xC0FFEE):
    from repro_torch.core import sampling as tsmp
    return tsmp.key_tensor(key, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", [(256, 256), (300, 33), (8192, 256),
                                 (64, 130), (5, 1)])
@pytest.mark.parametrize("has_res", [False, True])
@pytest.mark.parametrize("use_rmsnorm", [True, False])
def test_cuda_counter_tail_equals_bytes_tail(cuda, b, d, has_res,
                                            use_rmsnorm):
    """The forward and the backward with the counter's keep bits
    (``dropout_key``) against the same calls fed ``keep_mask``'s mask of
    that key: bit for bit, on both routes; the counter source is counted
    on its own, once a call."""
    from repro_torch.kernels import counter_rng as crng
    x, scale, _, res = _tail_case(b, d, False, has_res)
    t = lambda a: None if a is None else torch.from_numpy(a).to(cuda)
    g = torch.randn((b, d), device=cuda)
    key = _key(cuda, 2 ** 64 - 3)
    kw = dict(dropout_rate=0.3, eps=1e-6, use_rmsnorm=use_rmsnorm,
              use_relu=True)
    mask = crng.keep_mask(key, b, d, 0.3)
    s0 = dict(tfl.SOURCE_LAUNCHES)
    got = tfl.fused_layer(t(x), t(scale), None, t(res), dropout_key=key,
                          **kw)
    assert tfl.SOURCE_LAUNCHES == {**s0, "counter": s0["counter"] + 1}
    assert torch.equal(got, tfl.fused_layer(t(x), t(scale), mask, t(res),
                                            **kw))
    dx, ds = tfl.fused_layer_bwd(g, t(x), t(scale), None, dropout_key=key,
                                 **kw)
    dx2, ds2 = tfl.fused_layer_bwd(g, t(x), t(scale), mask, **kw)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


def _bwd_err(got, ref, terms=0.0):
    """dx and d_scale each within 1e-5 of the largest |plain|; for dx at
    least 1e-5 of ``terms``, the size of the two terms whose difference dx
    is (inv * g' * scale and x * inv^3 * dot / d): at d = 1 RMSNorm's
    Jacobian is zero up to eps, and both versions' dx is the rounding of
    their difference."""
    for a, w, t in zip(got, ref, (terms, 0.0)):
        limit = 1e-5 * max(w.abs().max().item(), t)
        assert (a - w).abs().max().item() <= limit


def _bwd_terms(g, x, scale, keep_prob, use_rmsnorm):
    """The largest inv * |g * scale| / keep_prob (inv = 1 without
    RMSNorm): the size of dx's terms."""
    inv = torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) \
        if use_rmsnorm else 1.0
    return (inv * (g * scale).abs() / keep_prob).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", [(256, 256), (300, 33), (8192, 256),
                                 (64, 130), (5, 1)])
@pytest.mark.parametrize("source", ["none", "bytes", "counter"])
@pytest.mark.parametrize("use_rmsnorm,use_relu", [(True, True),
                                                  (True, False),
                                                  (False, True),
                                                  (False, False)])
def test_cuda_tail_bwd_matches_plain(cuda, b, d, source, use_rmsnorm,
                                     use_relu):
    """dx and d_scale of the backward kernel against its plain version
    within 1e-5 of the largest |plain| (dx at least 1e-5 of its terms'
    size), on the vector route (d % 4 == 0) and the scalar one, counted
    once a call on its route; d_scale exact zeros without RMSNorm."""
    x, scale, mask, _ = _tail_case(b, d, source == "bytes", False)
    t = lambda a: None if a is None else torch.from_numpy(a).to(cuda)
    g = torch.randn((b, d), device=cuda)
    key = _key(cuda) if source == "counter" else None
    kw = dict(dropout_rate=0.0 if source == "none" else 0.3, eps=1e-6,
              use_rmsnorm=use_rmsnorm, use_relu=use_relu, dropout_key=key)
    route = "vector" if d % 4 == 0 else "scalar"
    n0, r0 = tfl.BWD_LAUNCHES, dict(tfl.BWD_ROUTE_LAUNCHES)
    got = tfl.fused_layer_bwd(g, t(x), t(scale), t(mask), **kw)
    torch.cuda.synchronize()
    assert tfl.BWD_LAUNCHES == n0 + 1
    assert tfl.BWD_ROUTE_LAUNCHES == {**r0, route: r0[route] + 1}
    _bwd_err(got, tfl.fused_layer_bwd_plain(g, t(x), t(scale), t(mask),
                                            **kw),
             _bwd_terms(g, t(x), t(scale), 1.0 - kw["dropout_rate"],
                        use_rmsnorm))
    if not use_rmsnorm:
        assert not got[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", [(8192, 256), (300, 33), (20000, 128)])
def test_cuda_tail_bwd_is_bit_identical_over_repeated_calls(cuda, b, d):
    """d_scale is summed in a fixed order (no float atomics): 10 calls give
    the same bits, on both routes and past 2048 rows (several rows a
    warp)."""
    x, scale, _, _ = _tail_case(b, d, False, False)
    t = lambda a: torch.from_numpy(a).to(cuda)
    g = torch.randn((b, d), device=cuda)
    outs = [tfl.fused_layer_bwd(g, t(x), t(scale), None,
                                dropout_key=_key(cuda), dropout_rate=0.3)
            for _ in range(10)]
    for o in outs[1:]:
        assert torch.equal(o[0], outs[0][0]) and torch.equal(o[1],
                                                             outs[0][1])
    _bwd_err(outs[0], tfl.fused_layer_bwd_plain(
        g, t(x), t(scale), None, dropout_key=_key(cuda), dropout_rate=0.3))


@pytest.mark.cuda
def test_cuda_tail_bwd_captured_replays_equal_eager_calls(cuda):
    """Ten replays of a CUDA graph that captured one ``fused_layer_bwd``
    at the training shape, counter keep bits, give the bits of ten eager
    calls, dx and d_scale (the partial is taken per call from the graph's
    pool, d_scale summed in a fixed order)."""
    x, scale, _, _ = (None if a is None else torch.from_numpy(a).to(cuda)
                      for a in _tail_case(8192, 256, False, False))
    g = torch.randn((8192, 256), device=cuda)
    kw = dict(dropout_key=_key(cuda), dropout_rate=0.3)
    eager = [tfl.fused_layer_bwd(g, x, scale, None, **kw) for _ in range(10)]
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfl.fused_layer_bwd(g, x, scale, None, **kw)
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=side):
            out = tfl.fused_layer_bwd(g, x, scale, None, **kw)
    torch.cuda.current_stream().wait_stream(side)
    for want in eager:
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    del graph


@pytest.mark.cuda
@pytest.mark.parametrize("odd", ["g", "x", "mask"])
def test_cuda_tail_bwd_odd_offset_view_takes_scalar_route(cuda, odd):
    """A contiguous view one element into its storage is not aligned for
    the vector route: the backward takes the scalar route and matches the
    plain version."""
    x, scale, mask, _ = (None if a is None else torch.from_numpy(a).to(cuda)
                         for a in _tail_case(96, 256, True, False))
    views = {"g": torch.randn((96, 256), device=cuda), "x": x, "mask": mask}
    a = views[odd]
    flat = torch.zeros(a.numel() + 1, dtype=a.dtype, device=cuda)
    flat[1:] = a.reshape(-1)
    views[odd] = flat[1:].view(a.shape)
    r0 = dict(tfl.BWD_ROUTE_LAUNCHES)
    got = tfl.fused_layer_bwd(views["g"], views["x"], scale, views["mask"],
                              dropout_rate=0.3)
    assert tfl.BWD_ROUTE_LAUNCHES == {**r0, "scalar": r0["scalar"] + 1}
    _bwd_err(got, tfl.fused_layer_bwd_plain(views["g"], x, scale, mask,
                                            dropout_rate=0.3))


@pytest.mark.cuda
@pytest.mark.parametrize("has_res", [False, True])
def test_cuda_tail_autograd_runs_the_bwd_kernel(cuda, has_res):
    """``ops.fused_layer_tail`` with a key on the card: one forward and one
    backward launch, no keep-mask; the gradients of x, scale and the
    residual against autograd through the plain version (1e-5 of the
    largest)."""
    from repro_torch.kernels import counter_rng as crng
    x, scale, _, res = _tail_case(512, 256, False, True)
    w = torch.randn((512, 256), device=cuda)
    key = _key(cuda)
    grads = []
    for fn in ("kernel", "plain"):
        tx, ts, tr = (torch.from_numpy(a).to(cuda).requires_grad_(True)
                      for a in (x, scale, res))
        counts = (tfl.LAUNCHES, tfl.BWD_LAUNCHES, crng.MASK_LAUNCHES)
        if fn == "kernel":
            y = tops.fused_layer_tail(tx, tr if has_res else None, ts,
                                      dropout_key=key, dropout_rate=0.3)
        else:
            y = tfl.fused_layer_plain(tx, ts, None,
                                      tr if has_res else None,
                                      dropout_key=key, dropout_rate=0.3)
        (y * w).sum().backward()
        if fn == "kernel":
            assert (tfl.LAUNCHES, tfl.BWD_LAUNCHES, crng.MASK_LAUNCHES) == (
                counts[0] + 1, counts[1] + 1, counts[2])
        grads.append([tx.grad, ts.grad] + ([tr.grad] if has_res else []))
    _bwd_err(grads[0], grads[1])


@pytest.mark.cuda
def test_cuda_tail_bwd_entry_point_rejects_bad_launch_shape(cuda):
    """The backward's C entry point launches nothing, and returns 1
    (cudaErrorInvalidValue), for chunks outside 0-8 or a grid that does
    not cover the rows."""
    from repro_torch.kernels import _build
    lib = _build.load()
    g = torch.ones((64, 8), device=cuda)
    scale = torch.ones(8, device=cuda)
    dx = torch.full((64, 8), 7.0, device=cuda)
    part = torch.zeros((64, 8), device=cuda)
    ds = torch.full((8,), 7.0, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for chunks, grid, rpw in ((9, 8, 1), (-1, 8, 1), (1, 1, 1), (1, 7, 1),
                              (1, 8, 0), (0, 0, 8)):
        rc = lib.repro_fused_layer_bwd(
            g.data_ptr(), g.data_ptr(), scale.data_ptr(), None, None,
            dx.data_ptr(), part.data_ptr(), ds.data_ptr(), 64, 8, 1e-6, 1.0,
            0, 1, 1, chunks, grid, rpw, stream)
        assert rc == 1, (chunks, grid, rpw)
    torch.cuda.synchronize()
    assert bool((dx == 7.0).all()) and bool((ds == 7.0).all())


@pytest.mark.cuda
def test_cuda_extraction_entry_point_rejects_bad_launch_shape(cuda):
    """The C entry point launches nothing, and returns 1
    (cudaErrorInvalidValue), for rows_per_cta outside 1-16 or a grid that
    does not cover the rows."""
    from repro_torch.kernels import _build
    lib = _build.load()
    rp = torch.zeros(9, dtype=torch.int32, device=cuda)
    ci = torch.zeros(1, dtype=torch.int32, device=cuda)
    val = torch.zeros(1, device=cuda)
    ids = torch.arange(8, dtype=torch.int32, device=cuda)
    out = torch.full((8, 8), 7.0, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for grid, rows_per_cta in ((1, 17), (1, 0), (1, 4), (3, 2)):
        rc = lib.repro_extract_dense_fused(
            rp.data_ptr(), ci.data_ptr(), val.data_ptr(), ids.data_ptr(),
            ids.data_ptr(), None, 1.0, 1, 8, 8, 1, grid, rows_per_cta, 1, 0,
            out.data_ptr(), stream)
        assert rc == 1, (grid, rows_per_cta)
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="scale"):
        tfl.fused_layer(x, torch.zeros(7, device=cuda), None, None)
    with pytest.raises(ValueError, match="x must"):
        tfl.fused_layer(x.double(), torch.zeros(8, device=cuda), None, None)
    with pytest.raises(ValueError, match="x must"):
        tfl.fused_layer(x.t(), torch.zeros(4, device=cuda), None, None)
    with pytest.raises(ValueError, match="g must"):
        tfl.fused_layer_bwd(x[:2], x, torch.zeros(8, device=cuda), None)
    with pytest.raises(ValueError, match="dropout_key"):
        tfl.fused_layer(x, torch.zeros(8, device=cuda), None, None,
                        dropout_key=torch.zeros(1, dtype=torch.int64,
                                                device=cuda))
    with pytest.raises(ValueError, match="not both"):
        tfl.fused_layer_bwd(x, x, torch.zeros(8, device=cuda),
                            torch.ones((4, 8), dtype=torch.bool,
                                       device=cuda),
                            dropout_key=_key(cuda), dropout_rate=0.3)
    i = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="rp"):
        teg.extract_dense_fused(i, i, torch.zeros(4, device=cuda), i, i,
                                col_scale=1.0, diag=True, max_deg=2)


def _ell_case(bm, bn, n_rb, n_cb, d, density, seed=0, extra_slots=1):
    """A random block matrix as block-ELL (one padding slot or more) and a
    feature matrix with n_cb * bn rows."""
    rng = np.random.default_rng(seed)
    keep = rng.random((n_rb, 1, n_cb, 1)) < density
    dense = (rng.normal(size=(n_rb, bm, n_cb, bn)) * keep).astype(np.float32)
    dense = dense.reshape(n_rb * bm, n_cb * bn)
    n_slots = min(int(keep.sum((1, 2, 3)).max()) + extra_slots, n_cb)
    tiles, colidx = tspmm.dense_to_block_ell(torch.from_numpy(dense), bm, bn,
                                             max(n_slots, 1))
    x = rng.normal(size=(n_cb * bn, d)).astype(np.float32)
    return tiles, colidx, torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn,n_rb,n_cb,d", [
    (8, 8, 4, 4, 16), (16, 32, 2, 4, 64), (32, 16, 4, 2, 8),
    (8, 128, 2, 2, 128), (128, 128, 4, 8, 256), (8, 8, 4, 4, 37)])
@pytest.mark.parametrize("density", [0.2, 0.7])
def test_cuda_spmm_ell_matches_plain(cuda, bm, bn, n_rb, n_cb, d, density):
    """f32 sums in another order: 1e-4 relative to the largest output; the
    reference's sweep, the training tile and a ragged d."""
    tiles, colidx, x = (t.to(cuda) for t in _ell_case(bm, bn, n_rb, n_cb, d,
                                                      density))
    n0 = tspmm.LAUNCHES
    got = tspmm.spmm_ell(tiles, colidx, x)
    torch.cuda.synchronize()
    assert tspmm.LAUNCHES == n0 + 1
    ref = tspmm.spmm_ell_plain(tiles, colidx, x)
    err = (got - ref).abs().max().item()
    assert err <= 1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
def test_cuda_spmm_ell_bf16_matches_plain(cuda):
    """bf16 in and out, f32 accumulation: 5e-2, the reference's bf16
    tolerance."""
    tiles, colidx, x = _ell_case(16, 16, 2, 2, 40, 0.8, seed=1)
    tiles, colidx = tiles.to(cuda, torch.bfloat16), colidx.to(cuda)
    x = x.to(cuda, torch.bfloat16)
    got = tspmm.spmm_ell(tiles, colidx, x)
    ref = tspmm.spmm_ell_plain(tiles, colidx, x)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), atol=5e-2,
                               rtol=5e-2)


@pytest.mark.cuda
def test_cuda_spmm_ell_autograd_matches_plain(cuda):
    """The autograd rule around the kernel against autograd through the
    plain version: dX and dTiles within 1e-4 relative."""
    tiles, colidx, x = (t.to(cuda) for t in _ell_case(32, 32, 3, 4, 24, 0.5,
                                                      seed=2))
    w = torch.randn((96, 24), device=cuda)
    grads = []
    n0 = tspmm.DX_LAUNCHES
    for fn in (tops.spmm_ell, tspmm.spmm_ell_plain):
        t = tiles.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        (fn(t, colidx, xx) * w).sum().backward()
        grads.append((t.grad, xx.grad))
    assert tspmm.DX_LAUNCHES == n0 + 1         # the rule's dX is the kernel
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0,
                                                         b.abs().max().item())


# the slots of three row-blocks: a live tile's column-block, or None for
# padding (an all-zero tile at column-block 0)
PADDED_LAYOUT = [[3, None, 1, None, 2],   # padding between live slots
                 [2, None, 0, 1, None],   # a live column-block-0 tile, slot 2
                 [None] * 5]              # a row-block that is all padding


def _padded_ell_case(bm, bn, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    n_rb, n_slots, n_cb = len(PADDED_LAYOUT), len(PADDED_LAYOUT[0]), 4
    tiles = rng.normal(size=(n_rb, n_slots, bm, bn)).astype(np.float32)
    colidx = np.zeros((n_rb, n_slots), np.int32)
    for i, row in enumerate(PADDED_LAYOUT):
        for s, cb in enumerate(row):
            if cb is None:
                tiles[i, s] = 0.0
            else:
                colidx[i, s] = cb
    x = rng.normal(size=(n_cb * bn, d)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)
    return t(tiles).to(dtype), t(colidx), t(x).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn,d", [(128, 128, 256), (16, 32, 37),
                                     (8, 8, 16)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_cuda_spmm_ell_skips_padding_in_any_slot(cuda, bm, bn, d, dtype,
                                                 tol):
    """The kernel finds padding from the tile, not from colidx: padding
    between live slots, a live column-block-0 tile in slot 2 and a
    row-block of padding only (exact zeros), against the plain version
    (f32 1e-4, bf16 5e-2, relative to the largest output)."""
    tiles, colidx, x = _padded_ell_case(bm, bn, d, dtype, cuda)
    got = tspmm.spmm_ell(tiles, colidx, x)
    torch.cuda.synchronize()
    ref = tspmm.spmm_ell_plain(tiles, colidx, x)
    assert got.dtype == dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * max(1.0, ref.float().abs().max().item())
    assert torch.count_nonzero(got[2 * bm:]) == 0


@pytest.mark.cuda
def test_cuda_spmm_ell_padding_ignores_non_finite_x(cuda):
    """A skipped padding tile reads no x: inf in column-block 0 reaches the
    row-block whose block-0 tile is live and leaves the one whose block-0
    slots are padding finite (the plain version's 0 * inf gives NaN)."""
    tiles, colidx, x = _padded_ell_case(32, 32, 64, torch.float32, cuda)
    x[:32] = float("inf")
    got = tspmm.spmm_ell(tiles, colidx, x)
    torch.cuda.synchronize()
    assert torch.isfinite(got[:32]).all()
    assert not torch.isfinite(got[32:64]).all()
    assert torch.count_nonzero(got[64:]) == 0


@pytest.mark.cuda
def test_cuda_spmm_ell_rejects_bad_inputs(cuda):
    tiles, colidx, x = (t.to(cuda) for t in _ell_case(8, 8, 2, 2, 4, 0.7))
    with pytest.raises(ValueError, match="colidx"):
        tspmm.spmm_ell(tiles, colidx.long(), x)
    with pytest.raises(ValueError, match="tiles"):
        tspmm.spmm_ell(tiles.double(), colidx, x)
    with pytest.raises(ValueError, match="multiple of bn"):
        tspmm.spmm_ell(tiles, colidx, x[:-1])


def _dx_grad(n_rows, d, dtype, device, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(n_rows, d)).astype(
        np.float32)).to(device, dtype)


def _dx_err(got, ref):
    """max |kernel - plain| over the largest |plain|."""
    err = (got.float() - ref.float()).abs().max().item()
    return err / max(ref.float().abs().max().item(), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn,n_rb,n_cb,d", [
    (8, 8, 4, 4, 16), (16, 32, 2, 4, 64), (32, 16, 4, 2, 8),
    (8, 128, 2, 2, 128), (128, 128, 4, 8, 256), (8, 8, 4, 4, 37),
    (128, 128, 3, 5, 300)])
@pytest.mark.parametrize("density", [0.2, 0.7])
def test_cuda_spmm_ell_dx_matches_plain(cuda, bm, bn, n_rb, n_cb, d,
                                        density):
    """dX = A^T g in f32: within 1e-5 of the largest |dX| of the plain
    version (the same products summed in another order); the reference's
    tile sweep, the training tile, a ragged d and two feature tiles."""
    tiles, colidx, _ = (t.to(cuda) for t in _ell_case(bm, bn, n_rb, n_cb, d,
                                                      density))
    g = _dx_grad(n_rb * bm, d, torch.float32, cuda)
    n0 = tspmm.DX_LAUNCHES
    got = tspmm.spmm_ell_dx(tiles, colidx, g, n_cb * bn)
    torch.cuda.synchronize()
    assert tspmm.DX_LAUNCHES == n0 + 1 and got.shape == (n_cb * bn, d)
    assert _dx_err(got, tspmm.spmm_ell_dx_plain(tiles, colidx, g,
                                                n_cb * bn)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn,d", [(128, 128, 256), (16, 32, 37),
                                     (8, 8, 16)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
def test_cuda_spmm_ell_dx_skips_padding_in_any_slot(cuda, bm, bn, d, dtype,
                                                    tol):
    """Padding between live slots, a live column-block-0 tile in slot 2 and
    a row-block of padding only, in f32 (1e-5) and bf16 tiles and g (5e-2,
    the reference's bf16 tolerance), relative to the largest |dX|; the
    column block no live tile points at is exactly zero."""
    tiles, colidx, _ = _padded_ell_case(bm, bn, d, dtype, cuda)
    n_rows = 4 * bn
    g = _dx_grad(tiles.shape[0] * bm, d, dtype, cuda)
    got = tspmm.spmm_ell_dx(tiles, colidx, g, n_rows)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _dx_err(got, tspmm.spmm_ell_dx_plain(tiles, colidx, g,
                                                n_rows)) <= tol
    # column blocks 0-3 are all live somewhere; a fifth would not be
    wide = tspmm.spmm_ell_dx(tiles, colidx, g, n_rows + bn)
    assert torch.equal(wide[:n_rows], got)
    assert torch.count_nonzero(wide[n_rows:]) == 0


@pytest.mark.cuda
def test_cuda_spmm_ell_dx_is_bit_identical_over_repeated_calls(cuda):
    """The same inputs give the same bits ten times over: no float is added
    with an atomic. A batch-like layout: 16 row-blocks of 32 slots of
    128 x 128, most slots padding, so column block 0 holds many slots."""
    tiles, colidx, _ = _ell_case(128, 128, 16, 16, 256, 0.3, seed=5,
                                 extra_slots=16)
    tiles, colidx = tiles.to(cuda), colidx.to(cuda)
    g = _dx_grad(16 * 128, 256, torch.float32, cuda)
    first = tspmm.spmm_ell_dx(tiles, colidx, g, 16 * 128)
    for _ in range(9):
        assert torch.equal(tspmm.spmm_ell_dx(tiles, colidx, g, 16 * 128),
                           first)
    assert _dx_err(first, tspmm.spmm_ell_dx_plain(tiles, colidx, g,
                                                  16 * 128)) <= 1e-5


@pytest.mark.cuda
def test_cuda_spmm_ell_dx_padding_ignores_non_finite_g(cuda):
    """As in the forward: a row-block of padding only reads no g, so inf
    there leaves dX finite (the plain version's 0 * inf gives NaN in
    column block 0)."""
    tiles, colidx, _ = _padded_ell_case(32, 32, 64, torch.float32, cuda)
    g = _dx_grad(3 * 32, 64, torch.float32, cuda)
    g[64:] = float("inf")
    got = tspmm.spmm_ell_dx(tiles, colidx, g, 4 * 32)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert not torch.isfinite(tspmm.spmm_ell_dx_plain(tiles, colidx, g,
                                                      4 * 32)).all()


@pytest.mark.cuda
def test_cuda_spmm_ell_dx_rejects_bad_inputs(cuda):
    tiles, colidx, _ = (t.to(cuda) for t in _ell_case(8, 8, 2, 2, 4, 0.7))
    g = _dx_grad(16, 4, torch.float32, cuda)
    with pytest.raises(ValueError, match="colidx"):
        tspmm.spmm_ell_dx(tiles, colidx.long(), g, 16)
    with pytest.raises(ValueError, match="tiles"):
        tspmm.spmm_ell_dx(tiles.double(), colidx, g, 16)
    with pytest.raises(ValueError, match="multiple of bn"):
        tspmm.spmm_ell_dx(tiles, colidx, g, 15)
    with pytest.raises(ValueError, match="g must be"):
        tspmm.spmm_ell_dx(tiles, colidx, g.half(), 16)


# ---------------------------------------------------------------------------
# The bf16 routes of block_dtype="bf16": the extraction's bf16 block, and
# the SpMM's and dX's bf16 tiles with a float32 operand
# ---------------------------------------------------------------------------

def _bf16_ulp(x: float) -> float:
    """One bf16 unit in the last place at magnitude x (8 bits of
    precision)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("per_col", [True, False])
def test_cuda_extraction_bf16_bitmatches_plain(graph, cuda, diag, per_col):
    """The bf16 route: bit for bit its plain version (float32 values
    rounded once), which is the float32 block's cast, at every max_deg;
    counted on its own route."""
    rows, cols, scale = _extraction_case(graph, diag, per_col)
    args = [torch.from_numpy(a).to(cuda)
            for a in (graph.indptr, graph.indices, graph.data, rows, cols)]
    sc = (torch.from_numpy(scale).to(cuda) if isinstance(scale, np.ndarray)
          else scale)
    for max_deg in (graph.max_row_nnz(), 3, 0):
        n0 = teg.ROUTE_LAUNCHES["bf16"]
        got = teg.extract_dense_fused(*args, col_scale=sc, diag=diag,
                                      max_deg=max_deg, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert teg.ROUTE_LAUNCHES["bf16"] == n0 + 1
        assert got.dtype == torch.bfloat16
        ref = teg.extract_dense_plain(*args, col_scale=sc, diag=diag,
                                      max_deg=max_deg, dtype=torch.bfloat16)
        assert torch.equal(got, ref)
        f32 = teg.extract_dense_fused(*args, col_scale=sc, diag=diag,
                                      max_deg=max_deg)
        assert torch.equal(got, f32.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("b_r,b_c,diag,odd_cols", [
    (8192, 8192, True, False), (256, 40000, False, False),
    (300, 1027, False, True)])
def test_cuda_extraction_bf16_large_and_ragged_bitmatch_plain(
        big_graph, cuda, b_r, b_c, diag, odd_cols):
    """The training shape, columns searched in global memory, and b_c =
    1027 (bf16 rows start off 16-byte alignment: a scalar head and tail
    around the 16-byte zero stores), bit for bit."""
    rng = np.random.default_rng(b_c)
    cols_np = np.sort(rng.choice(big_graph.n_rows, size=b_c,
                                 replace=False)).astype(np.int32)
    rows_np = cols_np if diag else np.sort(rng.choice(
        big_graph.n_rows, size=b_r, replace=False)).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda)
            for a in (big_graph.indptr, big_graph.indices, big_graph.data)]
    rows = torch.from_numpy(rows_np).to(cuda)
    cols = torch.from_numpy(cols_np).to(cuda)
    if odd_cols:
        flat = torch.zeros(b_c + 1, dtype=torch.int32, device=cuda)
        flat[1:] = cols
        cols = flat[1:]
    kw = dict(col_scale=3.7, diag=diag, max_deg=big_graph.max_row_nnz(),
              dtype=torch.bfloat16)
    got = teg.extract_dense_fused(*args, rows, cols, **kw)
    torch.cuda.synchronize()
    ref = teg.extract_dense_plain(*args, rows, cols, **kw)
    assert torch.count_nonzero(ref) > 0
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("diag", [True, False])
def test_cuda_extraction_bf16_duplicate_edges_within_an_ulp(graph, cuda,
                                                            diag):
    """Departure 2 on the bf16 route: where a row repeats an edge every
    bf16 atomic add rounds, so a repeated cell is within one bf16 ulp of
    the largest |output| of the plain version (sum in float32, round
    once)."""
    indptr, indices, data = graph.indptr, graph.indices, graph.data
    rp, ci, val = [0], [], []
    for r in range(graph.n_rows):
        lo, hi = indptr[r], indptr[r + 1]
        ci.extend(indices[lo:hi].tolist() + indices[lo:min(hi, lo + 2)]
                  .tolist())
        val.extend(data[lo:hi].tolist() + (data[lo:min(hi, lo + 2)] * 0.37)
                   .tolist())
        rp.append(len(ci))
    csr = [torch.tensor(a, dtype=t, device=cuda)
           for a, t in ((rp, torch.int32), (ci, torch.int32),
                        (val, torch.float32))]
    rows, cols, scale = _extraction_case(graph, diag, True)
    args = [*csr, torch.from_numpy(rows).to(cuda),
            torch.from_numpy(cols).to(cuda)]
    kw = dict(col_scale=torch.from_numpy(scale).to(cuda), diag=diag,
              max_deg=int(np.diff(rp).max()), dtype=torch.bfloat16)
    got = teg.extract_dense_fused(*args, **kw)
    torch.cuda.synchronize()
    ref = teg.extract_dense_plain(*args, **kw).float()
    err = (got.float() - ref).abs().max().item()
    assert err <= _bf16_ulp(ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn,n_rb,n_cb,d", [
    (8, 8, 4, 4, 16), (16, 32, 2, 4, 64), (32, 16, 4, 2, 8),
    (8, 128, 2, 2, 128), (128, 128, 4, 8, 256), (8, 8, 4, 4, 37),
    (8, 12, 3, 3, 20)])
@pytest.mark.parametrize("density", [0.2, 0.7])
def test_cuda_spmm_ell_bf16_tiles_f32_x_matches_plain(cuda, bm, bn, n_rb,
                                                      n_cb, d, density):
    """bf16 tiles with a float32 x: a float32 output within 1e-4 of the
    largest |output| of the plain version (the tile converted to float32,
    float32 FMAs); bn = 12 takes the plain-load path (12 bf16 are not whole
    16-byte pieces). Counted on its own route."""
    tiles, colidx, x = (t.to(cuda) for t in _ell_case(bm, bn, n_rb, n_cb, d,
                                                      density))
    tiles = tiles.to(torch.bfloat16)
    n0 = tspmm.ROUTE_LAUNCHES["bf16_f32"]
    got = tspmm.spmm_ell(tiles, colidx, x)
    torch.cuda.synchronize()
    assert tspmm.ROUTE_LAUNCHES["bf16_f32"] == n0 + 1
    assert got.dtype == torch.float32
    ref = tspmm.spmm_ell_plain(tiles, colidx, x)
    err = (got - ref).abs().max().item()
    assert err <= 1e-4 * max(1.0, ref.abs().max().item())
    # the f32 route on the same values gives the same products
    same = tspmm.spmm_ell(tiles.float(), colidx, x)
    assert (same - got).abs().max().item() <= 1e-4 * max(
        1.0, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn,d", [(128, 128, 256), (16, 32, 37),
                                     (8, 8, 16)])
def test_cuda_spmm_ell_bf16_tiles_skip_padding_in_any_slot(cuda, bm, bn, d):
    """The padding layout on the bf16-tile / f32 route: 1e-4 of the
    largest output, the all-padding row-block exactly zero."""
    tiles, colidx, x = _padded_ell_case(bm, bn, d, torch.float32, cuda)
    tiles = tiles.to(torch.bfloat16)
    got = tspmm.spmm_ell(tiles, colidx, x)
    torch.cuda.synchronize()
    ref = tspmm.spmm_ell_plain(tiles, colidx, x)
    assert got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= 1e-4 * max(
        1.0, ref.abs().max().item())
    assert torch.count_nonzero(got[2 * bm:]) == 0


@pytest.mark.cuda
def test_cuda_spmm_ell_bf16_tiles_padding_ignores_non_finite_x(cuda):
    """Departure 1 on the bf16-tile route: a skipped padding tile reads no
    x."""
    tiles, colidx, x = _padded_ell_case(32, 32, 64, torch.float32, cuda)
    tiles = tiles.to(torch.bfloat16)
    x[:32] = float("inf")
    got = tspmm.spmm_ell(tiles, colidx, x)
    torch.cuda.synchronize()
    assert torch.isfinite(got[:32]).all()
    assert not torch.isfinite(got[32:64]).all()
    assert torch.count_nonzero(got[64:]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn,n_rb,n_cb,d", [
    (8, 8, 4, 4, 16), (16, 32, 2, 4, 64), (32, 16, 4, 2, 8),
    (128, 128, 4, 8, 256), (8, 8, 4, 4, 37), (128, 128, 3, 5, 300),
    (8, 12, 3, 3, 20)])
@pytest.mark.parametrize("density", [0.2, 0.7])
def test_cuda_spmm_ell_dx_bf16_tiles_f32_g_matches_plain(cuda, bm, bn, n_rb,
                                                         n_cb, d, density):
    """dX = A^T g with bf16 tiles and a float32 g: a float32 dX within 1e-5
    of the largest |dX| of the plain version, bit-identical over repeated
    calls; counted on its own route."""
    tiles, colidx, _ = (t.to(cuda) for t in _ell_case(bm, bn, n_rb, n_cb, d,
                                                      density))
    tiles = tiles.to(torch.bfloat16)
    g = _dx_grad(n_rb * bm, d, torch.float32, cuda)
    n0 = tspmm.DX_ROUTE_LAUNCHES["bf16_f32"]
    got = tspmm.spmm_ell_dx(tiles, colidx, g, n_cb * bn)
    torch.cuda.synchronize()
    assert tspmm.DX_ROUTE_LAUNCHES["bf16_f32"] == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (n_cb * bn, d)
    assert _dx_err(got, tspmm.spmm_ell_dx_plain(tiles, colidx, g,
                                                n_cb * bn)) <= 1e-5
    for _ in range(3):
        assert torch.equal(tspmm.spmm_ell_dx(tiles, colidx, g, n_cb * bn),
                           got)


@pytest.mark.cuda
def test_cuda_spmm_ell_dx_bf16_tiles_padding(cuda):
    """The padding layout on the bf16-tile / f32 route (1e-5; the column
    block no tile points at exactly zero), and a row-block of padding only
    reads no g: inf there leaves dX finite."""
    tiles, colidx, _ = _padded_ell_case(32, 32, 64, torch.float32, cuda)
    tiles = tiles.to(torch.bfloat16)
    g = _dx_grad(3 * 32, 64, torch.float32, cuda)
    got = tspmm.spmm_ell_dx(tiles, colidx, g, 5 * 32)
    torch.cuda.synchronize()
    assert _dx_err(got, tspmm.spmm_ell_dx_plain(tiles, colidx, g,
                                                5 * 32)) <= 1e-5
    assert torch.count_nonzero(got[4 * 32:]) == 0
    g[64:] = float("inf")
    got = tspmm.spmm_ell_dx(tiles, colidx, g, 4 * 32)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()


@pytest.mark.cuda
def test_cuda_spmm_ell_bf16_tiles_autograd_runs_the_dx_kernel(cuda):
    """``ops.spmm_ell`` with bf16 tiles and a float32 x that requires grad:
    the forward and dX kernels on the bf16-tile route, dX float32 within
    1e-5 of autograd through the plain version; the tiles get no
    gradient."""
    tiles, colidx, x = (t.to(cuda) for t in _ell_case(32, 32, 3, 4, 24, 0.5,
                                                      seed=2))
    tiles = tiles.to(torch.bfloat16)
    w = torch.randn((96, 24), device=cuda)
    grads = []
    n0 = tspmm.DX_ROUTE_LAUNCHES["bf16_f32"]
    for fn in (tops.spmm_ell, tspmm.spmm_ell_plain):
        xx = x.clone().requires_grad_(True)
        (fn(tiles, colidx, xx) * w).sum().backward()
        grads.append(xx.grad)
    assert tspmm.DX_ROUTE_LAUNCHES["bf16_f32"] == n0 + 1
    assert grads[0].dtype == torch.float32
    assert _dx_err(grads[0], grads[1]) <= 1e-5


@pytest.mark.cuda
def test_cuda_bf16_wrappers_reject_other_pairs(cuda):
    """The routes are exactly: all float32, all bfloat16, bf16 tiles with a
    float32 operand; the extraction writes float32 or bfloat16."""
    tiles, colidx, x = (t.to(cuda) for t in _ell_case(8, 8, 2, 2, 8, 0.7))
    with pytest.raises(ValueError, match="bfloat16 tiles with a float32"):
        tspmm.spmm_ell(tiles, colidx, x.bfloat16())
    with pytest.raises(ValueError, match="bfloat16 tiles with a float32"):
        tspmm.spmm_ell_dx(tiles, colidx, _dx_grad(16, 8, torch.bfloat16,
                                                  cuda), 16)
    i = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        teg.extract_dense_fused(i, i, torch.zeros(4, device=cuda), i, i,
                                col_scale=1.0, diag=True, max_deg=2,
                                dtype=torch.float16)
    # the C entry points launch nothing for a route code they do not know
    from repro_torch.kernels import _build
    lib = _build.load()
    out = torch.full((16, 8), 7.0, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert lib.repro_spmm_ell(tiles.data_ptr(), colidx.data_ptr(),
                              x.data_ptr(), out.data_ptr(), 2, tiles.shape[1],
                              8, 8, 2, 8, 3, stream) == 1
    work = torch.empty((1 << 12,), dtype=torch.uint8, device=cuda)
    assert lib.repro_spmm_ell_dx(tiles.data_ptr(), colidx.data_ptr(),
                                 x.data_ptr(), out.data_ptr(),
                                 work.data_ptr(), 2, tiles.shape[1], 8, 8, 2,
                                 8, 3, stream) == 1
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())


# ---------------------------------------------------------------------------
# The step walk of both SpMM kernels (csrc/spmm_steps.cuh): a warp adds only
# its live steps, 8 rows x 1 column in the forward and 1 row x 8 columns in
# the dX; layouts where the skip logic turns, on all three routes
# ---------------------------------------------------------------------------

SPMM_ROUTES = {"f32": (torch.float32, torch.float32),
               "bf16": (torch.bfloat16, torch.bfloat16),
               "bf16_f32": (torch.bfloat16, torch.float32)}
STEP_CASES = ["diagonal", "warp_edges", "full_row_and_column", "dense",
              "train_like"]


def _step_case(name, seed=0):
    """(tiles, colidx, n_cb) in float32 numpy: 128 x 128 tiles whose
    nonzeros sit where the kernels' units of work begin and end."""
    rng = np.random.default_rng(seed)
    if name == "diagonal":            # a self-loop a row, padding beside
        tiles = np.zeros((2, 3, 128, 128), np.float32)
        colidx = np.zeros((2, 3), np.int32)
        for rb in range(2):
            tiles[rb, 1] = np.diag(rng.uniform(0.5, 2.0, 128))
            colidx[rb, 1] = rb
        return tiles, colidx, 2
    if name == "warp_edges":
        # one nonzero a tile, at the rows and columns where a warp's 8 end
        # (7/8, 15/16, 23/24) and at a chunk's first and last (0, 31), in
        # a different chunk of each tile
        edges = [(0, 31), (7, 24), (8, 23), (15, 16), (16, 15), (23, 8),
                 (24, 7), (31, 0)]
        tiles = np.zeros((2, 4, 128, 128), np.float32)
        colidx = np.zeros((2, 4), np.int32)
        for n, (r, c) in enumerate(edges):
            rb, s = divmod(n, 4)
            tiles[rb, s, r + 32 * (n % 4), c + 32 * (3 - n % 4)] = \
                rng.uniform(0.5, 2.0) * (-1) ** n
            colidx[rb, s] = n % 3
        return tiles, colidx, 3
    if name == "full_row_and_column":
        # every column of a chunk live in one row (the forward's dense loop
        # for one warp only), every row of one in one column (the dX's)
        tiles = np.zeros((2, 2, 128, 128), np.float32)
        tiles[0, 0, 5, 0:32] = rng.normal(size=32)
        tiles[0, 1, 70, 64:96] = rng.normal(size=32)
        tiles[1, 0, 0:32, 40] = rng.normal(size=32)
        tiles[1, 1, 96:128, 127] = rng.normal(size=32)
        return tiles, np.array([[1, 0], [0, 1]], np.int32), 2
    if name == "dense":
        tiles = rng.normal(size=(2, 2, 128, 128)).astype(np.float32)
        return tiles, np.array([[0, 1], [1, 0]], np.int32), 2
    if name == "train_like":
        # a sampled batch: a self-loop on every row and ~0.1 other edges a
        # row, as block-ELL with the extraction's slot layout
        n = 1024
        adj = np.diag(rng.uniform(0.5, 2.0, n)).astype(np.float32)
        rows = np.flatnonzero(rng.random(n) < 0.1)
        adj[rows, rng.integers(0, n, rows.size)] += rng.uniform(
            0.1, 1.0, rows.size).astype(np.float32)
        tiles, colidx = tspmm.dense_to_block_ell_ranked(
            torch.from_numpy(adj), 128, 128, 8)
        return tiles.numpy(), colidx.numpy(), n // 128
    raise ValueError(name)


def _step_tensors(name, route, cuda, d=256, odd=False, seed=0):
    """The case's tiles and colidx, x (n_cb * 128 rows) and g (n_rb * 128
    rows) of width d on the card in the route's types; with ``odd`` the
    tiles, x and g are views one element past 16-byte alignment (the
    kernels' plain-load path)."""
    tiles, colidx, n_cb = _step_case(name)
    ta, tx = SPMM_ROUTES[route]
    rng = np.random.default_rng(seed + 1)

    def on_card(a, dtype):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(cuda, dtype)
        if not odd:
            return t
        flat = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    x = rng.normal(size=(n_cb * 128, d)).astype(np.float32)
    g = rng.normal(size=(tiles.shape[0] * 128, d)).astype(np.float32)
    return (on_card(tiles, ta), torch.from_numpy(colidx).to(cuda),
            on_card(x, tx), on_card(g, tx), n_cb * 128)


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(SPMM_ROUTES))
@pytest.mark.parametrize("name", STEP_CASES)
def test_cuda_spmm_ell_step_layouts_match_plain(cuda, name, route):
    """The forward on each layout and route: within 1e-4 (bf16 in and
    out: 5e-2) of the largest output of the plain version, the same bits
    over repeated calls, and on the bf16-tile route the float32 route's
    bits on the same values (the same FMAs in the same order)."""
    tiles, colidx, x, _, _ = _step_tensors(name, route, cuda)
    got = tspmm.spmm_ell(tiles, colidx, x)
    torch.cuda.synchronize()
    ref = tspmm.spmm_ell_plain(tiles, colidx, x).float()
    tol = 5e-2 if x.dtype == torch.bfloat16 else 1e-4
    assert (got.float() - ref).abs().max().item() <= tol * max(
        1.0, ref.abs().max().item())
    for _ in range(3):
        assert torch.equal(tspmm.spmm_ell(tiles, colidx, x), got)
    if route == "bf16_f32":
        assert torch.equal(tspmm.spmm_ell(tiles.float(), colidx, x), got)


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(SPMM_ROUTES))
@pytest.mark.parametrize("name", STEP_CASES)
def test_cuda_spmm_ell_dx_step_layouts_match_plain(cuda, name, route):
    """The dX on each layout and route: within 1e-5 (bf16 in and out:
    5e-2) of the largest |dX| of the plain version, the same bits over
    repeated calls, and on the bf16-tile route the float32 route's bits."""
    tiles, colidx, _, g, n_rows = _step_tensors(name, route, cuda)
    got = tspmm.spmm_ell_dx(tiles, colidx, g, n_rows)
    torch.cuda.synchronize()
    ref = tspmm.spmm_ell_dx_plain(tiles, colidx, g, n_rows)
    tol = 5e-2 if g.dtype == torch.bfloat16 else 1e-5
    assert _dx_err(got, ref) <= tol
    for _ in range(3):
        assert torch.equal(tspmm.spmm_ell_dx(tiles, colidx, g, n_rows), got)
    if route == "bf16_f32":
        assert torch.equal(tspmm.spmm_ell_dx(tiles.float(), colidx, g,
                                             n_rows), got)


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(SPMM_ROUTES))
@pytest.mark.parametrize("d,odd", [(37, False), (300, False), (256, True),
                                   (37, True)])
def test_cuda_spmm_ell_step_walk_ragged_and_unaligned(cuda, route, d, odd):
    """A training-like batch at a ragged d, two feature tiles, and tiles,
    x and g one element off 16-byte alignment (plain loads): both kernels
    within their limits of the plain versions, repeatable bit for bit,
    and the aligned path's bits where only the alignment differs."""
    tiles, colidx, x, g, n_rows = _step_tensors("train_like", route, cuda,
                                                d=d, odd=odd)
    tol_f, tol_b = ((5e-2, 5e-2) if x.dtype == torch.bfloat16
                    else (1e-4, 1e-5))
    fwd = tspmm.spmm_ell(tiles, colidx, x)
    dx = tspmm.spmm_ell_dx(tiles, colidx, g, n_rows)
    torch.cuda.synchronize()
    ref = tspmm.spmm_ell_plain(tiles, colidx, x).float()
    assert (fwd.float() - ref).abs().max().item() <= tol_f * max(
        1.0, ref.abs().max().item())
    assert _dx_err(dx, tspmm.spmm_ell_dx_plain(tiles, colidx, g,
                                               n_rows)) <= tol_b
    assert torch.equal(tspmm.spmm_ell(tiles, colidx, x), fwd)
    assert torch.equal(tspmm.spmm_ell_dx(tiles, colidx, g, n_rows), dx)
    if odd:
        t2, x2, g2 = (v.clone() for v in (tiles, x, g))
        assert torch.equal(tspmm.spmm_ell(t2, colidx, x2), fwd)
        assert torch.equal(tspmm.spmm_ell_dx(t2, colidx, g2, n_rows), dx)


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(SPMM_ROUTES))
def test_cuda_spmm_ell_zero_step_ignores_non_finite_x(cuda, route):
    """Departure 1 at the skip unit: a live chunk (one nonzero, row 3,
    column 0) whose column 5 is all zero. inf in x's row 5 leaves every
    output finite, because no warp adds that step; the plain version's
    0 * inf gives NaN in all 32 rows of the chunk."""
    ta, tx = SPMM_ROUTES[route]
    tiles = torch.zeros((1, 1, 128, 128), dtype=ta, device=cuda)
    tiles[0, 0, 3, 0] = 2.0
    colidx = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    x = torch.randn((128, 64), device=cuda).to(tx)
    x[5] = float("inf")
    got = tspmm.spmm_ell(tiles, colidx, x)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got[3].float(), (2.0 * x[0].float()).to(tx).float())
    assert torch.count_nonzero(torch.cat([got[:3], got[4:]])) == 0
    assert torch.isnan(tspmm.spmm_ell_plain(tiles, colidx, x)[:32]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(SPMM_ROUTES))
def test_cuda_spmm_ell_dx_zero_step_ignores_non_finite_g(cuda, route):
    """The same in the dX: a live chunk (one nonzero, row 0, column 3)
    whose row 5 is all zero. inf in g's row 5 leaves dX finite, because no
    warp adds that step; the plain version gives NaN in all 32 columns of
    the chunk."""
    ta, tx = SPMM_ROUTES[route]
    tiles = torch.zeros((1, 1, 128, 128), dtype=ta, device=cuda)
    tiles[0, 0, 0, 3] = 2.0
    colidx = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    g = torch.randn((128, 64), device=cuda).to(tx)
    g[5] = float("inf")
    got = tspmm.spmm_ell_dx(tiles, colidx, g, 128)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got[3].float(), (2.0 * g[0].float()).to(tx).float())
    assert torch.count_nonzero(torch.cat([got[:3], got[4:]])) == 0
    assert torch.isnan(tspmm.spmm_ell_dx_plain(tiles, colidx, g,
                                               128)[:32]).all()


def _card_trainer(plan, steps, ckpt_dir=None, prefetch=False, chunk=2):
    from repro_torch import optim as topt
    from repro_torch.train import Trainer, TrainLoopConfig
    opt = topt.AdamW(lr=topt.linear_warmup_cosine(5e-3, 2, 6),
                     weight_decay=1e-4, grad_clip=1.0)
    loop = TrainLoopConfig(total_steps=steps, chunk_size=chunk,
                           ckpt_dir=ckpt_dir, ckpt_every=2 if ckpt_dir
                           else 0, prefetch=prefetch)
    return Trainer(plan, opt, loop, eval_fn=lambda p, g: 0.0)


def _card_plan(cuda, **kw):
    """The block-ELL training plan at a small size on the card (SpMM, its
    dX kernel, the fused tail and extraction, the counter draws)."""
    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as TM
    from repro_torch.core.forward import TrainOptions
    from repro_torch.graphs import build_partitioned_graph
    from repro_torch.tree import tree_map
    ds = make_synthetic_dataset(n=2048, num_classes=4, d_in=16,
                                avg_degree=8, seed=0)
    pg = build_partitioned_graph(ds, g=1)
    cfg = TM.GCNConfig(d_in=16, d_hidden=64, num_layers=3, num_classes=4)
    opts = dict(spmm_impl="ell", fused_elementwise=True, extract_impl="cuda",
                dropout=0.3, seed=4, ell_tile=32, ell_slots=16)
    opts.update(kw)
    plan = fourd.build_plan(pg, cfg, fourd.make_mesh_4d(1, 1, cuda),
                            batch=512, opts=TrainOptions(**opts))
    params0 = TM.init_params(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    return plan, plan.shard_graph(pg), \
        lambda: tree_map(lambda t: t.detach().clone(), params0)


@pytest.mark.cuda
def test_cuda_trainer_resume_is_bit_identical(cuda, tmp_path):
    """On the card, 6 captured steps straight == 3 steps, a save, a
    restore and 3 more, bit for bit (losses and every state leaf): the
    block-ELL SpMM, its dX kernel, the fused tail and extraction, dropout
    on. With the dX of a float-atomic ``index_add_`` this matched only up
    to rounding. The restore runs on the trainer that captured the first
    state, so it drops that graph and captures the restored one."""
    from repro_torch.tree import leaves
    plan, graph, fresh = _card_plan(cuda)
    n0 = tspmm.DX_LAUNCHES
    tr = _card_trainer(plan, 6)
    full, log_full = tr.run(tr.init_state(fresh()), graph)
    # one dX a layer in the warm-up step and one in the capture; the five
    # replays relaunch them without the wrapper
    assert tspmm.DX_LAUNCHES - n0 == 2 * plan.cfg.num_layers
    assert log_full.replays == 5 and log_full.capture_s > 0
    part = _card_trainer(plan, 6, str(tmp_path))
    part.total_steps = 3
    part.run(part.init_state(fresh()), graph)
    part.total_steps = 6
    st, log_b = part.run(part.restore(part.init_state(fresh())), graph)
    assert log_b.replays == 2
    assert log_full.losses[3:] == log_b.losses
    for a, b in zip(leaves(st), leaves(full)):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [False, True])
def test_cuda_captured_steps_bit_identical_to_eager_steps(cuda, prefetch):
    """8 steps of ``Trainer.run`` (a warm-up step, a capture, 7 replays, in
    chunks of 3 with a remainder) and 8 eager ``Trainer.step`` calls from
    the same init: losses and every state leaf bit for bit, the counters
    on the card."""
    from repro_torch.tree import leaves
    plan, graph, fresh = _card_plan(cuda)
    eager = _card_trainer(plan, 8, prefetch=prefetch)
    st_e = eager.init_state(fresh(), graph)
    want = torch.stack([eager.step(st_e, graph) for _ in range(8)])
    tr = _card_trainer(plan, 8, prefetch=prefetch, chunk=3)
    st, log = tr.run(tr.init_state(fresh(), graph), graph)
    assert log.replays == 7 and st.step.device.type == "cuda"
    assert log.losses == want.cpu().tolist()
    for a, b in zip(leaves(st), leaves(st_e)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [False, True])
def test_cuda_captured_bf16_steps_bit_identical_to_eager_steps(cuda,
                                                               prefetch):
    """``block_dtype="bf16"``: 8 captured steps (the bf16 blocks and the
    prefetched bf16 tiles graph buffers) and 8 eager steps from the same
    init, bit for bit; the steps ran the bf16 routes of the extraction,
    the SpMM and its dX, and the loss stays finite."""
    from repro_torch.tree import leaves
    plan, graph, fresh = _card_plan(cuda, block_dtype="bf16")
    eager = _card_trainer(plan, 8, prefetch=prefetch)
    st_e = eager.init_state(fresh(), graph)
    n0 = (teg.ROUTE_LAUNCHES["bf16"], tspmm.ROUTE_LAUNCHES["bf16_f32"],
          tspmm.DX_ROUTE_LAUNCHES["bf16_f32"])
    want = torch.stack([eager.step(st_e, graph) for _ in range(8)])
    assert (teg.ROUTE_LAUNCHES["bf16"] > n0[0]
            and tspmm.ROUTE_LAUNCHES["bf16_f32"] > n0[1]
            and tspmm.DX_ROUTE_LAUNCHES["bf16_f32"] > n0[2])
    tr = _card_trainer(plan, 8, prefetch=prefetch, chunk=3)
    st, log = tr.run(tr.init_state(fresh(), graph), graph)
    assert log.replays == 7
    assert log.losses == want.cpu().tolist()
    assert np.all(np.isfinite(log.losses))
    for a, b in zip(leaves(st), leaves(st_e)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, prefetch", [("partition", False),
                                            ("partition", True),
                                            ("walk", False), ("walk", True)])
def test_cuda_captured_locality_steps_bit_identical_to_eager(cuda, kind,
                                                             prefetch):
    """The partition (epoch schedule) and walk kinds: 8 steps of
    ``Trainer.run`` (captured) and 8 eager ``Trainer.step`` calls from the
    same init give the same losses and state bits; their extraction is the
    plain one, their SpMM, dX, tail and draws the kernels."""
    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as TM
    from repro_torch.core.forward import TrainOptions
    from repro_torch.graphs import build_partitioned_graph
    from repro_torch.tree import leaves, tree_map
    ds = make_synthetic_dataset(n=2048, num_classes=4, d_in=16,
                                avg_degree=8, seed=0)
    clusters = 32 if kind == "partition" else 0
    pg = build_partitioned_graph(ds, g=1, clusters=clusters)
    cfg = TM.GCNConfig(d_in=16, d_hidden=64, num_layers=3, num_classes=4)
    opts = TrainOptions(spmm_impl="ell", fused_elementwise=True,
                        extract_impl="torch", dropout=0.3, seed=4,
                        ell_tile=32, ell_slots=16, sample_kind=kind,
                        sample_mode="epoch" if kind == "partition"
                        else "step", clusters=clusters, walk_len=3,
                        walk_k=6)
    plan = fourd.build_plan(pg, cfg, fourd.make_mesh_4d(1, 1, cuda),
                            batch=512, opts=opts)
    graph = plan.shard_graph(pg)
    params0 = TM.init_params(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    fresh = lambda: tree_map(lambda t: t.detach().clone(), params0)
    eager = _card_trainer(plan, 8, prefetch=prefetch)
    st_e = eager.init_state(fresh(), graph)
    want = torch.stack([eager.step(st_e, graph) for _ in range(8)])
    tr = _card_trainer(plan, 8, prefetch=prefetch, chunk=3)
    st, log = tr.run(tr.init_state(fresh(), graph), graph)
    assert log.replays == 7
    assert log.losses == want.cpu().tolist()
    for a, b in zip(leaves(st), leaves(st_e)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_eager_step_syncs_nowhere(cuda):
    """``Trainer.step`` with prefetch, under
    ``torch.cuda.set_sync_debug_mode("error")``: no operation of the step
    waits for the card (a warm-up step builds the kernels first)."""
    plan, graph, fresh = _card_plan(cuda, sample_mode="epoch")
    tr = _card_trainer(plan, 8, prefetch=True)
    st = tr.init_state(fresh(), graph)
    tr.step(st, graph)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            tr.step(st, graph)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(st.step) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("captured", [False, True])
def test_cuda_side_stream_reads_a_freed_argument_before_its_reuse(cuda,
                                                                  captured):
    """A build's tensor argument that is a temporary (``step + 1``, made on
    the main stream and freed as soon as ``build`` returns) is read on the
    side stream behind a long kernel there, while the main stream takes a
    tensor of its size right after the fork and overwrites it: the build
    still reads the counter, eagerly and in replays of a captured graph,
    whose main branch nothing orders after the side branch's read."""
    from repro_torch.core.pipeline import SideStream
    side = SideStream(cuda)
    step = torch.zeros((), dtype=torch.int64, device=cuda)

    def build(s):
        torch.cuda._sleep(20_000_000)        # the side stream reads s late
        return (s * 1,)

    def body():
        (got,) = side.build(build, step + 1)
        clobber = torch.empty_like(step)     # the freed block's size
        clobber.fill_(-7)
        side.join()
        return got, clobber

    if captured:
        body()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got, clobber = body()
    for v in (4, 9):
        step.fill_(v)
        if captured:
            graph.replay()
        else:
            got, clobber = body()
        torch.cuda.synchronize()
        assert (int(got), int(clobber)) == (v + 1, -7)


@pytest.mark.cuda
def test_cuda_counter_kernels_bit_identical_to_plain(cuda):
    """``hash_keys`` over the 2,449,029 vertices of the training graph and
    ``keep_mask`` at (8192, 256), a ragged (33, 70) and (1, 15), each against
    its plain version on the card and on the CPU, for keys at and above
    2^63."""
    from repro_torch.core import sampling as tsmp
    from repro_torch.kernels import counter_rng as crng
    for key in (0, 12345, 2 ** 63, 2 ** 64 - 1):
        k = tsmp.key_tensor(key, cuda)
        got = crng.hash_keys(k, 2_449_029)
        assert torch.equal(got, crng.hash_keys_plain(k, 2_449_029))
        assert torch.equal(got[:4099].cpu(), crng.hash_keys_plain(
            tsmp.key_tensor(key, "cpu"), 4099))
        for rows, cols in ((8192, 256), (33, 70), (1, 15)):
            for rate in (0.0, 0.3, 0.5):
                m = crng.keep_mask(k, rows, cols, rate)
                assert m.dtype == torch.bool and m.shape == (rows, cols)
                assert torch.equal(m, crng.keep_mask_plain(k, rows, cols,
                                                           rate))
        assert torch.equal(crng.keep_mask(k, 33, 70, 0.3).cpu(),
                           crng.keep_mask_plain(tsmp.key_tensor(key, "cpu"),
                                                33, 70, 0.3))


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["step", "epoch"])
@pytest.mark.parametrize("mode,g", [("exact", 1), ("stratified", 1),
                                    ("stratified", 4)])
def test_cuda_sampled_ids_equal_the_cpus(cuda, schedule, mode, g):
    """The card's sample for (seed, step), drawn from a counter on the
    card, is the CPU's for the same Python step."""
    from repro_torch.core import minibatch as tmb
    from repro_torch.core import sampling as tsmp
    cfg = tsmp.SampleConfig(n_pad=100_000, g=g, batch=8192, e_cap=1)
    b = tmb.MinibatchBuilder(cfg, mode=mode, schedule=schedule, seed=3)
    for step in (0, 1, 11, 12, 25):
        t = torch.tensor(step, dtype=torch.int32, device=cuda)
        assert torch.equal(b.sample_ids(t, None, 2).cpu(),
                           b.sample_ids(step, None, 2, device="cpu"))


# the sweep of tests/test_kernels_flash.py, then ragged Sq and T, hd 128,
# GQA 8:1, a causal window, a window that leaves rows (and whole q tiles)
# with no key, and the LLM serving shape (one prompt of 512, 32 q heads
# over 4 kv heads) and a qwen2-style one (14 q heads over 2, hd 128); then
# hd 80 (zamba2's shared attention): its prefill heads (32/32) causal, a
# causal window with GQA, and non-causal over a ragged T
FLASH_SHAPES = [
    (2, 64, 64, 4, 2, 32, True, None),
    (2, 32, 96, 4, 4, 16, False, None),
    (2, 128, 128, 8, 2, 16, True, 32),
    (2, 64, 100, 2, 1, 32, False, None),
    (2, 256, 256, 2, 2, 64, True, None),
    (3, 100, 77, 4, 2, 64, False, None),
    (1, 130, 130, 4, 1, 128, True, 50),
    (1, 77, 130, 8, 1, 32, False, None),
    (2, 77, 130, 4, 2, 16, True, 40),
    (1, 200, 64, 4, 2, 64, False, 32),
    (1, 512, 512, 32, 4, 64, True, None),
    (1, 512, 512, 14, 2, 128, True, None),
    (1, 512, 512, 32, 32, 80, True, None),
    (2, 130, 130, 4, 2, 80, True, 50),
    (2, 77, 130, 4, 4, 80, False, None),
]
# the LLM training shape at batch 1 (tinyllama-1.1b's 32/4 heads of 64 over
# 2048 tokens), and hd 128 at internlm2's 16/8 heads over a T that is no
# multiple of the 32-key block of the float32 route at hd 128 (causal, and
# longer than Sq without a mask)
FLASH_LONG_SHAPES = [
    (1, 2048, 2048, 32, 4, 64, True, None),
    (1, 333, 333, 16, 8, 128, True, None),
    (2, 200, 333, 16, 8, 128, False, None),
]
FLASH_SHAPES += FLASH_LONG_SHAPES
# the VLM and audio families (chip_smoke phases 6g, 6h): whisper-base's
# encoder (8/8 heads of 64, no mask, 1500 frames) and cross-attention from
# a short prompt, llama-3.2-vision-90b's cross-attention over 1600 patches
# and its causal self-attention (64/8 heads of 128)
FLASH_SHAPES += [
    (1, 1500, 1500, 8, 8, 64, False, None),
    (2, 64, 1500, 8, 8, 64, False, None),
    (1, 128, 1600, 64, 8, 128, False, None),
    (1, 256, 256, 64, 8, 128, True, None),
]


def _flash_case(b, sq, t, h, kv, hd, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to(device, dtype)
    return mk(b, sq, h, hd), mk(b, t, kv, hd), mk(b, t, kv, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,t,h,kv,hd,causal,window", FLASH_SHAPES)
@pytest.mark.parametrize("dtype,route,tol", [(torch.float32, "f32", 1e-4),
                                             (torch.bfloat16, "mma", 1e-2)])
def test_cuda_flash_attention_matches_plain(cuda, b, sq, t, h, kv, hd,
                                            causal, window, dtype, route,
                                            tol):
    """out and lse against the plain dense softmax: f32 sums in another
    order (1e-4); bf16 out, whose p and out are rounded to bf16, within
    1e-2 of 1 + |plain| (an ulp in [1, 2) is 7.8e-3), and its lse, from
    f32 scores, within 1e-4. The launch is counted once, on its route."""
    q, k, v = _flash_case(b, sq, t, h, kv, hd, dtype, cuda)
    n0, r0 = tflash.LAUNCHES, dict(tflash.ROUTE_LAUNCHES)
    out, lse = tflash.flash_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES == n0 + 1
    assert tflash.ROUTE_LAUNCHES == {**r0, route: r0[route] + 1}
    ref, ref_lse = tflash.flash_attention_plain(q, k, v, causal, window)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == (b, h, sq)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,t,h,kv,hd,causal,window",
                         FLASH_LONG_SHAPES + [(2, 77, 130, 4, 2, 16, True,
                                               40)])
def test_cuda_flash_attention_is_bit_identical_over_calls(
        cuda, b, sq, t, h, kv, hd, causal, window, dtype):
    """Nothing is summed across CTAs: repeated calls give the same bits,
    out and lse."""
    q, k, v = _flash_case(b, sq, t, h, kv, hd, dtype, cuda)
    first = tflash.flash_attention(q, k, v, causal, window)
    for _ in range(2):
        again = tflash.flash_attention(q, k, v, causal, window)
        assert all(torch.equal(a, c) for a, c in zip(first, again))


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_bad_inputs(cuda):
    q, k, v = _flash_case(1, 8, 8, 2, 1, 48, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention(q, k, v)
    q, k, v = _flash_case(1, 8, 8, 3, 2, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple"):
        tflash.flash_attention(q, k, v)
    q, k, v = _flash_case(1, 8, 8, 2, 1, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="k must"):
        tflash.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="q must"):
        tflash.flash_attention(q.transpose(1, 2), k, v)
    # both routes go through 16-byte copies: a contiguous view one element
    # in raises
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _flash_case(1, 8, 8, 2, 1, 16, dtype, cuda)
        flat = torch.zeros(q.numel() + 1, dtype=dtype, device=cuda)
        with pytest.raises(ValueError, match="16-byte"):
            tflash.flash_attention(flat[1:].view(q.shape), k, v)


# the backward's shapes: the forward's sweep cut to its kinds (causal,
# window, neither; ragged Sq and T), every head dim, GQA 1, 2, 4 and 8, and
# a row-less window
FLASH_BWD_SHAPES = [
    (2, 64, 64, 4, 2, 32, True, None),
    (2, 32, 96, 4, 4, 16, False, None),
    (2, 128, 128, 8, 2, 16, True, 32),
    (2, 64, 100, 2, 1, 32, False, None),
    (3, 100, 77, 4, 2, 64, False, None),
    (1, 130, 130, 4, 1, 128, True, 50),
    (2, 77, 130, 4, 2, 16, True, 40),
    (1, 200, 64, 4, 2, 64, False, 32),
    (1, 256, 256, 32, 4, 64, True, None),
    (1, 192, 192, 16, 8, 128, True, None),
]
# shapes on which the wrapper's plan pairs key blocks and splits the q heads
# (1 x 2048 of 32/4 heads), MHA (g = 1) causal, and a window with T no
# multiple of 64 or 128
FLASH_BWD_PLAN_SHAPES = [
    (1, 2048, 2048, 32, 4, 64, True, None),
    (2, 300, 300, 4, 4, 64, True, None),
    (2, 333, 333, 8, 2, 64, True, 100),
]
FLASH_BWD_SHAPES += FLASH_BWD_PLAN_SHAPES
# hd 80 (zamba2-2.7b's shared attention; the bfloat16 route's five
# 16-column panels, the float32 route's 5 columns a lane): MHA and GQA
# causal, Sq != T under a window, and without a mask
FLASH_BWD_SHAPES += [
    (1, 256, 256, 32, 32, 80, True, None),
    (2, 150, 150, 8, 2, 80, True, None),
    (2, 100, 133, 8, 2, 80, True, 40),
    (1, 90, 200, 4, 4, 80, False, None),
]
# the VLM and audio families' gradients (chip_smoke phase 7d): vision's
# cross-attention over 1600 patches and causal self-attention at 64/8
# heads of 128, whisper's encoder and cross-attention over 1500 frames
FLASH_BWD_SHAPES += [
    (1, 256, 1600, 64, 8, 128, False, None),
    (1, 256, 256, 64, 8, 128, True, None),
    (1, 1500, 1500, 8, 8, 64, False, None),
    (2, 448, 1500, 8, 8, 64, False, None),
]


def _flash_bwd_case(b, sq, t, h, kv, hd, dtype, device, causal, window,
                    seed=0):
    """q, k, v, the forward's out and lse (the plain version's, so that
    both backwards see the same inputs) and a cotangent."""
    q, k, v = _flash_case(b, sq, t, h, kv, hd, dtype, device, seed)
    out, lse = tflash.flash_attention_plain(q, k, v, causal, window)
    rng = np.random.default_rng(seed + 1)
    dout = torch.from_numpy(rng.normal(size=out.shape).astype(
        np.float32)).to(device, dtype)
    return q, k, v, out, lse, dout


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,t,h,kv,hd,causal,window", FLASH_BWD_SHAPES)
@pytest.mark.parametrize("dtype,route,tol", [(torch.float32, "f32", 1e-4),
                                             (torch.bfloat16, "mma", 5e-2)])
def test_cuda_flash_attention_bwd_matches_plain(cuda, b, sq, t, h, kv, hd,
                                                causal, window, dtype, route,
                                                tol):
    """dq, dk and dv against the plain backward, each within ``tol`` of its
    largest |plain| (f32: sums in another order; bf16: the reference's
    bf16 tolerance, p and ds rounded to bf16 in both). One launch, counted
    on its route; the forward's counts do not move."""
    args = _flash_bwd_case(b, sq, t, h, kv, hd, dtype, cuda, causal, window)
    n0, r0 = tflash.BWD_LAUNCHES, dict(tflash.BWD_ROUTE_LAUNCHES)
    f0 = tflash.LAUNCHES
    got = tflash.flash_attention_bwd(*args, causal, window)
    torch.cuda.synchronize()
    assert tflash.BWD_LAUNCHES == n0 + 1 and tflash.LAUNCHES == f0
    assert tflash.BWD_ROUTE_LAUNCHES == {**r0, route: r0[route] + 1}
    ref = tflash.flash_attention_bwd_plain(*args, causal, window)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == r.shape, name
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol * max(r.float().abs().max().item(), 1e-30), \
            (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
def test_cuda_flash_attention_bwd_is_bit_identical_over_calls(cuda, dtype,
                                                              hd):
    """No float atomics: two calls give the same bits, at every head dim."""
    args = _flash_bwd_case(2, 150, 150, 8, 2, hd, dtype, cuda, True, None)
    first = tflash.flash_attention_bwd(*args, True, None)
    for _ in range(3):
        again = tflash.flash_attention_bwd(*args, True, None)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,t,h,kv,hd,causal,window",
                         FLASH_BWD_PLAN_SHAPES)
def test_cuda_flash_attention_bwd_plans_are_bit_identical_over_calls(
        cuda, b, sq, t, h, kv, hd, causal, window, dtype):
    """The plans that pair key blocks, split the q heads over units and
    sum their partials in a fixed order give the same bits every call."""
    args = _flash_bwd_case(b, sq, t, h, kv, hd, dtype, cuda, causal, window)
    first = tflash.flash_attention_bwd(*args, causal, window)
    for _ in range(2):
        again = tflash.flash_attention_bwd(*args, causal, window)
        assert all(torch.equal(a, c) for a, c in zip(first, again))


# the query offset (row i at position q_offset + i): GQA 4/2 over T 128 at
# Sq 64 and 40, offsets 0, 24, 64 and 88, causal with and without a
# window of 32, at hd 64, 80 and 128; and tinyllama-1.1b's production
# sequence shard (S 4096 over 16 ranks: Sq 256, T 4096, 32/4 heads of 64)
# at the first and the last rank's offsets
FLASH_OFFSET_CASES = [
    (2, sq, 128, 4, 2, hd, o, w) for hd in (64, 80, 128) for sq in (64, 40)
    for o in (0, 24, 64, 88) for w in (None, 32)]
FLASH_OFFSET_CASES += [(1, 256, 4096, 32, 4, 64, 0, None),
                       (1, 256, 4096, 32, 4, 64, 3840, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,t,h,kv,hd,q_offset,window",
                         FLASH_OFFSET_CASES)
@pytest.mark.parametrize("dtype,route,tol,bwd_tol",
                         [(torch.float32, "f32", 1e-4, 1e-4),
                          (torch.bfloat16, "mma", 1e-2, 5e-2)])
def test_cuda_flash_attention_offset_matches_plain(cuda, b, sq, t, h, kv, hd,
                                                   q_offset, window, dtype,
                                                   route, tol, bwd_tol):
    """The forward and the backward under a query offset, against their
    plain versions at the same offset (the tolerances of the offset-free
    tests); one launch each, on its route."""
    q, k, v = _flash_case(b, sq, t, h, kv, hd, dtype, cuda)
    n0, b0 = dict(tflash.ROUTE_LAUNCHES), dict(tflash.BWD_ROUTE_LAUNCHES)
    out, lse = tflash.flash_attention(q, k, v, True, window, q_offset)
    ref, ref_lse = tflash.flash_attention_plain(q, k, v, True, window,
                                                q_offset)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    dout = torch.randn(q.shape, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(1)).to(
                           dtype)
    args = (q, k, v, ref, ref_lse, dout, True, window, q_offset)
    got = tflash.flash_attention_bwd(*args)
    want = tflash.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    assert tflash.ROUTE_LAUNCHES[route] == n0[route] + 1
    assert tflash.BWD_ROUTE_LAUNCHES[route] == b0[route] + 1
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= bwd_tol * max(r.float().abs().max().item(), 1e-30), \
            (name, err)
    # a key past the last row's position gets dk = dv = 0
    last = q_offset + sq
    if last < t:
        assert not got[1][:, last:].any() and not got[2][:, last:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_sequence_shards_recompose(cuda, dtype):
    """A causal call over S 1024 cut into 4 sequence shards with their
    offsets: the shards' out, lse and dq concatenate to the unsharded
    call's bit for bit (each row walks the same key blocks in the same
    order), and their dk and dv sum to its within 1e-5 (f32) or 5e-2 (bf16)
    of the largest |.|."""
    b, s, h, kv, hd, n = 2, 1024, 8, 2, 64, 4
    q, k, v = _flash_case(b, s, s, h, kv, hd, dtype, cuda)
    dout = torch.randn(q.shape, device=cuda).to(dtype)
    out, lse = tflash.flash_attention(q, k, v, True, None)
    full = tflash.flash_attention_bwd(q, k, v, out, lse, dout, True, None)
    rows = s // n
    parts = []
    for r in range(n):
        qs = q[:, r * rows:(r + 1) * rows].contiguous()
        o, l_ = tflash.flash_attention(qs, k, v, True, None, r * rows)
        d = tflash.flash_attention_bwd(
            qs, k, v, o, l_, dout[:, r * rows:(r + 1) * rows].contiguous(),
            True, None, r * rows)
        parts.append((o, l_, *d))
    assert torch.equal(torch.cat([p[0] for p in parts], 1), out)
    assert torch.equal(torch.cat([p[1] for p in parts], 2), lse)
    assert torch.equal(torch.cat([p[2] for p in parts], 1), full[0])
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    for i, name in ((3, "dk"), (4, "dv")):
        total = sum(p[i].float() for p in parts)
        want = full[i - 2].float()
        err = (total - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_autograd_runs_both_kernels(cuda, dtype):
    """``ops.flash_attention`` on CUDA tensors that require grad: the
    forward kernel once, the backward kernel once, and the gradients of
    the plain path (``plain=True``) within the route's tolerance."""
    q, k, v = _flash_case(2, 96, 96, 8, 2, 64, dtype, cuda)
    dout = torch.randn(q.shape, device=cuda).to(dtype)
    grads = {}
    for plain in (False, True):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        f0, b0 = tflash.LAUNCHES, tflash.BWD_LAUNCHES
        out = tops.flash_attention(*leaves, True, None, plain=plain)
        out.backward(dout)
        torch.cuda.synchronize()
        n = 0 if plain else 1
        assert (tflash.LAUNCHES - f0, tflash.BWD_LAUNCHES - b0) == (n, n)
        grads[plain] = [x.grad for x in leaves]
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for a, r in zip(grads[False], grads[True]):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol * r.float().abs().max().item()


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_rejects_bad_inputs(cuda):
    q, k, v, out, lse, dout = _flash_bwd_case(1, 8, 8, 2, 1, 16,
                                              torch.float32, cuda, True, None)
    with pytest.raises(ValueError, match="lse must"):
        tflash.flash_attention_bwd(q, k, v, out, lse.double(), dout)
    with pytest.raises(ValueError, match="dout must"):
        tflash.flash_attention_bwd(q, k, v, out, lse, dout.transpose(1, 2))
    q, k, v, out, lse, dout = _flash_bwd_case(1, 8, 8, 2, 1, 16,
                                              torch.bfloat16, cuda, True,
                                              None)
    flat = torch.zeros(dout.numel() + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention_bwd(q, k, v, out, lse,
                                   flat[1:].view(dout.shape))


def test_llm_engine_without_device_needs_a_card(monkeypatch):
    """``LLMServeOptions(device=None)`` means the card: without one the
    engine raises instead of falling back to the CPU. Runs everywhere."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as TT
    from repro_torch.serve import LLMEngine, LLMServeOptions
    cfg = get_smoke("tinyllama-1.1b")
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        LLMEngine(model, cfg, LLMServeOptions(device=None))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TT.init_params(cfg, torch.Generator())
