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
from repro_torch.kernels import fused_layer as tfl  # noqa: E402


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
    """b_c = 8192 columns need 64 KB of shared memory, above the default
    48 KB a launch gets without opting in."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", [(256, 256), (300, 33), (5, 1)])
@pytest.mark.parametrize("has_mask,has_res", [(False, False), (True, True)])
@pytest.mark.parametrize("use_rmsnorm", [True, False])
def test_cuda_fused_tail_matches_plain(cuda, b, d, has_mask, has_res,
                                       use_rmsnorm):
    """f32, the sum of squares reduced in another order: 1e-5 relative."""
    x, scale, mask, res = _tail_case(b, d, has_mask, has_res)
    t = lambda a: None if a is None else torch.from_numpy(a).to(cuda)
    kw = dict(dropout_rate=0.3 if has_mask else 0.0, eps=1e-6,
              use_rmsnorm=use_rmsnorm, use_relu=True)
    n0 = tfl.LAUNCHES
    got = tfl.fused_layer(t(x), t(scale), t(mask), t(res), **kw)
    torch.cuda.synchronize()
    assert tfl.LAUNCHES == n0 + 1
    ref = tfl.fused_layer_plain(t(x), t(scale), t(mask), t(res), **kw)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="scale"):
        tfl.fused_layer(x, torch.zeros(7, device=cuda), None, None)
    with pytest.raises(ValueError, match="x must"):
        tfl.fused_layer(x.double(), torch.zeros(8, device=cuda), None, None)
    with pytest.raises(ValueError, match="x must"):
        tfl.fused_layer(x.t(), torch.zeros(4, device=cuda), None, None)
    i = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="rp"):
        teg.extract_dense_fused(i, i, torch.zeros(4, device=cuda), i, i,
                                col_scale=1.0, diag=True, max_deg=2)
