"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version, which is
held here against the Pallas kernel (interpret mode, the JAX tests' own
setting) and the pure-JAX reference on the same numpy inputs. The CUDA
kernels themselves are held against the plain versions on a card by
``test_torch_cuda_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import sampling as jsmp  # noqa: E402
from repro.kernels.extract_gather import extract_dense_fused as jax_fused  # noqa: E402
from repro.kernels.fused_layer import fused_layer_pallas  # noqa: E402
from repro_torch.core import sampling as tsmp  # noqa: E402
from repro_torch.graphs import make_synthetic_dataset  # noqa: E402
from repro_torch.kernels import extract_gather as teg  # noqa: E402
from repro_torch.kernels import fused_layer as tfl  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402


@pytest.fixture(scope="module")
def graph():
    return make_synthetic_dataset(n=512, num_classes=4, d_in=8,
                                  avg_degree=10, seed=4).adj_norm


def _sample(rng, n, k):
    return np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)


def _extraction_case(graph, diag, per_col, seed=0):
    """Sampled rows and columns; both hold vertex 0, whose first edge is
    slot 0 of the CSR — where the reference points its padding slots."""
    rng = np.random.default_rng(seed)
    with0 = lambda k: np.union1d(_sample(rng, graph.n_rows, k),
                                 [0]).astype(np.int32)
    rows = with0(48)
    cols = rows if diag else with0(64)
    scale = (rng.uniform(0.5, 9.0, cols.shape[0]).astype(np.float32)
             if per_col else 3.7)
    return rows, cols, scale


def _torch_csr(graph):
    return (torch.from_numpy(graph.indptr), torch.from_numpy(graph.indices),
            torch.from_numpy(graph.data))


def _tscale(scale):
    return torch.from_numpy(scale) if isinstance(scale, np.ndarray) else scale


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("per_col", [True, False])
def test_plain_extraction_bitmatches_jax(graph, diag, per_col):
    """Plain fused extraction == Pallas fused kernel == pure-JAX
    ``extract_dense_block``, bit for bit, with no truncation."""
    rows, cols, scale = _extraction_case(graph, diag, per_col)
    max_deg = graph.max_row_nnz()
    got = teg.extract_dense_plain(
        *_torch_csr(graph), torch.from_numpy(rows), torch.from_numpy(cols),
        col_scale=_tscale(scale), diag=diag, max_deg=max_deg).numpy()
    jrp, jci, jval = (jnp.asarray(graph.indptr), jnp.asarray(graph.indices),
                      jnp.asarray(graph.data))
    ref_fused = np.asarray(jax_fused(
        jrp, jci, jval, jnp.asarray(rows), jnp.asarray(cols),
        col_scale=jnp.asarray(scale), diag=diag, max_deg=max_deg))
    ref_block = np.asarray(jsmp.extract_dense_block(
        jrp, jci, jval, jnp.asarray(rows), jnp.asarray(cols),
        rows.shape[0] * max_deg, rescale_offdiag=jnp.asarray(scale),
        is_diag_block=diag))
    assert got.dtype == np.float32
    assert got.shape == (rows.shape[0], cols.shape[0])
    assert np.count_nonzero(got) > 0
    np.testing.assert_array_equal(got, ref_fused)
    np.testing.assert_array_equal(got, ref_block)


@pytest.mark.parametrize("diag", [True, False])
def test_plain_extraction_truncating_max_deg(graph, diag):
    """A ``max_deg`` below the largest row degree drops each row's tail
    edges exactly as the Pallas kernel does."""
    rows, cols, scale = _extraction_case(graph, diag, True, seed=1)
    got = teg.extract_dense_plain(
        *_torch_csr(graph), torch.from_numpy(rows), torch.from_numpy(cols),
        col_scale=_tscale(scale), diag=diag, max_deg=3).numpy()
    ref = np.asarray(jax_fused(
        jnp.asarray(graph.indptr), jnp.asarray(graph.indices),
        jnp.asarray(graph.data), jnp.asarray(rows), jnp.asarray(cols),
        col_scale=jnp.asarray(scale), diag=diag, max_deg=3))
    np.testing.assert_array_equal(got, ref)
    full = teg.extract_dense_plain(
        *_torch_csr(graph), torch.from_numpy(rows), torch.from_numpy(cols),
        col_scale=_tscale(scale), diag=diag,
        max_deg=graph.max_row_nnz()).numpy()
    assert np.count_nonzero(got) < np.count_nonzero(full)


@pytest.mark.parametrize("e_cap_frac", [1.0, 0.3])
@pytest.mark.parametrize("per_col", [True, False])
def test_torch_extract_dense_block_bitmatches_jax(graph, e_cap_frac,
                                                  per_col):
    """The port's ``"torch"`` backend (COO triples bounded by e_cap) equals
    the JAX reference bit for bit, including a truncating e_cap."""
    rows, cols, scale = _extraction_case(graph, True, per_col, seed=2)
    e_cap = int(rows.shape[0] * graph.max_row_nnz() * e_cap_frac)
    got = tsmp.extract_dense_block(
        *_torch_csr(graph), torch.from_numpy(rows), torch.from_numpy(cols),
        e_cap, rescale_offdiag=_tscale(scale), is_diag_block=True).numpy()
    ref = np.asarray(jsmp.extract_dense_block(
        jnp.asarray(graph.indptr), jnp.asarray(graph.indices),
        jnp.asarray(graph.data), jnp.asarray(rows), jnp.asarray(cols),
        e_cap, rescale_offdiag=jnp.asarray(scale), is_diag_block=True))
    np.testing.assert_array_equal(got, ref)


def _tail_case(b, d, has_mask, has_res, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, d)).astype(np.float32) * 2.0
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    mask = rng.random((b, d)) < 0.7 if has_mask else None
    res = rng.normal(size=(b, d)).astype(np.float32) if has_res else None
    return x, scale, mask, res


_TAIL_CASES = [(d, m, r, True, True) for d in (33, 128)
               for m in (False, True) for r in (False, True)] + [
    (33, True, True, False, True), (128, True, True, True, False),
    (33, False, True, False, False)]


@pytest.mark.parametrize("d,has_mask,has_res,use_rmsnorm,use_relu",
                         _TAIL_CASES)
def test_plain_fused_tail_matches_pallas(d, has_mask, has_res, use_rmsnorm,
                                         use_relu):
    """f32, reductions ordered differently: rtol 1e-5 / atol 1e-6."""
    x, scale, mask, res = _tail_case(64, d, has_mask, has_res)
    kw = dict(dropout_rate=0.3 if has_mask else 0.0, eps=1e-6,
              use_rmsnorm=use_rmsnorm, use_relu=use_relu)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = tfl.fused_layer_plain(t(x), t(scale), t(mask), t(res), **kw)
    ref = fused_layer_pallas(
        jnp.asarray(x), jnp.asarray(scale),
        None if mask is None else jnp.asarray(mask),
        None if res is None else jnp.asarray(res), interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    via_ops = tops.fused_layer_tail(
        t(x), t(res), t(scale), dropout_mask=t(mask), **kw)
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


def test_cpu_tensors_never_count_launches(graph):
    rows, cols, scale = _extraction_case(graph, True, True)
    x, s, mask, res = _tail_case(16, 33, True, True)
    e0, f0 = teg.LAUNCHES, tfl.LAUNCHES
    teg.extract_dense_fused(
        *_torch_csr(graph), torch.from_numpy(rows), torch.from_numpy(cols),
        col_scale=_tscale(scale), diag=True, max_deg=graph.max_row_nnz())
    tfl.fused_layer(torch.from_numpy(x), torch.from_numpy(s),
                    torch.from_numpy(mask), torch.from_numpy(res),
                    dropout_rate=0.3)
    assert (teg.LAUNCHES, tfl.LAUNCHES) == (e0, f0)


def test_wrappers_reject_other_devices():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfl.fused_layer(x, torch.empty(8, device="meta"), None, None)
    i = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        teg.extract_dense_fused(i, i, torch.empty(4, device="meta"), i, i,
                                col_scale=1.0, diag=True, max_deg=2)
