"""The port's graph substrate builds the JAX package's graphs bit for bit."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.graphs import datasets as jd  # noqa: E402
from repro.graphs import synthetic as js  # noqa: E402
from repro_torch.graphs import datasets as td  # noqa: E402
from repro_torch.graphs import synthetic as ts  # noqa: E402


def _assert_same_dataset(a, b):
    assert a.name == b.name and a.num_classes == b.num_classes
    for m in ("adj_norm", "adj_norm_t"):
        ca, cb = getattr(a, m), getattr(b, m)
        assert ca.shape == cb.shape
        for f in ("indptr", "indices", "data"):
            x, y = getattr(ca, f), getattr(cb, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for f in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind,n,seed", [("sbm", 300, 0), ("sbm", 512, 3),
                                         ("rmat", 256, 1)])
def test_synthetic_dataset_bit_identical(kind, n, seed):
    kw = dict(n=n, num_classes=4, d_in=8, kind=kind, avg_degree=6,
              seed=seed)
    _assert_same_dataset(js.make_synthetic_dataset(**kw),
                         ts.make_synthetic_dataset(**kw))


@pytest.mark.parametrize("name", ["ogbn-products", "isolate-3-8m"])
def test_get_dataset_bit_identical(name):
    _assert_same_dataset(jd.get_dataset(name, scale_vertices=512, seed=2),
                         td.get_dataset(name, scale_vertices=512, seed=2))


def test_registry_matches():
    assert set(td.DATASETS) == set(jd.DATASETS)
    for k in td.DATASETS:
        assert vars(td.DATASETS[k]) == vars(jd.DATASETS[k])
