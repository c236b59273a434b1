"""The port's serving path: its host-side pieces, its engine on the CPU,
and a replayed request stream held against the JAX ``InferenceEngine``."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gcn_model as JM  # noqa: E402
from repro.graphs import make_synthetic_dataset  # noqa: E402
from repro.serve import InferenceEngine as JaxEngine  # noqa: E402
from repro.serve import ServeOptions as JaxOptions  # noqa: E402
from repro_torch.core import gcn_model as TM  # noqa: E402
from repro_torch.core import precision  # noqa: E402
from repro_torch.graphs import csr_to_dense  # noqa: E402
from repro_torch.serve import (EmbeddingCache, InferenceEngine,  # noqa: E402
                               MicroBatcher, Overloaded, ServeOptions,
                               make_spec, make_support_pool, plan_batch,
                               plan_batch_ranges, make_support_pools)
from repro_torch.serve.assembler import make_builder  # noqa: E402

N = 256


@pytest.fixture(scope="module")
def served():
    """A small graph, a 2-layer GCN in both packages with the same weights
    (carried across with ``params_from_numpy``)."""
    ds = make_synthetic_dataset(n=N, num_classes=4, d_in=8, avg_degree=6,
                                seed=1)
    jcfg = JM.GCNConfig(d_in=8, d_hidden=16, num_layers=2, num_classes=4,
                        dropout=0.0)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = TM.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    return ds, jcfg, jparams, params


def _port_cfg(impl):
    return TM.GCNConfig(d_in=8, d_hidden=16, num_layers=2, num_classes=4,
                        dropout=0.0, elementwise_impl=impl)


def _port_engine(served, impl="cuda", **opts):
    ds, _, _, params = served
    return InferenceEngine(params, _port_cfg(impl), ds.adj_norm, ds.features,
                           ServeOptions(device="cpu", extract_impl=impl,
                                        **opts))


# a replayed stream: (vertices, arrival time); duplicates, multi-vertex
# requests, a full-batch flush and deadline flushes
STREAM = [([5, 77, 11], 0.000), ([2, 9], 0.001), ([5], 0.002),
          ([90, 3, 41, 8], 0.003), ([200, 201], 0.009), ([77], 0.010),
          ([13, 14, 15, 16, 17, 18, 19], 0.011), ([5, 6], 0.030),
          ([250], 0.031)]


def _replay(eng):
    rids = []
    for vs, t in STREAM:
        rids.append(eng.submit(vs, now=t))
        eng.pump(now=t)
    eng.drain(now=0.05)
    outs = [eng.poll(r, now=0.05) for r in rids]
    assert all(o is not None for o in outs)
    return outs, eng.stats()


@pytest.mark.parametrize("use_cache", [False, True])
def test_replayed_stream_matches_jax_engine(served, use_cache):
    """Port (CUDA impls, plain versions on the CPU) vs the JAX engine on its
    Pallas kernels (interpret mode), same graph, weights and stream."""
    ds, jcfg, jparams, _ = served
    opts = dict(slots=8, support=56, max_delay_ms=5.0, replay=True,
                use_cache=use_cache)
    jeng = JaxEngine(jparams,
                     dataclasses.replace(jcfg, elementwise_impl="pallas"),
                     ds.adj_norm, ds.features,
                     JaxOptions(extract_impl="pallas", **opts))
    ref, jst = _replay(jeng)
    got, st = _replay(_port_engine(served, "cuda", **opts))
    assert st["device_calls"] == jst["device_calls"] > 1
    assert st["batches"] == jst["batches"]
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        # the int8 cache may round a logit 1e-6 away to the neighbouring
        # int8 value: one quantisation step of the row (absmax / 127)
        step = (np.abs(r).max(axis=-1, keepdims=True) / 127.0
                if use_cache else 0.0)
        assert np.all(np.abs(g - r) <= step + 1e-5)


def test_torch_and_cuda_impls_agree(served):
    a, _ = _replay(_port_engine(served, "torch", slots=8, support=56,
                                max_delay_ms=5.0, replay=True))
    b, _ = _replay(_port_engine(served, "cuda", slots=8, support=56,
                                max_delay_ms=5.0, replay=True))
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=1e-5)


def test_full_coverage_support_matches_dense_forward(served):
    """Support covering all of V: serving reproduces the dense forward on
    the requested rows."""
    ds, _, _, params = served
    eng = _port_engine(served, "cuda", slots=8, support=N - 8)
    out = eng.predict([5, 77, 11])
    ref = TM.forward(params, torch.from_numpy(csr_to_dense(ds.adj_norm)),
                     torch.from_numpy(ds.features), _port_cfg("torch"))
    np.testing.assert_allclose(out, ref.numpy()[[5, 77, 11]], atol=1e-5)


def test_assembler_backends_bitmatch(served):
    ds = served[0]
    A = ds.adj_norm
    spec = make_spec(A, slots=4, support=20)
    plan = plan_batch(np.array([7, 2, 33]), spec,
                      make_support_pool(A.n_rows, seed=1))
    csr = (torch.from_numpy(A.indptr), torch.from_numpy(A.indices),
           torch.from_numpy(A.data))
    ids, cs = torch.from_numpy(plan.batch_ids), torch.from_numpy(
        plan.col_scale)
    ref = make_builder(spec, impl="torch").assemble(*csr, ids, cs)
    got = make_builder(spec, impl="cuda",
                       max_row_nnz=A.max_row_nnz()).assemble(*csr, ids, cs)
    assert torch.equal(ref, got)
    # the stratified planner at g=1 is the plain planner
    ranged = plan_batch_ranges(np.array([7, 2, 33]), spec,
                               make_support_pools(A.n_rows, A.n_rows, 1,
                                                  seed=1), A.n_rows)
    np.testing.assert_array_equal(ranged.batch_ids[0], plan.batch_ids)
    np.testing.assert_array_equal(ranged.col_scale[0], plan.col_scale)


# ---------------------------------------------------------------------------
# Host-side pieces (mirror tests/test_serve.py)
# ---------------------------------------------------------------------------

def test_batcher_flushes_when_full():
    b = MicroBatcher(slots=4, max_delay=1.0)
    assert b.add(0, [1, 2], now=0.0) == []
    (batch,) = b.add(1, [3, 4], now=0.0)
    assert [it.vertex for it in batch.items] == [1, 2, 3, 4]
    assert [(it.req_id, it.pos) for it in batch.items] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert b.pending == 0


def test_batcher_splits_and_deadline_flush():
    b = MicroBatcher(slots=2, max_delay=0.010)
    assert len(b.add(0, [5, 6, 7, 8, 9], now=0.0)) == 2 and b.pending == 1
    assert b.next_deadline() == pytest.approx(0.010)
    assert b.flush_due(now=0.005) == []
    (tail,) = b.flush_due(now=0.011)
    assert [it.vertex for it in tail.items] == [9]
    wide = MicroBatcher(slots=8, max_delay=1.0)
    wide.add(3, [10, 11], now=0.0, positions=[4, 7])
    wide.add(4, [12], now=0.0)
    assert wide.cancel(3) == 2
    (rest,) = wide.flush_all()
    assert [(it.req_id, it.vertex) for it in rest.items] == [(4, 12)]


def test_int8_roundtrip():
    x = np.random.default_rng(0).normal(size=(5, 32)).astype(np.float32) * 10
    q, scale = precision.quantize_int8(x)
    assert q.dtype == np.int8 and scale.shape == (5, 1)
    err = np.abs(precision.dequantize_int8(q, scale) - x)
    assert err.max() <= (np.abs(x).max(axis=-1, keepdims=True) / 127).max()
    q0, s0 = precision.quantize_int8(np.zeros((2, 4)))
    np.testing.assert_array_equal(precision.dequantize_int8(q0, s0), 0.0)


def test_cache_hit_miss_version_and_lru():
    c = EmbeddingCache(capacity=2, quantize="int8")
    v = np.linspace(-1, 1, 8).astype(np.float32)
    assert c.get(3) is None
    c.put(3, v)
    np.testing.assert_allclose(c.get(3), v, atol=1 / 127 + 1e-7)
    c.bump_version()
    assert c.get(3) is None
    st = c.stats()
    assert st["hits"] == 1 and st["misses"] == 2 and st["version"] == 1
    f = EmbeddingCache(capacity=2, quantize="f32")
    for i in range(3):
        f.put(i, np.full(4, float(i), np.float32))
    assert f.get(0) is None and f.evictions == 1
    np.testing.assert_array_equal(f.get(2), 2.0)


def test_engine_replay_deterministic_and_cache_invalidates(served):
    eng = _port_engine(served, slots=4, support=28, max_delay_ms=0.0,
                       use_cache=True, replay=True)
    first = eng.predict([5, 6], now=0.0)
    calls = eng.device_calls
    again = eng.predict([5, 6], now=1.0)              # both cached
    assert eng.device_calls == calls
    np.testing.assert_allclose(again, first, atol=np.abs(first).max() / 100)
    eng.invalidate()
    eng.predict([5, 6], now=2.0)
    assert eng.device_calls == calls + 1
    a, _ = _replay(_port_engine(served, slots=8, support=56,
                                max_delay_ms=5.0, replay=True))
    b, _ = _replay(_port_engine(served, slots=8, support=56,
                                max_delay_ms=5.0, replay=True))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_engine_deadline_shed_and_naive_mode(served):
    eng = _port_engine(served, slots=8, support=24, max_delay_ms=5.0,
                       replay=True)
    r_shed = eng.submit([3], now=0.0, deadline_ms=2.0)
    r_keep = eng.submit([4], now=0.0)
    assert eng.poll(r_shed, now=0.003) is None
    failed = eng.take_failed()
    assert set(failed) == {r_shed} and isinstance(failed[r_shed], Overloaded)
    assert eng.poll(r_keep, now=0.006) is not None
    assert eng.stats()["shed_deadline"] == 1
    naive = _port_engine(served, slots=8, support=24, micro_batch=False,
                         replay=True)
    for i, t in enumerate([0.0, 0.1, 0.2]):
        assert naive.poll(naive.submit([i], now=t), now=t) is not None
    assert naive.device_calls == 3


def test_update_params_never_serves_stale_cache_rows(served):
    ds, _, _, params = served
    eng = _port_engine(served, slots=4, support=N - 4, max_delay_ms=0.0,
                       use_cache=True, replay=True)
    before = eng.predict([5, 6], now=0.0)
    params2 = TM.params_to(params, torch.device("cpu"))
    params2["w_out"] = params2["w_out"] * 1.5
    eng.update_params(params2)
    calls = eng.device_calls
    after = eng.predict([5, 6], now=1.0)
    assert eng.device_calls == calls + 1
    np.testing.assert_allclose(after, before * 1.5, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Device selection and package boundaries
# ---------------------------------------------------------------------------

def test_engine_without_device_needs_a_card(served, monkeypatch):
    ds, _, _, params = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        InferenceEngine(params, _port_cfg("cuda"), ds.adj_norm, ds.features,
                        ServeOptions(extract_impl="cuda"))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TM.init_params(_port_cfg("torch"), torch.Generator())


@pytest.mark.parametrize("opts", [dict(mesh_shape=(2, 2, 2)),
                                  dict(mesh_dp=2),
                                  dict(force_distributed=True)])
def test_mesh_serving_is_not_ported_yet(served, opts, tmp_path):
    """Serving over the mesh (the name is the one this test had while it
    pinned the refusal): a mesh of more than one rank without a process
    group raises and names ``torchrun``; ``force_distributed`` on one gloo
    rank runs the whole mesh path (plan broadcast, rank-0 gather) and
    equals the single-device engine."""
    import torch.distributed as dist
    if not opts.get("force_distributed"):
        with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
            _port_engine(served, slots=8, support=56, **opts)
        return
    single = _port_engine(served, slots=8, support=56, max_delay_ms=1.0)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = _port_engine(served, slots=8, support=56, max_delay_ms=1.0,
                            **opts)
        assert mesh.backend._dist.mesh.groups is not None
        rng = np.random.default_rng(0)
        for _ in range(3):
            req = rng.integers(0, N, size=5).tolist()
            np.testing.assert_allclose(mesh.predict(req),
                                       single.predict(req), rtol=1e-5,
                                       atol=1e-6)
        mesh.close()
    finally:
        dist.destroy_process_group()


def test_port_imports_neither_jax_nor_repro():
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k == 'repro'\n"
        "             or k.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.serve.engine' in sys.modules\n"
        "assert 'repro_torch.train.runner' in sys.modules\n"
        "assert 'repro_torch.serve.llm_engine' in sys.modules\n"
        "assert 'repro_torch.models.transformer' in sys.modules\n"
        "for m in ('core.pmm3d', 'core.fourd', 'core.forward',\n"
        "          'core.precision', 'launch.train', 'core.sampling',\n"
        "          'core.pipeline', 'kernels.counter_rng', 'train.state',\n"
        "          'optim.adamw', 'obs.comm', 'obs.bench', 'launch.roofline',\n"
        "          'launch.mesh', 'launch.dryrun', 'kernels._observe',\n"
        "          'data.pipeline', 'launch.train_transformer',\n"
        "          'models.moe', 'models.ssm', 'launch.serve_llm',\n"
        "          'configs.llama_3_2_vision_90b', 'configs.whisper_base'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=src,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
