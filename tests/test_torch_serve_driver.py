"""The port's threaded driver (``repro_torch.serve.ServingDriver``): the
reference's driver tests (``tests/test_serve_driver.py``) against the
port's GNN engine on the CPU, and results through the driver against the
reference engine's ``predict``.

Every engine gets a full-coverage support set (``support = n - slots``:
every micro-batch covers all of V at scale 1), so a request's logits equal
the dense forward's rows whatever batch it lands in, and thread schedules
cannot change an output.
"""
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import InferenceEngine as JaxEngine  # noqa: E402
from repro.serve import ServeOptions as JaxOptions  # noqa: E402
from repro_torch.core import gcn_model as TM  # noqa: E402
from repro_torch.serve import (InferenceEngine, Overloaded,  # noqa: E402
                               ServeOptions, ServingDriver)

N = 96


@pytest.fixture(scope="module")
def served(gnn_serving_setup):
    """(ds, reference cfg, reference params, dense reference logits)."""
    return gnn_serving_setup(N, 2)


@pytest.fixture(scope="module")
def engine(served):
    """Warmed-up port engine factory over the full-coverage setup."""
    ds, jcfg, jparams, _ = served
    cfg = TM.GCNConfig(d_in=jcfg.d_in, d_hidden=jcfg.d_hidden,
                       num_layers=jcfg.num_layers,
                       num_classes=jcfg.num_classes, dropout=0.0,
                       elementwise_impl="cuda")
    params = TM.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")

    def build(**kw):
        opts = dict(slots=8, support=N - 8, max_delay_ms=2.0, device="cpu",
                    extract_impl="cuda")
        opts.update(kw)
        eng = InferenceEngine(params, cfg, ds.adj_norm, ds.features,
                              ServeOptions(**opts))
        if not eng.opts.replay:
            eng.predict([0])
            eng.reset_stats()
        return eng
    return build


def _run_threads(n, fn):
    errs = []

    def wrap(i):
        try:
            fn(i)
        except Exception as e:            # surface failures in the main thread
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs


def test_submit_from_multiple_threads_routes_and_replays(served, engine):
    """8 submitter threads, two identical runs: every future resolves to
    its own vertices' reference rows and the two runs give the same
    outputs."""
    ref = served[3]

    def scenario():
        out = {}
        eng = engine()
        with ServingDriver(eng, starvation_ms=20.0) as drv:
            def worker(tid):
                rng = np.random.default_rng(tid)
                req = rng.integers(0, N, size=3).tolist()
                out[tid] = (req, drv.submit(req).result(timeout=30))
            _run_threads(8, worker)
            drv.drain()
        return out

    a = scenario()
    b = scenario()
    assert set(a) == set(b) == set(range(8))
    for tid, (req, logits) in a.items():
        np.testing.assert_allclose(logits, ref[req], atol=1e-5)
        np.testing.assert_array_equal(logits, b[tid][1])


def test_starvation_flush_beats_per_request_deadline(served, engine):
    """A 10 s batcher deadline: a lone request still completes within the
    driver's starvation bound, through the starvation flush."""
    eng = engine(max_delay_ms=10_000.0)
    t0 = time.monotonic()
    with ServingDriver(eng, starvation_ms=30.0) as drv:
        out = drv.submit([3, 7]).result(timeout=5)
        waited = time.monotonic() - t0
        assert drv.starvation_flushes >= 1
    assert waited < 2.0, f"starved for {waited:.3f}s"
    np.testing.assert_allclose(out, served[3][[3, 7]], atol=1e-5)


def test_drain_completes_all_pending_under_load(served, engine):
    """Concurrent submitters racing a drain: after close() every future is
    done and right, and nothing is left pending or staged."""
    ref = served[3]
    eng = engine(max_delay_ms=50.0)
    futs = {}
    with ServingDriver(eng, starvation_ms=500.0) as drv:
        def worker(tid):
            rng = np.random.default_rng(100 + tid)
            for k in range(6):
                req = rng.integers(0, N, size=2).tolist()
                futs[(tid, k)] = (req, drv.submit(req))
        _run_threads(6, worker)
        drv.drain()
        assert all(f.done() for _, f in futs.values())
    assert len(futs) == 36
    for req, fut in futs.values():
        np.testing.assert_allclose(fut.result(timeout=0), ref[req],
                                   atol=1e-5)
    st = eng.stats()
    assert st["pending"] == 0 and st["staged"] == 0
    assert st["completed"] == 36


def test_pump_thread_failure_surfaces_through_futures(engine):
    """An engine error in the background pump fails every in-flight future
    with it, and the thread stays alive for later traffic."""
    eng = engine(max_delay_ms=1.0)

    def explode(now=None):
        raise RuntimeError("injected pump failure")

    eng.pump = explode
    with ServingDriver(eng, starvation_ms=5.0) as drv:
        fut = drv.submit([1, 2])
        with pytest.raises(RuntimeError, match="injected pump failure"):
            fut.result(timeout=5)
        assert isinstance(drv.last_error, RuntimeError)
        assert drv._thread.is_alive()


def test_close_drain_failure_fails_futures_not_hangs(engine):
    """An engine failure in close()'s final drain resolves every in-flight
    future with the exception, unblocking concurrent waiters, and close()
    itself does not raise."""
    eng = engine(max_delay_ms=10_000.0)
    drv = ServingDriver(eng, starvation_ms=10_000.0, auto=False)
    futs = [drv.submit([i, i + 1]) for i in range(3)]  # < slots
    assert not any(f.done() for f in futs)       # parked behind the deadline
    real_drain = eng.drain

    def exploding_drain():
        raise RuntimeError("injected drain failure")

    eng.drain = exploding_drain
    results, errs = [], []

    def waiter(i):
        try:
            with pytest.raises(RuntimeError,
                               match="injected drain failure"):
                futs[i].result(timeout=5)
            results.append(i)
        except Exception as e:
            errs.append(e)

    waiters = [threading.Thread(target=waiter, args=(i,)) for i in range(2)]
    for t in waiters:
        t.start()
    time.sleep(0.05)                             # waiters parked in result()
    drv.close()                                  # fails the drain
    for t in waiters:
        t.join(timeout=10)
    assert not errs, errs
    assert sorted(results) == [0, 1]
    for f in futs:
        assert f.done()
        with pytest.raises(RuntimeError, match="injected drain failure"):
            f.result(timeout=0)
    assert isinstance(drv.last_error, RuntimeError)
    eng.drain = real_drain
    eng.drain()                                  # clear engine state


def test_driver_rejects_replay_engines(engine):
    with pytest.raises(ValueError, match="replay"):
        ServingDriver(engine(slots=4, support=28, replay=True))


def test_stats_high_water_marks_and_latency_quantiles(engine):
    """Five one-vertex requests parked behind a long deadline: exact queue
    and in-flight high-water marks; after the drain every request is in
    the latency histogram with ordered quantiles, and occupancy and padding
    waste split the slot capacity."""
    eng = engine(max_delay_ms=10_000.0)
    drv = ServingDriver(eng, starvation_ms=10_000.0, auto=False)
    futs = [drv.submit([i]) for i in range(5)]          # 5 < slots: parked
    st = drv.stats()
    assert st["queue_high_water"] == 5
    assert st["inflight_high_water"] == 5
    assert st["inflight"] == 5 and st["shed"] == 0
    drv.drain()
    assert all(f.done() for f in futs)
    st = drv.stats()
    assert st["completed"] == 5 and st["inflight"] == 0
    assert st["queue_high_water"] == 5
    assert st["occupancy"] == pytest.approx(5 / 8)
    assert st["padding_waste"] == pytest.approx(3 / 8)
    assert 0 < st["p50_ms"] <= st["p95_ms"] <= st["p99_ms"]
    assert 0 < st["mean_ms"]
    assert eng.latencies.count == 5
    drv.close()


def test_max_inflight_sheds_overloaded_requests(served, engine):
    """Beyond ``max_inflight`` parked requests, submit raises
    ``Overloaded`` and counts the shed, while every admitted request still
    completes right once the overload clears."""
    ref = served[3]
    eng = engine(max_delay_ms=10_000.0)
    drv = ServingDriver(eng, starvation_ms=10_000.0, auto=False,
                        max_inflight=3)
    futs = [drv.submit([i, i + 1]) for i in range(3)]
    for k in range(2):
        with pytest.raises(Overloaded, match="max_inflight=3"):
            drv.submit([40 + k])
    st = drv.stats()
    assert st["shed"] == 2
    assert st["inflight"] == st["inflight_high_water"] == 3
    drv.drain()                            # clears the gate...
    fut_late = drv.submit([50, 51])        # ...so new traffic is admitted
    drv.drain()
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(timeout=5), ref[[i, i + 1]],
                                   atol=1e-5)
    np.testing.assert_allclose(fut_late.result(timeout=5), ref[[50, 51]],
                               atol=1e-5)
    assert drv.stats()["shed"] == 2
    assert drv.stats()["completed"] == 4
    drv.close()


def test_manual_driver_pump_services_deadlines(served, engine):
    """auto=False: nothing happens until pump(); then the deadline flush
    runs and the future resolves."""
    ref = served[3]
    eng = engine(max_delay_ms=1.0)
    drv = ServingDriver(eng, starvation_ms=10_000.0, auto=False)
    fut = drv.submit([9, 4, 33])
    assert not fut.done()
    deadline = time.monotonic() + 5.0
    while not fut.done() and time.monotonic() < deadline:
        time.sleep(0.002)
        drv.pump()
    np.testing.assert_allclose(fut.result(timeout=0), ref[[9, 4, 33]],
                               atol=1e-5)
    drv.close()


def test_results_through_the_driver_equal_the_reference_engine(served,
                                                               engine):
    """With a partial support set (each row then depends on its batch's
    plan): each request through the port's driver, drained as a
    micro-batch of its own, equals the reference engine's ``predict`` of
    it (the same plan; logits within 1e-5); then the same requests from 4
    threads all resolve with the right shapes."""
    ds, jcfg, jparams, _ = served
    opts = dict(slots=8, support=24, max_delay_ms=10_000.0)
    ref_eng = JaxEngine(jparams, jcfg, ds.adj_norm, ds.features,
                        JaxOptions(extract_impl="pallas", **opts))
    eng = engine(**opts)
    drv = ServingDriver(eng, starvation_ms=10_000.0, auto=False)
    rng = np.random.default_rng(4)
    reqs = [rng.integers(0, N, size=k).tolist() for k in (1, 3, 5, 2)]
    for req in reqs:
        fut = drv.submit(req)
        drv.drain()                     # one request, one micro-batch
        np.testing.assert_allclose(fut.result(timeout=0),
                                   ref_eng.predict(req), rtol=1e-5,
                                   atol=1e-6)
    outs = {}

    def worker(i):
        outs[i] = drv.submit(reqs[i])
    _run_threads(4, worker)
    drv.drain()
    for i, fut in outs.items():
        assert fut.result(timeout=0).shape == (len(reqs[i]),
                                               jcfg.num_classes)
    drv.close()
