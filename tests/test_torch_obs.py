"""The port's collective ledger (``repro_torch.obs.comm``) and benchmark
record writer (``repro_torch.obs.bench``), against the reference's
``repro.obs.hlo`` and ``repro.obs.bench``.

The ledger's records need process groups: each test that makes them runs
in a fake process group (``"cpu:fake"``: every collective returns at once,
its values untouched) of two ranks, or in a one-rank gloo group, made and
destroyed around the test. Against the reference's ``comm_report`` on a
real mesh: ``tests/test_torch_comm_dist.py``.
"""
import contextlib
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro.obs import bench as jbench  # noqa: E402
from repro.obs import hlo as jhlo  # noqa: E402
from repro_torch.core import pmm3d  # noqa: E402
from repro_torch.core.precision import psum, quantize  # noqa: E402
from repro_torch.obs import bench as tbench  # noqa: E402
from repro_torch.obs import comm  # noqa: E402
from repro_torch.obs.tracer import phase  # noqa: E402


@contextlib.contextmanager
def fake_world(size=2):
    """This process as rank 0 of a fake process group; yields the group of
    its ``size`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("cpu:fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield dist.new_group(list(range(size)))
    finally:
        dist.destroy_process_group()


def _axis(group, name="y", size=2):
    return pmm3d.Axis(name, 0, size, group, tuple(range(size)))


def test_report_str_and_assert_no_collectives_match_the_reference():
    """The report's text and its invariant check, key for key the
    reference's, from the same counts."""
    counts = dict.fromkeys(comm.COLLECTIVES, 0)
    byts = dict.fromkeys(comm.COLLECTIVES, 0)
    assert str(comm.CommReport(counts, byts)) == str(
        jhlo.CommReport(counts, byts)) == "CommReport(no collectives)"
    comm.CommReport(counts, byts).assert_no_collectives("sampling")
    counts.update({"all-reduce": 3, "collective-permute": 2})
    byts.update({"all-reduce": 384, "collective-permute": 96})
    got, want = comm.CommReport(counts, byts), jhlo.CommReport(counts, byts)
    assert str(got) == str(want)
    assert (got.total_count, got.total_bytes, got.kinds()) == (
        want.total_count, want.total_bytes, want.kinds())
    with pytest.raises(AssertionError, match="NOT communication-free"):
        got.assert_no_collectives("sampling")


def test_scopes_dtypes_and_the_backward_scope():
    """An all-reduce in a phase records the phase as its scope, with the
    local bytes and their dtype; its backward, run outside the phase,
    records under the forward's scope marked ``transpose``; an all-gather
    counts the gathered bytes; a ring's hops carry its scope."""
    x = torch.ones((8, 4), dtype=torch.bfloat16, requires_grad=True)
    with fake_world() as grp:
        y = _axis(grp)
        with comm.recording() as led:
            with phase("reshard"):
                out = psum(x, y)
            out.float().sum().backward()
            pmm3d.all_gather(torch.ones((8, 4)), y)
            pmm3d.ring_psum(torch.ones((8, 4)), y)
        rep = led.report()
    assert rep.counts["all-reduce"] == 2 and rep.counts["all-gather"] == 1
    ar = rep.for_scope("reshard")
    assert [op.op_name for op in ar] == ["reshard", "transpose/reshard"]
    assert all(op.bytes == 8 * 4 * 2 and op.dtype_bytes == (("bf16", 64),)
               for op in ar)
    assert rep.bytes["all-gather"] == 2 * 8 * 4 * 4
    assert rep.bytes_for_scope("ring_rs") == rep.bytes_for_scope(
        "ring_ag") == 4 * 4 * 4                   # one chunk a hop at g = 2
    assert rep.bytes_by_dtype() == {"bf16": 128, "f32": 256 + 128}


def test_a_hop_counts_once_and_splits_its_dtypes():
    """A point-to-point hop is one collective-permute of what this rank
    sends (not once for the send and again for the receive); a quantized
    hop's int8 payload and f32 row scales land in ``s8`` and ``f32``."""
    with fake_world():
        x = torch.randn((6, 8), generator=torch.Generator().manual_seed(0))
        q, sc = quantize(x, 8)
        with comm.recording() as led:
            pmm3d._exchange(x, 1, 1)
            pmm3d._wait(pmm3d._post([q, sc], 1, 1))
        rep = led.report()
    assert rep.counts["collective-permute"] == 2 and rep.total_count == 2
    assert [op.bytes for op in rep.sites] == [6 * 8 * 4, 6 * 8 + 6 * 4]
    assert rep.bytes_by_dtype() == {"f32": 6 * 8 * 4 + 6 * 4, "s8": 48}


def test_no_record_and_no_cost_without_a_ledger(monkeypatch):
    """With no recording, the collectives run and nothing is recorded or
    measured: the byte count is never reached, a scope is the shared no-op
    context and nothing is saved for a backward."""
    def boom(*a, **k):
        raise AssertionError("recorded with no ledger")
    monkeypatch.setattr(comm, "_add", boom)
    monkeypatch.setattr(comm, "_dtype_bytes", boom)
    x = torch.ones((4, 4), requires_grad=True)
    with fake_world() as grp:
        y = _axis(grp)
        psum(x, y).sum().backward()
        pmm3d.ring_psum_gemm(torch.ones((4, 4)), torch.eye(4), y)
        pmm3d._exchange(torch.ones(3), 1, 1)
    assert comm.scope("reshard") is comm._NULL
    assert comm.current_scope() is None and comm.restore(("a",)) is comm._NULL


def test_assert_no_collectives_runs_the_function_and_raises():
    with fake_world() as grp:
        y = _axis(grp)
        comm.assert_no_collectives(lambda: torch.ones(3) * 2, what="local")
        with pytest.raises(AssertionError, match="NOT communication-free"):
            comm.assert_no_collectives(psum, torch.ones(3), y,
                                       what="sampling")


def test_a_raw_collective_is_caught_where_no_site_reports_it():
    """A ``torch.distributed`` call that bypasses the port's collectives
    (as a sampler reaching for ``dist.all_reduce`` or ``dist.all_gather``
    would) reports nothing itself, but the recording sees its c10d op:
    ``assert_no_collectives`` fails on it. The port's own psum is seen
    both ways, and a nested recording counts the op once in each
    ledger."""
    def sampler(x, group):
        x = x * 2
        dist.all_reduce(x, group=group)
        return x

    with fake_world() as grp:
        rep = comm.comm_report(sampler, torch.ones(3), grp)
        assert rep.total_count == 0 and rep.dispatched == {"allreduce_": 1}
        with pytest.raises(AssertionError, match="allreduce_"):
            rep.assert_no_collectives("sampling")
        with pytest.raises(AssertionError, match="NOT communication-free"):
            comm.assert_no_collectives(
                lambda: dist.all_gather([torch.empty(2)] * 2, torch.ones(2),
                                        group=grp), what="sampling")
        with comm.recording() as outer:
            with comm.recording() as inner:
                psum(torch.ones(3), _axis(grp))
        for led in (outer, inner):
            got = led.report()
            assert got.counts["all-reduce"] == 1, str(got)
            assert got.dispatched == {"allreduce_": 1}
            assert got.dispatched_kinds() == got.kinds() == ("all-reduce",)
        comm.assert_no_collectives(lambda: torch.ones(3) @ torch.ones(3))


def test_the_pipelined_gemm_hides_its_ring_hops():
    """``ring_psum_gemm`` at g = 4: its g - 1 all-gather hops each have the
    chunk's GEMM between post and wait; its reduce-scatter hops (an add
    after each wait) have none; the backward's ring, with no consumer,
    none either."""
    w = torch.randn((4, 3), requires_grad=True)
    with fake_world(4) as grp:
        y = _axis(grp, size=4)
        ov = comm.overlap_report(lambda: pmm3d.ring_psum_gemm(
            torch.ones((8, 4)), w, y).sum().backward())
    fwd = [s for s in ov.for_scope("ring_gemm", "ring_ag")
           if "transpose" not in s.op_name]
    assert len(fwd) == 3 and all(s.slack == 1 for s in fwd), str(ov)
    ov.assert_overlapped("ring_gemm", "ring_ag", what="forward ring")
    assert all(s.slack == 0 for s in ov.for_scope("ring_rs"))
    assert ov.n_overlapped == 3 and ov.n_collectives == 3 * 4
    with pytest.raises(AssertionError, match="overlappable"):
        ov.assert_overlapped("ring_rs")


def test_no_record_inside_a_replay(tmp_path, monkeypatch):
    """``Trainer.run`` on a one-rank gloo mesh with a stand-in capture: the
    ledger records the warm-up step's collectives and the capture's, and
    none of the replays' (a replay makes no Python call: the stand-in
    graph's ``replay`` does nothing)."""
    from repro.graphs import make_synthetic_dataset
    from repro_torch import optim as topt
    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as TM
    from repro_torch.graphs import build_partitioned_graph
    from repro_torch.train import Trainer, TrainLoopConfig
    from repro_torch.train import runner

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    @contextlib.contextmanager
    def capture(g):
        yield

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        ds = make_synthetic_dataset(n=128, num_classes=4, d_in=8,
                                    avg_degree=4, seed=0)
        cfg = TM.GCNConfig(d_in=8, d_hidden=16, num_layers=2, num_classes=4)
        plan = fourd.build_plan(build_partitioned_graph(ds, g=1), cfg,
                                fourd.make_mesh_4d(1, 1, "cpu"), batch=32)
        graph = plan.shard_graph(build_partitioned_graph(ds, g=1))
        tr = Trainer(plan, topt.AdamW(lr=1e-3),
                     TrainLoopConfig(total_steps=1, chunk_size=4),
                     eval_fn=lambda p, g: 0.0)
        st = tr.init_state(TM.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"), graph)
        with comm.recording() as one:
            tr.step(st, graph)
        monkeypatch.setattr(runner.Trainer, "_captures", lambda self: True)
        monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
        monkeypatch.setattr(torch.cuda, "graph", capture)
        tr.total_steps = 7
        with comm.recording() as led:
            st, log = tr.run(st, graph)
    finally:
        dist.destroy_process_group()
    per_step = one.report()
    assert per_step.counts["all-reduce"] > 0
    assert (log.replays, Graph.replays) == (5, 5)
    rep = led.report()
    assert rep.counts == {k: 2 * v for k, v in per_step.counts.items()}
    assert rep.bytes == {k: 2 * v for k, v in per_step.bytes.items()}


def test_bench_round_trip_and_compare_match_the_reference(tmp_path):
    """The same documents through both packages' writers, loaders and
    ``compare_entries``: the same rows."""
    docs = {}
    for name, mod in (("port", tbench), ("ref", jbench)):
        for which, scale in (("base", 1.0), ("cur", 1.0)):
            w = mod.BenchWriter(f"{name}_{which}", config={"seed": 0})
            rng = np.random.default_rng(0)
            for i in range(6):
                m = float(rng.uniform(10, 100))
                cur = m * (1.0, 1.6, 0.5, 1.05, 0.0, 1.0)[i] \
                    if which == "cur" else m
                w.add(f"e{i}", cur * scale, p10_us=0.9 * cur,
                      p90_us=1.1 * cur, derived="x", comm_bytes=i)
            if which == "cur":
                w.add("new", 5.0)
            docs[(name, which)] = mod.load_bench(w.write(str(tmp_path)))
    for which in ("base", "cur"):
        a, b = docs[("port", which)], docs[("ref", which)]
        assert a["entries"] == b["entries"] and a["schema"] == b["schema"]
    rows_t = tbench.compare_entries(docs[("port", "cur")],
                                    docs[("port", "base")])
    rows_j = jbench.compare_entries(docs[("ref", "cur")],
                                    docs[("ref", "base")])
    assert json.dumps(rows_t) == json.dumps(rows_j)
    assert {r["status"] for r in rows_t} == {"ok", "regression",
                                             "improvement", "unbaselined"}


def test_commop_fields_are_the_reference_s():
    """``CommOp`` has the reference's fields; ``CollectiveSite`` keeps the
    reference's names of what the port can score (a hop is always an
    asynchronous collective-permute, so only its scope and slack vary)."""
    assert [f.name for f in dataclasses.fields(comm.CommOp)] == [
        f.name for f in dataclasses.fields(jhlo.CommOp)]
    ref = {f.name for f in dataclasses.fields(jhlo.CollectiveSite)}
    site = comm.CollectiveSite(op_name="ring_ag", slack=2)
    assert {f.name for f in dataclasses.fields(site)} <= ref
    assert (site.op_name, site.slack, site.concurrent) == ("ring_ag", 2, 2)
    assert comm.COLLECTIVES == jhlo.COLLECTIVES
