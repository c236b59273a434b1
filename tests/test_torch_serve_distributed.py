"""The port's GNN serving over the 4D mesh, in gloo ranks, against the
reference's single-device engine.

The reference engine with ``plan_ranges=g`` builds the micro-batches a
(g, g, g) mesh engine builds, so the parallel forward is the only
difference. Each mesh runs once, one process per rank over gloo (rank r
at the row-major (d, x, y, z) coordinates): every rank builds the same
engine; rank 0 serves the requests and the others run ``serve_worker``
until rank 0 closes its engine. Checked, at 1e-5 of the largest |logit|:

* (dp, g) = (1, 2), 8 ranks: each request's logits equal the reference
  engine's (``plan_ranges=2``), before and after ``update_params``;
* (2, 1), 2 ranks: two full micro-batches are staged and served by ONE
  device call, each equal to the reference's;
* on every rank of both meshes the assembly and the extraction issue no
  collective (the ledger records none and sees no c10d op), and rank 0's
  ledger of one request holds the plan's broadcast, the logits' gather
  and the forward's all-reduces, none under the extraction's scope;
* every worker joined every device call rank 0 made.

Run as a script, it is one rank of the port::

    python tests/test_torch_serve_distributed.py OUT_DIR DP G
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D_IN, D_H, LAYERS, CLASSES = 128, 8, 16, 2, 4
SLOTS, SUPPORT = 8, 56
RANK_TIMEOUT_S = 240
# single requests (each one micro-batch), and the (2, 1) mesh's two full
# micro-batches (SLOTS distinct vertices each)
REQUESTS = [[5, 77, 11, 5], [2, 9], [90, 3, 41, 8, 120], [64]]
FULL = [list(range(0, 2 * SLOTS, 2)), list(range(1, 2 * SLOTS, 2))]


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("XLA_FLAGS", None)
    return env


def _dataset():
    from repro_torch.graphs import make_synthetic_dataset
    return make_synthetic_dataset(n=N, num_classes=CLASSES, d_in=D_IN,
                                  avg_degree=6, seed=1)


def _params_np(scale_out=1.0):
    """Seeded global params in the reference's tree (numpy)."""
    rng = np.random.default_rng(0)
    f = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(
        np.float32)
    return {"w_in": f(D_IN, D_H),
            "w_out": (f(D_H, CLASSES) * scale_out).astype(np.float32),
            "layers": [{"w": f(D_H, D_H),
                        "rms_scale": (1.0 + 0.1 * rng.standard_normal(
                            D_H)).astype(np.float32)}
                       for _ in range(LAYERS)]}


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    """The reference engine's logits of every request: ``plan_ranges`` 2
    (the (1, 2) mesh's plans) with the params and with w_out scaled by
    1.5, and ``plan_ranges`` 1 for the (2, 1) mesh's full batches."""
    import jax
    import jax.numpy as jnp
    from repro.core import gcn_model as JM
    from repro.graphs import make_synthetic_dataset as jdataset
    from repro.serve import InferenceEngine, ServeOptions
    ds = jdataset(n=N, num_classes=CLASSES, d_in=D_IN, avg_degree=6, seed=1)
    assert np.array_equal(ds.adj_norm.data, _dataset().adj_norm.data)
    cfg = JM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=LAYERS,
                       num_classes=CLASSES, dropout=0.0)
    out = {}
    for tag, scale, ranges, reqs in (("g2", 1.0, 2, REQUESTS),
                                     ("g2_update", 1.5, 2, REQUESTS),
                                     ("g1", 1.0, 1, FULL)):
        params = jax.tree.map(jnp.asarray, _params_np(scale))
        eng = InferenceEngine(params, cfg, ds.adj_norm, ds.features,
                              ServeOptions(slots=SLOTS, support=SUPPORT,
                                           plan_ranges=ranges))
        for k, req in enumerate(reqs):
            out[f"{tag}_{k}"] = np.asarray(eng.predict(req))
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    np.savez(path, **out)
    return path


def _spawn(dp, g, out_dir):
    """Run the ranks of a (dp, g) mesh of this file's worker; every rank
    must exit 0 within RANK_TIMEOUT_S, or all are killed and the test
    fails with their output."""
    world = dp * g ** 3
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for rank in range(world):
        env = dict(_env(), RANK=str(rank), WORLD_SIZE=str(world),
                   STORE=os.path.join(out_dir, "store"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(out_dir),
             str(dp), str(g)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, o) for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, "\n".join(f"rank {r} exited {rc}:\n{o[-3000:]}"
                              for r, rc, o in bad)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for dp, g in ((1, 2), (2, 1)):
        d = tmp_path_factory.mktemp(f"serve_{dp}x{g}")
        _spawn(dp, g, str(d))
        out[(dp, g)] = d
    return out


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _close(got, want, tol=1e-5):
    err = np.abs(got - want).max()
    return err <= tol * max(np.abs(want).max(), 1e-30), err


def test_mesh_1x2_equals_the_reference_with_plan_ranges_2(ref_path, runs):
    ref, got = _load(ref_path), _load(runs[(1, 2)] / "rank0.npz")
    for k in range(len(REQUESTS)):
        assert got[f"g2_{k}"].shape == (len(REQUESTS[k]), CLASSES)
        ok, err = _close(got[f"g2_{k}"], ref[f"g2_{k}"])
        assert ok, (k, err)


def test_mesh_1x2_update_params_reshards(ref_path, runs):
    """New params from rank 0: every rank shards them, and the next
    requests are the reference's under the new params."""
    ref, got = _load(ref_path), _load(runs[(1, 2)] / "rank0.npz")
    for k in range(len(REQUESTS)):
        ok, err = _close(got[f"g2_update_{k}"], ref[f"g2_update_{k}"])
        assert ok, (k, err)
        assert not np.allclose(got[f"g2_update_{k}"], got[f"g2_{k}"])


def test_mesh_2x1_serves_two_micro_batches_in_one_device_call(ref_path,
                                                               runs):
    ref, got = _load(ref_path), _load(runs[(2, 1)] / "rank0.npz")
    assert int(got["staged_calls"]) == 1
    for k in range(len(FULL)):
        ok, err = _close(got[f"g1_{k}"], ref[f"g1_{k}"])
        assert ok, (k, err)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)])
def test_assembly_and_extraction_issue_no_collective(runs, mesh):
    """Every rank's assembly of a planned micro-batch reports and
    dispatches no collective; rank 0's ledger of one request: one
    broadcast (scope ``serve_plan``), one gather (``serve_gather``) and
    the forward's all-reduces, nothing under ``extract``; every worker
    served every device call."""
    dp, g = mesh
    world = dp * g ** 3
    r0 = _load(runs[mesh] / "rank0.npz")
    for r in range(world):
        got = _load(runs[mesh] / f"rank{r}.npz")
        assert got["assembly_collectives"] == 0, r
        if r:
            assert int(got["served"]) == int(r0["device_calls"]), r
    assert (int(r0["n_broadcast"]), int(r0["n_gather"])) == (1, 1)
    assert int(r0["n_allreduce"]) > 0
    assert int(r0["extract_ops"]) == 0
    assert str(r0["plan_scope"]) == "serve_plan"
    assert str(r0["gather_scope"]) == "serve_gather"


# ---------------------------------------------------------------------------
# The rank worker
# ---------------------------------------------------------------------------

def _worker(out_dir, dp, g):
    import datetime

    import torch.distributed as dist

    from repro_torch.core import gcn_model as TM
    from repro_torch.obs import comm
    from repro_torch.serve import (InferenceEngine, ServeOptions,
                                   plan_batch_ranges, serve_worker)

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.environ["STORE"], world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    ds = _dataset()
    cfg = TM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=LAYERS,
                       num_classes=CLASSES, dropout=0.0,
                       elementwise_impl="cuda")
    params = lambda s: TM.params_from_numpy(_params_np(s), device="cpu")
    eng = InferenceEngine(params(1.0), cfg, ds.adj_norm, ds.features,
                          ServeOptions(slots=SLOTS, support=SUPPORT,
                                       max_delay_ms=1.0, replay=True,
                                       extract_impl="cuda", device="cpu",
                                       mesh_shape=(g, g, g), mesh_dp=dp))
    back = eng.backend
    out = {}
    # the assembly of a planned micro-batch, alone on this rank
    plan = plan_batch_ranges(np.array(REQUESTS[0]), back.spec, back._pools,
                             back._n_pad_plan)
    ids = torch.from_numpy(plan.batch_ids)
    scale = torch.from_numpy(plan.col_scale)
    rep = comm.comm_report(back._dist.assemble, back._graph_sh, ids, scale)
    out["assembly_collectives"] = rep.total_count + sum(
        rep.dispatched.values())
    if rank:
        out["served"] = serve_worker(eng)
    else:
        if g == 2:
            for k, req in enumerate(REQUESTS):
                out[f"g2_{k}"] = eng.predict(req, now=float(k))
            eng.update_params(params(1.5))
            for k, req in enumerate(REQUESTS):
                out[f"g2_update_{k}"] = eng.predict(req, now=10.0 + k)
        else:
            calls = eng.device_calls
            rids = [eng.submit(req, now=20.0) for req in FULL]
            out["staged_calls"] = eng.device_calls - calls
            for k, rid in enumerate(rids):
                out[f"g1_{k}"] = eng.poll(rid, now=20.0)
        rep = comm.comm_report(eng.predict, REQUESTS[1], now=30.0)
        out["n_broadcast"] = rep.counts.get("broadcast", 0)
        out["n_gather"] = rep.counts.get("gather", 0)
        out["n_allreduce"] = rep.counts["all-reduce"]
        out["extract_ops"] = len(rep.for_scope("extract"))
        (bc,) = [op for op in rep.sites if op.kind == "broadcast"]
        (ga,) = [op for op in rep.sites if op.kind == "gather"]
        out["plan_scope"], out["gather_scope"] = bc.op_name, ga.op_name
        out["device_calls"] = eng.device_calls
        eng.close()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
