"""The port's locality samplers (partition and walk) against the JAX
package.

* bit for bit: the locality reordering, the CSR permutation, the cluster
  bound, the walk tables and the clustered partition, on an SBM graph and
  on one with isolated vertices; the per-pair rescales (within 1e-7) and
  the extraction under them, on the reference's sampled ids;
* the reference's own properties (``tests/test_locality_sampling.py``)
  for the port's counter draws, which cannot reproduce ``jax.random``'s:
  whole sorted clusters, epoch slice 0 equal to the step sampler, every
  vertex once per epoch, DP slices disjoint and jointly covering, walk
  ids distinct, sorted, in range and reachable through the table;
* one partition and one walk training step through
  ``fourd.make_train_step`` with the reference's ids injected (loss within
  1e-5, every gradient leaf within 1e-4 of its largest |value|), and
  ``Trainer`` resuming a prefetched epoch-schedule run bit for bit;
* on gloo ranks: partition + epoch at (G_d, g) = (2, 1), whose two groups
  take disjoint slices covering every cluster once and whose losses match
  the reference's on 2 forced host devices with its ids injected; and
  partition and walk at (1, 2), where sampling makes no collective call
  (the paper's zero-communication claim).

Run as a script, this file is one gloo rank::

    python tests/test_torch_locality.py MODE OUT_DIR [REF.npz]
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D_IN, D_H, LAYERS, CLASSES, TILE = 256, 16, 32, 3, 4, 16
RANK_TIMEOUT_S = 120
# the gloo meshes: (2, 1) partition + epoch; (1, 2) partition and walk
DIST_N, DIST_BATCH, DIST_CLUSTERS = 512, 128, 16


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("XLA_FLAGS", None)
    return env


# ---------------------------------------------------------------------------
# The gloo ranks (no JAX in this half: a rank imports only the port)
# ---------------------------------------------------------------------------

# the torch.distributed calls a collective could make
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "reduce_scatter", "reduce_scatter_tensor", "broadcast",
                "all_to_all", "all_to_all_single", "batch_isend_irecv",
                "isend", "irecv", "send", "recv", "barrier")


def _dist_plan(mesh, g, kind, mode):
    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as TM
    from repro_torch.graphs import (build_partitioned_graph,
                                    make_synthetic_dataset)
    ds = make_synthetic_dataset(n=DIST_N, num_classes=CLASSES, d_in=D_IN,
                                avg_degree=8, seed=0)
    clusters = DIST_CLUSTERS if kind == "partition" else 0
    pg = build_partitioned_graph(ds, g=g, clusters=clusters)
    cfg = TM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=LAYERS,
                       num_classes=CLASSES, dropout=0.0)
    opts = fourd.TrainOptions(
        sample_kind=kind, sample_mode=mode, clusters=clusters, walk_len=3,
        walk_k=6, spmm_impl="ell", fused_elementwise=True, ell_tile=TILE,
        ell_slots=DIST_BATCH // g // TILE)
    plan = fourd.build_plan(pg, cfg, mesh, batch=DIST_BATCH, opts=opts)
    return plan, plan.shard_graph(pg)


def _worker(mode, out_dir, ref_path=None):
    import datetime

    import torch.distributed as dist

    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as TM

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.environ["STORE"], world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=90))
    out = {}
    if mode == "epoch2x1":
        mesh = fourd.make_mesh_4d(2, 1, "cpu")
        plan, graph = _dist_plan(mesh, 1, "partition", "epoch")
        out["spe"] = np.asarray(plan.scfg.steps_per_epoch)
        loss_fn = fourd.make_loss_fn(plan)
        for t in range(2 * plan.scfg.steps_per_epoch):
            out[f"ids_{t}"] = loss_fn.plan.builder.sample_ids(
                t, None, mesh.coords["d"], device="cpu").numpy()
        with np.load(ref_path) as ref:
            ref = {k: ref[k] for k in ref.files}
        tree = {"w_in": ref["w_in"], "w_out": ref["w_out"],
                "layers": [{"rms_scale": ref[f"rms_{i}"],
                            "w": ref[f"w_{i}"]} for i in range(LAYERS)]}
        params = plan.shard_params(TM.params_from_numpy(tree, device="cpu"))
        ids = torch.from_numpy(ref["ids"][mesh.coords["d"]])
        out["losses"] = loss_fn(params, graph, 0, ids=ids).numpy()
    else:                                   # "sample1x2"
        mesh = fourd.make_mesh_4d(1, 2, "cpu")
        calls = []
        for kind in ("partition", "walk"):
            plan, graph = _dist_plan(mesh, 2, kind, "step")
            loss_fn = fourd.make_loss_fn(plan)
            saved = {n: getattr(dist, n) for n in _COLLECTIVES
                     if hasattr(dist, n)}

            def spy(name):
                def call(*a, **k):
                    calls.append(name)
                    return saved[name](*a, **k)
                return call
            for n in saved:
                setattr(dist, n, spy(n))
            try:
                for step in (0, 1, torch.tensor(2, dtype=torch.int32)):
                    mb = loss_fn.sample(graph, step)
                    key = f"{kind}_{int(step)}"
                    out[key + "_ids"] = plan.builder.sample_ids(
                        step, None, 0, device="cpu",
                        aux=graph.get("walk")).numpy()
                    out[key + "_feats"] = mb.feats.numpy()
            finally:
                for n, f in saved.items():
                    setattr(dist, n, f)
        out["collective_calls"] = np.asarray(len(calls))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(REPO, "src"))
    _worker(*sys.argv[1:])
    sys.exit(0)


# ---------------------------------------------------------------------------
# Everything below runs in the test process (JAX on the CPU)
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fourd as jfourd  # noqa: E402
from repro.core import gcn_model as JM  # noqa: E402
from repro.core import sampling as jsmp  # noqa: E402
from repro.graphs import build_partitioned_graph as jbuild  # noqa: E402
from repro.graphs import csr as jcsr  # noqa: E402
from repro.graphs import make_synthetic_dataset  # noqa: E402
from repro.graphs import partition as jpart  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.core import fourd as tfourd  # noqa: E402
from repro_torch.core import gcn_model as TM  # noqa: E402
from repro_torch.core import minibatch as tmb  # noqa: E402
from repro_torch.core import sampling as tsmp  # noqa: E402
from repro_torch.core.forward import TrainOptions  # noqa: E402
from repro_torch.graphs import build_partitioned_graph as tbuild  # noqa: E402
from repro_torch.graphs import csr as tcsr  # noqa: E402
from repro_torch.graphs import partition as tpart  # noqa: E402
from repro_torch.train import Trainer, TrainLoopConfig  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(n=N, num_classes=CLASSES, d_in=D_IN,
                                  avg_degree=8, seed=0)


def _with_isolated(ds):
    """``ds`` with every edge of each 7th vertex removed (their rows and
    columns empty): isolated vertices for the BFS seeds and the walk
    tables' self-loops."""
    A = ds.adj_norm
    rows = np.repeat(np.arange(A.n_rows), np.diff(A.indptr))
    keep = (rows % 7 != 0) & (A.indices % 7 != 0)
    csr = jcsr.coo_to_csr(rows[keep], A.indices[keep], A.data[keep],
                          A.shape)
    return types.SimpleNamespace(
        adj_norm=csr, features=ds.features, labels=ds.labels,
        train_mask=ds.train_mask, num_classes=ds.num_classes)


def _pair(ds):
    """(reference dataset, port dataset): the same arrays in each
    package's CSR type."""
    A = ds.adj_norm
    tA = tcsr.CSRMatrix(A.indptr.copy(), A.indices.copy(), A.data.copy(),
                        A.shape)
    return ds, types.SimpleNamespace(
        adj_norm=tA, features=ds.features, labels=ds.labels,
        train_mask=ds.train_mask, num_classes=ds.num_classes)


@pytest.fixture(scope="module", params=["sbm", "isolated"])
def graphs(request, ds):
    return _pair(ds if request.param == "sbm" else _with_isolated(ds))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# Graph structures, bit for bit
# ---------------------------------------------------------------------------

def test_locality_order_and_permutation_match_reference(graphs):
    jds, tds = graphs
    order = tpart.locality_order(tds.adj_norm)
    assert _same(order, jpart.locality_order(jds.adj_norm))
    assert np.array_equal(np.sort(order), np.arange(N))
    got = tpart.permute_csr(tds.adj_norm, order)
    want = jpart.permute_csr(jds.adj_norm, order)
    for f in ("indptr", "indices", "data"):
        assert _same(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("g, clusters", [(1, 16), (2, 8)])
def test_clustered_partition_matches_reference(graphs, g, clusters):
    jds, tds = graphs
    got, want = tbuild(tds, g=g, clusters=clusters), jbuild(
        jds, g=g, clusters=clusters)
    for f in dataclasses.fields(want):
        assert _same(getattr(got, f.name), getattr(want, f.name)) \
            if isinstance(getattr(want, f.name), np.ndarray) \
            else getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.n_local % clusters == 0 and got.cluster_size == \
        want.cluster_size
    assert got.max_cluster_block_nnz == tpart.max_cluster_block_nnz(
        got.block_rp, clusters) == jpart.max_cluster_block_nnz(
            want.block_rp, clusters)


@pytest.mark.parametrize("g", [1, 2])
def test_walk_tables_match_reference(graphs, g):
    jds, tds = graphs
    nbr, p = tpart.build_walk_tables(tbuild(tds, g=g), k=6)
    jnbr, jp = jpart.build_walk_tables(jbuild(jds, g=g), k=6)
    assert _same(nbr, jnbr) and _same(p, jp)


# ---------------------------------------------------------------------------
# The port's samplers: the reference's properties
# ---------------------------------------------------------------------------

# n_local = 400, cluster_size = 20, b_local = 100, q = 5
CFG_P = tsmp.SampleConfig(n_pad=800, g=2, batch=200, e_cap=256,
                          clusters=20).validate()


def _key(k):
    return tsmp.key_tensor(k, "cpu")


def test_partition_sample_is_whole_sorted_clusters():
    s2d = tsmp.sample_partition_stratified(_key(0), CFG_P).numpy()
    cs, q = CFG_P.cluster_size, CFG_P.clusters_per_step
    assert s2d.shape == (CFG_P.g, CFG_P.b_local) and s2d.dtype == np.int32
    for i in range(CFG_P.g):
        ids = s2d[i]
        lo = i * CFG_P.n_local
        assert np.all((ids >= lo) & (ids < lo + CFG_P.n_local))
        assert np.all(np.diff(ids) > 0)
        cl = (ids - lo) // cs
        assert np.unique(cl).size == q
        for c in np.unique(cl):
            assert np.array_equal(ids[cl == c],
                                  lo + np.arange(c * cs, (c + 1) * cs))


def test_partition_epoch_slice0_equals_step_sampler():
    a = tsmp.sample_partition_stratified(_key(3), CFG_P)
    assert torch.equal(a, tsmp.sample_partition_epoch(_key(3), CFG_P, 0))
    assert torch.equal(a, tsmp.sample_partition_epoch(
        _key(3), CFG_P, torch.tensor(0, dtype=torch.int32)))


def test_partition_epoch_covers_every_vertex_once():
    key = _key(tsmp.epoch_key(0, 1))
    assert CFG_P.steps_per_epoch == 4
    s2d = [tsmp.sample_partition_epoch(key, CFG_P, t).numpy()
           for t in range(4)]
    for i in range(CFG_P.g):
        got = np.sort(np.concatenate([s[i] for s in s2d]))
        assert np.array_equal(got, np.arange(i * 400, (i + 1) * 400))


def test_partition_epoch_dp_ranks_disjoint_and_jointly_cover():
    cfg = tsmp.SampleConfig(n_pad=800, g=2, batch=200, e_cap=256,
                            clusters=20, dp_groups=2).validate()
    assert cfg.steps_per_epoch == 2
    b = tmb.MinibatchBuilder(cfg, mode="partition", schedule="epoch",
                             seed=5)
    slices = {(t, d): b.sample_ids(t, None, d, device="cpu").numpy()
              for t in range(2) for d in range(2)}
    for t in range(2):
        for i in range(2):
            assert not np.intersect1d(slices[(t, 0)][i],
                                      slices[(t, 1)][i]).size
    for i in range(2):
        got = np.sort(np.concatenate([s[i] for s in slices.values()]))
        assert np.array_equal(got, np.arange(i * 400, (i + 1) * 400))
    # the next epoch draws another permutation
    assert not np.array_equal(slices[(0, 0)], b.sample_ids(
        2, None, 0, device="cpu").numpy())


def test_partition_inclusion_uniform_across_clusters():
    """400 steps x q = 2 of C = 10 clusters: 80 draws per cluster
    expected, sd about 8; within about 4 sd."""
    cfg = tsmp.SampleConfig(n_pad=200, g=1, batch=40, e_cap=64,
                            clusters=10).validate()
    counts = np.zeros(cfg.clusters, np.int64)
    for t in range(400):
        ids = tsmp.sample_partition_stratified(
            _key(tsmp.step_key(0, t)), cfg).numpy()[0]
        counts[np.unique(ids // cfg.cluster_size)] += 1
    assert counts.sum() == 800
    assert counts.min() > 48 and counts.max() < 112, counts


@pytest.fixture(scope="module")
def walk_setup(ds):
    pg = tbuild(_pair(ds)[1], g=2)
    nbr, p_tilde = tpart.build_walk_tables(pg, k=6)
    cfg = tsmp.SampleConfig(n_pad=pg.n_pad, g=2, batch=64,
                            e_cap=32 * pg.max_block_row_nnz, walk_len=3,
                            walk_k=6).validate()
    return pg, torch.from_numpy(nbr), cfg


def test_walk_sample_is_distinct_sorted_and_reachable(walk_setup):
    """Every vertex a walk visits is in the sample (the rest is the random
    fill), each step moves to a table neighbor of the last vertex, and
    the sample is b distinct sorted ids of the range. The walk is replayed
    here from the sampler's own draws: the roots from ``fold_in(key, 0)``,
    step s's choice from ``fold_in(key, 1 + s)``."""
    pg, nbr, cfg = walk_setup
    key = _key(tsmp.step_key(0, 5))
    s2d = tsmp.sample_walk_stratified(key, cfg, nbr).numpy()
    assert s2d.shape == (cfg.g, cfg.b_local)
    R, n_loc = cfg.walk_roots, cfg.n_local
    perm = torch.argsort(tsmp.crng.hash_keys_plain(
        tsmp.fold_in(key, 0), cfg.n_pad).view(cfg.g, n_loc), 1).numpy()
    table = nbr.numpy()
    for i in range(cfg.g):
        lo = i * n_loc
        assert np.all((s2d[i] >= lo) & (s2d[i] < lo + n_loc))
        assert np.all(np.diff(s2d[i]) > 0)
        cur = perm[i, :R] + lo
        visited = set(cur.tolist())
        for s in range(cfg.walk_len):
            h = tsmp.crng.hash_keys_plain(tsmp.fold_in(key, 1 + s),
                                          cfg.g * R).view(cfg.g, R)
            nxt = table[cur, np.remainder(h.numpy()[i], cfg.walk_k)]
            assert all(b in table[a] for a, b in zip(cur, nxt))
            cur = nxt
            visited |= set(cur.tolist())
        assert visited <= set(s2d[i].tolist())
    # a pure function of the key, of the step and, under the epoch
    # schedule, of the root slice; a device counter draws the int's sample
    assert np.array_equal(s2d, tsmp.sample_walk_stratified(
        key, cfg, nbr).numpy())
    assert not np.array_equal(s2d, tsmp.sample_walk_stratified(
        _key(tsmp.step_key(0, 6)), cfg, nbr).numpy())
    e0, e1 = (tsmp.sample_walk_stratified(key, cfg, nbr, t=t).numpy()
              for t in (0, torch.tensor(1, dtype=torch.int32)))
    assert np.array_equal(e0, s2d) and not np.array_equal(e0, e1)
    b = tmb.MinibatchBuilder(cfg, mode="walk", seed=2)
    assert torch.equal(
        b.sample_ids(7, None, 0, device="cpu", aux={"nbr": nbr}),
        b.sample_ids(torch.tensor(7, dtype=torch.int32), None, 0,
                     aux={"nbr": nbr}))


@pytest.mark.parametrize("kw", [
    dict(n_pad=100, g=1, batch=20, e_cap=8, clusters=7),
    dict(n_pad=100, g=1, batch=25, e_cap=8, clusters=10),
    dict(n_pad=100, g=1, batch=30, e_cap=8, clusters=10, dp_groups=2),
    dict(n_pad=100, g=1, batch=20, e_cap=8, dp_groups=2),
    dict(n_pad=100, g=1, batch=20, e_cap=64, clusters=10, walk_len=2,
         walk_k=4),
    dict(n_pad=100, g=1, batch=20, e_cap=64, walk_len=2, walk_k=0),
    dict(n_pad=100, g=1, batch=20, e_cap=64, walk_len=25, walk_k=4),
    dict(n_pad=100, g=1, batch=20, e_cap=64, walk_len=2, walk_k=4),
    dict(n_pad=100, g=1, batch=20, e_cap=8, walk_len=3, walk_k=4),
])
def test_validate_rejects_bad_locality_configs(kw):
    """Every configuration the reference's ``validate`` asserts against
    raises ``ValueError`` here, and the reference's assertion fires."""
    with pytest.raises(ValueError):
        tsmp.SampleConfig(**kw).validate()
    with pytest.raises(AssertionError):
        jsmp.SampleConfig(**kw).validate()


def test_builder_mode_guards():
    """The modes need their fields; the fused extraction kernel rescales
    by a scalar or per column only, so the locality modes raise on
    ``impl="cuda"``, naming the ROADMAP item."""
    ok_p = tsmp.SampleConfig(n_pad=100, g=1, batch=20, e_cap=64, clusters=10)
    ok_w = tsmp.SampleConfig(n_pad=100, g=1, batch=20, e_cap=64, walk_len=3,
                             walk_k=4)
    tmb.MinibatchBuilder(ok_p, mode="partition")
    tmb.MinibatchBuilder(ok_w, mode="walk")
    plain = tsmp.SampleConfig(n_pad=100, g=1, batch=20, e_cap=64)
    for mode in ("partition", "walk"):
        with pytest.raises(ValueError, match=f"{mode} mode needs"):
            tmb.MinibatchBuilder(plain, mode=mode)
    item = "the per-pair rescale inside the extraction kernel"
    for scfg, mode in ((ok_p, "partition"), (ok_w, "walk")):
        with pytest.raises(ValueError, match=item):
            tmb.MinibatchBuilder(scfg, mode=mode, impl="cuda",
                                 max_row_nnz=4)


# ---------------------------------------------------------------------------
# Rescales and extraction against the reference, on its ids
# ---------------------------------------------------------------------------

def _ref_plan(jds, kind, batch=64, **kw):
    clusters = 16 if kind == "partition" else 0
    pg = jbuild(jds, g=1, clusters=clusters)
    cfg = JM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=LAYERS,
                       num_classes=CLASSES, dropout=0.0)
    opts = jfourd.TrainOptions(sample_kind=kind, clusters=clusters,
                               walk_len=3, walk_k=6, **kw)
    plan = jfourd.build_plan(pg, cfg, jfourd.make_mesh_4d(1, 1), batch=batch,
                             opts=opts)
    return plan, plan.shard_graph(pg), pg


def _port_plan(tds, kind, batch=64, **kw):
    clusters = 16 if kind == "partition" else 0
    pg = tbuild(tds, g=1, clusters=clusters)
    cfg = TM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=LAYERS,
                       num_classes=CLASSES, dropout=0.0)
    opts = TrainOptions(sample_kind=kind, clusters=clusters, walk_len=3,
                        walk_k=6, **kw)
    plan = tfourd.build_plan(pg, cfg, tfourd.make_mesh_4d(1, 1, "cpu"),
                             batch=batch, opts=opts)
    return plan, plan.shard_graph(pg), pg


def _ref_ids(jplan, jgraph, step=0):
    return np.asarray(jplan.builder.sample_ids(step, None, 0,
                                               jgraph.get("walk", {})))


@pytest.fixture(scope="module", params=["partition", "walk"])
def kind_plans(request, ds):
    jds, tds = _pair(ds)
    kind = request.param
    return (kind, _ref_plan(jds, kind),
            _port_plan(tds, kind, spmm_impl="ell", fused_elementwise=True,
                       ell_tile=TILE, ell_slots=64 // TILE))


def test_col_scale_matches_reference(kind_plans):
    """The per-pair rescale of the reference's sample, within 1e-7 (the
    partition constants exactly)."""
    kind, (jplan, jgraph, _), (tplan, tgraph, _) = kind_plans
    ids = _ref_ids(jplan, jgraph)
    assert tplan.scfg == jplan.scfg
    want = np.asarray(jplan.builder.col_scale_fn(
        jnp.asarray(ids), jgraph.get("walk"))(0, 0))
    got = tplan.builder.col_scale_fn(torch.from_numpy(ids.copy()),
                                     tgraph.get("walk"))(0, 0).numpy()
    assert got.shape == want.shape == (64, 64) and got.dtype == np.float32
    if kind == "partition":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
        assert np.array_equal(tgraph["walk"]["p"].numpy(),
                              np.asarray(jgraph["walk"]["p"]))
        assert np.array_equal(tgraph["walk"]["nbr"].numpy(),
                              np.asarray(jgraph["walk"]["nbr"]))


def test_per_pair_extraction_matches_reference(kind_plans):
    """Dense and block-ELL extraction with the reference's (b, b) rescale
    on the reference's sampled ids: bit for bit."""
    kind, (jplan, jgraph, jpg), _ = kind_plans
    ids = _ref_ids(jplan, jgraph)[0]
    resc = np.asarray(jplan.builder.col_scale_fn(
        jnp.asarray(ids[None]), jgraph.get("walk"))(0, 0))
    csr = (jpg.block_rp[0, 0], jpg.block_ci[0, 0], jpg.block_val[0, 0])
    e_cap = jplan.scfg.e_cap
    want = np.asarray(jsmp.extract_dense_block(
        *map(jnp.asarray, csr), jnp.asarray(ids), jnp.asarray(ids), e_cap,
        rescale_offdiag=jnp.asarray(resc), is_diag_block=True))
    t = [torch.from_numpy(np.asarray(a)) for a in csr]
    tid, tresc = torch.from_numpy(ids.copy()), torch.from_numpy(resc.copy())
    got = tsmp.extract_dense_block(*t, tid, tid, e_cap,
                                   rescale_offdiag=tresc, is_diag_block=True)
    assert _same(got.numpy(), want) and np.count_nonzero(want) > 64
    jt, jc = jsmp.extract_block_ell(
        *map(jnp.asarray, csr), jnp.asarray(ids), jnp.asarray(ids), e_cap,
        rescale_offdiag=jnp.asarray(resc), is_diag_block=True, bm=TILE,
        bn=TILE, n_slots=4)
    tt, tc = tsmp.extract_block_ell(*t, tid, tid, e_cap,
                                    rescale_offdiag=tresc,
                                    is_diag_block=True, bm=TILE, bn=TILE,
                                    n_slots=4)
    assert _same(tt.numpy(), np.asarray(jt)) and _same(tc.numpy(),
                                                       np.asarray(jc))


def test_train_step_matches_reference_with_its_ids(kind_plans):
    """One step through ``fourd.make_train_step`` with the reference's
    sample injected (the port: block-ELL SpMM, fused tail, plain
    extraction; the reference: dense, its "jax" extraction): loss within
    1e-5, every gradient leaf and the params after one AdamW step within
    1e-4 of the leaf's largest |value|."""
    kind, (jplan, jgraph, _), (tplan, tgraph, _) = kind_plans
    assert (tplan.opts.spmm_impl, jplan.opts.spmm_impl) == ("ell", "dense")
    params = JM.init_params(jax.random.PRNGKey(1), jplan.cfg)
    jloss = jfourd.make_loss_fn(jplan)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, jgraph, jnp.asarray(0)).mean()))(params)
    ids = torch.from_numpy(_ref_ids(jplan, jgraph).copy())
    np_params = jax.tree.map(np.asarray, params)
    tl, tg = tfourd.value_and_grad(
        tfourd.make_loss_fn(tplan),
        TM.params_from_numpy(np_params, device="cpu"), tgraph, 0, ids=ids)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(leaves(tg), jax.tree.leaves(jg)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()
    from repro import optim as jopt
    jo = jopt.AdamW(lr=1e-2, weight_decay=1e-4, grad_clip=1.0)
    jp1 = jfourd.make_train_step(jplan, jo)(params, jo.init(params), jgraph,
                                            jnp.asarray(0))[0]
    to = topt.AdamW(lr=1e-2, weight_decay=1e-4, grad_clip=1.0)
    tp = TM.params_from_numpy(np_params, device="cpu")
    tp1 = tfourd.make_train_step(tplan, to)(tp, to.init(tp), tgraph, 0,
                                            ids=ids)[0]
    for a, b in zip(leaves(tp1), jax.tree.leaves(jp1)):
        b = np.asarray(b)
        assert np.abs(a.detach().numpy() - b).max() <= \
            1e-4 * np.abs(b).max()



# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["partition", "walk"])
def test_trainer_prefetch_equivalence_and_epoch_resume(ds, tmp_path, kind):
    """Two epochs with prefetch on equal prefetch off bit for bit; a run
    restored from a checkpoint before the first epoch boundary crosses it
    and equals the straight run (losses and params), as the reference's
    ``test_trainer_prefetch_equivalence_and_epoch_resume`` holds it."""
    tds = _pair(ds)[1]
    if kind == "partition":
        plan, graph, _ = _port_plan(tds, kind, sample_mode="epoch",
                                    dropout=0.3)
    else:
        plan, graph, _ = _port_plan(tds, kind, batch=32, dropout=0.3)
    spe = plan.scfg.steps_per_epoch
    mk = lambda: TM.init_params(plan.cfg, torch.Generator().manual_seed(1),
                                device="cpu")
    opt = topt.AdamW(lr=5e-3)
    total = 2 * spe
    off = Trainer(plan, opt, TrainLoopConfig(total_steps=total,
                                             chunk_size=3))
    _, log_off = off.run(off.init_state(mk()), graph)
    res = max(3, (spe - 1) // 3 * 3)
    assert res < spe
    tr = Trainer(plan, opt, TrainLoopConfig(
        total_steps=total, chunk_size=3, prefetch=True,
        ckpt_dir=str(tmp_path), ckpt_every=res))
    full, log_on = tr.run(tr.init_state(mk(), graph), graph)
    assert log_on.losses == log_off.losses
    assert np.all(np.isfinite(log_on.losses))
    state = tr.restore(tr.init_state(mk(), graph), step=res)
    assert int(state.step) == res
    state, log_res = tr.run(state, graph)
    assert log_res.losses == log_on.losses[res:]
    assert all(torch.equal(a, b) for a, b in zip(leaves(full.params),
                                                 leaves(state.params)))


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------

REFERENCE_2X1 = textwrap.dedent("""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.core import fourd, gcn_model as M
from repro.graphs import make_synthetic_dataset, build_partitioned_graph

N, D_IN, D_H, LAYERS, CLASSES, BATCH, CLUSTERS = {consts}
ds = make_synthetic_dataset(n=N, num_classes=CLASSES, d_in=D_IN,
                            avg_degree=8, seed=0)
pg = build_partitioned_graph(ds, g=1, clusters=CLUSTERS)
cfg = M.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=LAYERS,
                  num_classes=CLASSES, dropout=0.0)
opts = fourd.TrainOptions(sample_kind="partition", sample_mode="epoch",
                          clusters=CLUSTERS)
plan = fourd.build_plan(pg, cfg, fourd.make_mesh_4d(2, 1), batch=BATCH,
                        opts=opts)
p = M.init_params(jax.random.PRNGKey(1), cfg)
graph = plan.shard_graph(pg)
out = {{"ids": np.stack([np.asarray(plan.builder.sample_ids(0, None, d))
                        for d in range(2)]),
       "losses": np.asarray(jax.jit(fourd.make_loss_fn(plan))(
           plan.shard_params(p), graph, jnp.asarray(0))),
       "w_in": np.asarray(p["w_in"]), "w_out": np.asarray(p["w_out"])}}
for i, layer in enumerate(p["layers"]):
    out[f"w_{{i}}"] = np.asarray(layer["w"])
    out[f"rms_{{i}}"] = np.asarray(layer["rms_scale"])
np.savez(sys.argv[1], **out)
print("PASS")
""").format(consts=(DIST_N, D_IN, D_H, LAYERS, CLASSES, DIST_BATCH,
                    DIST_CLUSTERS))


def _spawn(mode, world, out_dir, *extra):
    """Run ``world`` gloo ranks of this file's worker; each must exit 0
    within RANK_TIMEOUT_S, or all are killed and the test fails with
    their output."""
    procs = []
    for rank in range(world):
        env = dict(_env(), RANK=str(rank), WORLD_SIZE=str(world),
                   STORE=os.path.join(out_dir, "store"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, out_dir,
             *extra], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
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
    runs = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            runs.append({k: f[k] for k in f.files})
    return runs


def test_partition_epoch_dp_slices_and_losses_on_gloo_2x1(tmp_path):
    """(G_d, g) = (2, 1), partition + epoch: the two groups share one
    cluster permutation per epoch and take disjoint slices that together
    cover every vertex once; with the reference's ids injected (its run on
    2 forced host devices) the per-group losses match within 1e-5."""
    ref = tmp_path / "ref.npz"
    env = dict(_env(), XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "-c", REFERENCE_2X1, str(ref)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "PASS" in r.stdout, r.stderr[-3000:]
    runs = _spawn("epoch2x1", 2, str(tmp_path), str(ref))
    spe = int(runs[0]["spe"])
    assert spe == 2
    for epoch in range(2):
        steps = range(epoch * spe, (epoch + 1) * spe)
        got = np.concatenate([runs[d][f"ids_{t}"][0] for t in steps
                              for d in range(2)])
        assert np.array_equal(np.sort(got), np.arange(DIST_N))
    assert not np.array_equal(runs[0]["ids_0"], runs[0]["ids_2"])
    want = np.load(ref)["losses"]
    for run in runs:
        np.testing.assert_allclose(run["losses"], want, rtol=1e-5)


def test_sampling_makes_no_collective_call_on_gloo_1x2(tmp_path):
    """(1, 2), eight ranks, partition and walk: building each rank's batch
    calls no ``torch.distributed`` collective or point-to-point op, and
    every rank of the group derives the same sample (whole clusters for
    partition; distinct sorted in-range ids for walk)."""
    runs = _spawn("sample1x2", 8, str(tmp_path))
    for r, run in enumerate(runs):
        assert int(run["collective_calls"]) == 0, r
        for k, v in run.items():
            if k.endswith("_ids"):
                assert np.array_equal(v, runs[0][k]), (r, k)
    n_loc = DIST_N // 2
    cs = n_loc // DIST_CLUSTERS
    for step in range(3):
        part, walk = runs[0][f"partition_{step}_ids"], \
            runs[0][f"walk_{step}_ids"]
        for i in range(2):
            assert np.all(np.diff(walk[i]) > 0)
            assert np.all(walk[i] // n_loc == i)
            local = part[i] - i * n_loc
            assert np.array_equal(local.reshape(-1, cs) % cs,
                                  np.tile(np.arange(cs), (local.size // cs,
                                                          1)))
