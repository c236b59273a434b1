"""The port's baselines (``core/baselines.py``, ``gcn_model.sage_forward``)
against the JAX package's.

The port's draws are counter draws and cannot reproduce ``jax.random``'s,
so each sampler is held to the reference from the reference's draws on:
SAINT's normalized adjacency and loss weights from its sampled ids (within
1e-6), SAGE's frontiers and neighbor maps from its sampled neighbors (bit
for bit) and ``sage_forward``'s logits on its batch (within 1e-5, with its
dropout masks injected); and to the reference's properties for the port's
own draws (SAINT's B distinct sorted ids; SAGE's frontier-prefix
invariant, every sampled neighbor a true one). The full-batch GCN's loss
and gradients are held within 1e-5 and 1e-4 of each leaf's largest
|value|, one AdamW step within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as jopt  # noqa: E402
from repro.core import baselines as JB  # noqa: E402
from repro.core import fourd as jfourd  # noqa: E402
from repro.core import gcn_model as JM  # noqa: E402
from repro.graphs import build_partitioned_graph as jbuild  # noqa: E402
from repro.graphs import make_synthetic_dataset  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.core import baselines as TB  # noqa: E402
from repro_torch.core import fourd as tfourd  # noqa: E402
from repro_torch.core import gcn_model as TM  # noqa: E402
from repro_torch.core.forward import TrainOptions  # noqa: E402
from repro_torch.core.minibatch import MinibatchBuilder  # noqa: E402
from repro_torch.core.sampling import SampleConfig  # noqa: E402
from repro_torch.graphs import build_partitioned_graph as tbuild  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

N, D_IN, D_H, CLASSES, B = 256, 16, 32, 4, 64


@pytest.fixture(scope="module")
def setup():
    ds = make_synthetic_dataset(n=N, num_classes=CLASSES, d_in=D_IN,
                                avg_degree=8, seed=0)
    A = ds.adj_norm
    np_ = {"rp": A.indptr, "ci": A.indices, "val": A.data,
           "feats": ds.features.astype(np.float32),
           "labels": ds.labels.astype(np.int32),
           "deg": np.diff(A.indptr).astype(np.float32),
           "e_cap": B * A.max_row_nnz()}
    return ds, np_


def _t(np_):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            if isinstance(v, np.ndarray) else v for k, v in np_.items()}


def _j(np_):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in np_.items()}


def _params(layers):
    cfg = JM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=layers,
                       num_classes=CLASSES, dropout=0.0)
    p = JM.init_params(jax.random.PRNGKey(0), cfg)
    for i, layer in enumerate(p["layers"]):
        layer["rms_scale"] = layer["rms_scale"] * (1.0 + 0.1 * i)
    return cfg, p


def _tcfg(jcfg, **kw):
    return TM.GCNConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(jcfg)
                           if f.name not in ("elementwise_impl",
                                             "spmm_impl")}, **kw)


# ---------------------------------------------------------------------------
# GraphSAINT
# ---------------------------------------------------------------------------

def test_saint_batch_matches_reference_on_its_ids(setup):
    _, np_ = setup
    j, t = _j(np_), _t(np_)
    sb = JB.saint_node_sample(jax.random.PRNGKey(1), j["rp"], j["ci"],
                              j["val"], j["feats"], j["labels"], j["deg"],
                              N, B, np_["e_cap"])
    s = torch.from_numpy(np.asarray(sb.vertex_ids).astype(np.int32))
    builder = MinibatchBuilder(SampleConfig(n_pad=N, g=1, batch=B,
                                            e_cap=np_["e_cap"]), mode="exact")
    got = TB.saint_batch(s, t["rp"], t["ci"], t["val"], t["feats"],
                         t["labels"], t["deg"], np_["e_cap"], builder)
    np.testing.assert_allclose(got.adj.numpy(), np.asarray(sb.adj),
                               rtol=1e-6, atol=1e-6)
    assert np.count_nonzero(np.asarray(sb.adj)) > B
    np.testing.assert_allclose(got.loss_weights.numpy(),
                               np.asarray(sb.loss_weights), rtol=1e-6,
                               atol=1e-6)
    assert np.array_equal(got.feats.numpy(), np.asarray(sb.feats))
    assert np.array_equal(got.labels.numpy(), np.asarray(sb.labels))


def test_saint_draw_gives_b_distinct_sorted_ids(setup):
    """The port's own draw: B distinct sorted ids, a pure function of the
    key; the weight-proportional draw never takes a zero-degree vertex
    before a positive one while positive ones remain; the batch is
    :func:`saint_batch` of those ids."""
    _, np_ = setup
    t = _t(np_)
    sb = TB.saint_node_sample(7, t["rp"], t["ci"], t["val"], t["feats"],
                              t["labels"], t["deg"], N, B, np_["e_cap"])
    s = sb.vertex_ids.numpy()
    assert s.dtype == np.int32 and s.shape == (B,)
    assert np.all(np.diff(s) > 0) and s.min() >= 0 and s.max() < N
    assert torch.equal(sb.vertex_ids, TB.saint_draw(7, t["deg"], B))
    assert not torch.equal(sb.vertex_ids, TB.saint_draw(8, t["deg"], B))
    deg = t["deg"].clone()
    deg[: N - B // 2] = 0.0                  # only B/2 vertices can win
    s0 = TB.saint_draw(7, deg, B).numpy()
    assert np.array_equal(s0[B // 2:], np.arange(N - B // 2, N))
    w = TB.saint_batch(sb.vertex_ids, t["rp"], t["ci"], t["val"], t["feats"],
                       t["labels"], t["deg"], np_["e_cap"], MinibatchBuilder(
                           SampleConfig(n_pad=N, g=1, batch=B,
                                        e_cap=np_["e_cap"]), mode="exact"))
    assert torch.equal(w.adj, sb.adj)
    assert torch.allclose(w.loss_weights.mean(), torch.tensor(1.0))


# ---------------------------------------------------------------------------
# GraphSAGE
# ---------------------------------------------------------------------------

FANOUTS = (4, 3)


def _ref_sage(np_, seed=2):
    j = _j(np_)
    return JB.sage_sample(jax.random.PRNGKey(seed), j["rp"], j["ci"],
                          j["feats"], j["labels"], N, 32, list(FANOUTS))


def _inject(sgb, np_):
    """The port's batch of the reference's draws."""
    f = [np.asarray(x) for x in sgb.frontiers]
    sampled = [torch.from_numpy(np.array(f[i + 1][len(f[i]):]).reshape(
        len(f[i]), k))
               for i, k in enumerate(FANOUTS)]
    t = _t(np_)
    return TB.sage_batch(torch.from_numpy(np.array(f[0])), sampled,
                         t["feats"], t["labels"])


def test_sage_batch_matches_reference_on_its_draws(setup):
    _, np_ = setup
    sgb = _ref_sage(np_)
    got = _inject(sgb, np_)
    for a, b in zip(got.frontiers, sgb.frontiers):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got.neighbors, sgb.neighbors):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(got.feats.numpy(), np.asarray(sgb.feats))
    assert np.array_equal(got.labels.numpy(), np.asarray(sgb.labels))


def test_sage_sample_frontier_invariant(setup):
    """The port's draws: frontier l + 1 starts with frontier l, the sizes
    explode by (1 + k) a layer, the targets are sorted distinct ids and
    every sampled neighbor is a true neighbor of its row."""
    _, np_ = setup
    t = _t(np_)
    sgb = TB.sage_sample(3, t["rp"], t["ci"], t["feats"], t["labels"], N,
                         16, FANOUTS)
    f = [x.numpy() for x in sgb.frontiers]
    assert [len(x) for x in f] == [16, 80, 320]
    assert np.all(np.diff(f[0]) > 0)
    for i, k in enumerate(FANOUTS):
        assert np.array_equal(f[i + 1][:len(f[i])], f[i])
        nbrs = f[i + 1][len(f[i]):].reshape(len(f[i]), k)
        for row, picks in zip(f[i], nbrs):
            true = np_["ci"][np_["rp"][row]:np_["rp"][row + 1]]
            assert set(picks.tolist()) <= set(true.tolist()) | {row}
        assert np.array_equal(sgb.neighbors[i].numpy(),
                              len(f[i]) + np.arange(nbrs.size).reshape(
                                  nbrs.shape))
    again = TB.sage_sample(3, t["rp"], t["ci"], t["feats"], t["labels"], N,
                           16, FANOUTS)
    assert all(torch.equal(a, b) for a, b in zip(again.frontiers,
                                                 sgb.frontiers))


@pytest.mark.parametrize("impl, dropout", [("torch", 0.0), ("cuda", 0.0),
                                           ("cuda", 0.3)])
def test_sage_forward_matches_reference(setup, impl, dropout):
    """Logits on the reference's batch within 1e-5 of its largest |logit|
    (with dropout: the reference's bernoulli masks injected), through the
    plain tail and the fused tail's plain version."""
    _, np_ = setup
    sgb = _ref_sage(np_)
    jcfg, jp = _params(len(FANOUTS))
    jcfg = dataclasses.replace(jcfg, dropout=dropout)
    key = jax.random.PRNGKey(9)
    train = dropout > 0
    want = np.asarray(JM.sage_forward(jp, sgb, jcfg, train=train,
                                      dropout_key=key if train else None))
    masks = None
    if train:
        masks = [torch.from_numpy(np.array(jax.random.bernoulli(
            k, 1.0 - dropout, (len(sgb.frontiers[li]), D_H))))
            for li, k in enumerate(jax.random.split(key, len(FANOUTS)))]
    tcfg = _tcfg(jcfg, elementwise_impl=impl)
    got = TM.sage_forward(TM.params_from_numpy(jax.tree.map(np.asarray, jp),
                                               device="cpu"),
                          _inject(sgb, np_), tcfg, train=train,
                          keep_masks=masks).numpy()
    assert got.shape == (32, CLASSES)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# Full-batch GCN
# ---------------------------------------------------------------------------

def test_fullbatch_gcn_matches_reference(setup):
    """Loss within 1e-5, every gradient leaf within 1e-4 of its largest
    |value|, and one clipped AdamW step within 1e-4: the port's "csr"
    engine with the fused tail (plain on the CPU) against the
    reference's."""
    ds, _ = setup
    jcfg, jp = _params(3)
    jplan = jfourd.build_plan(jbuild(ds, g=1), jcfg,
                              jfourd.make_mesh_4d(1, 1), batch=B)
    jgraph = jplan.shard_graph(jbuild(ds, g=1))
    jloss = JB.make_fullbatch_gcn_loss(jplan)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, jgraph, jnp.asarray(0)).mean()))(jp)
    tplan = tfourd.build_plan(tbuild(ds, g=1), _tcfg(jcfg),
                              tfourd.make_mesh_4d(1, 1, "cpu"), batch=B,
                              opts=TrainOptions(fused_elementwise=True))
    tgraph = tplan.shard_graph(tbuild(ds, g=1))
    np_p = jax.tree.map(np.asarray, jp)
    tloss = TB.make_fullbatch_gcn_loss(tplan)
    assert tloss(TM.params_from_numpy(np_p, device="cpu"), tgraph,
                 0).shape == (1,)
    tl, tg = tfourd.value_and_grad(
        tloss, TM.params_from_numpy(np_p, device="cpu"), tgraph, 0)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(leaves(tg), jax.tree.leaves(jg)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()
    jo = jopt.AdamW(lr=1e-2, weight_decay=1e-4, grad_clip=1.0)
    jp1, _, jl1 = JB.make_fullbatch_gcn_step(jplan, jo)(
        jp, jo.init(jp), jgraph, jnp.asarray(0))
    to = topt.AdamW(lr=1e-2, weight_decay=1e-4, grad_clip=1.0)
    tp = TM.params_from_numpy(np_p, device="cpu")
    tp1, _, tl1 = TB.make_fullbatch_gcn_step(tplan, to)(tp, to.init(tp),
                                                        tgraph, 0)
    np.testing.assert_allclose(float(tl1), float(jl1), rtol=1e-5)
    for a, b in zip(leaves(tp1), jax.tree.leaves(jp1)):
        b = np.asarray(b)
        assert np.abs(a.detach().numpy() - b).max() <= 1e-4 * np.abs(b).max()
    with pytest.raises(ValueError, match="samples no batch"):
        tloss.sample(tgraph, 0)
