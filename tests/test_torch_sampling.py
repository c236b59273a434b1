"""The port's samplers (Alg. 1) and block-ELL extraction against the JAX
package.

The port cannot draw ``jax.random.permutation``'s bits, so its extraction
is fed the reference's own sampled ids and must give the reference's
blocks bit for bit, and its samplers are held to the reference's
properties: sorted distinct in-range ids, each vertex once per epoch when
``batch | n``, epoch slice 0 equal to the step sampler, and the same
(seed, epoch, step, dp) giving the same ids.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import minibatch as jmb  # noqa: E402
from repro.core import sampling as jsmp  # noqa: E402
from repro_torch.core import minibatch as tmb  # noqa: E402
from repro_torch.core import sampling as tsmp  # noqa: E402
from repro_torch.graphs import make_synthetic_dataset  # noqa: E402

N, G, B = 512, 2, 128          # two vertex ranges of 256, 64 per range


@pytest.fixture(scope="module")
def graph():
    ds = make_synthetic_dataset(n=N, num_classes=4, d_in=8, avg_degree=12,
                                seed=4)
    return ds


def _t(a):
    """A torch tensor holding a copy of a numpy or JAX array."""
    return torch.from_numpy(np.array(a))


def _csr(ds, torch_side):
    A = ds.adj_norm
    if torch_side:
        return _t(A.indptr), _t(A.indices), _t(A.data)
    return jnp.asarray(A.indptr), jnp.asarray(A.indices), jnp.asarray(A.data)


def _ref_ids(seed=3):
    cfg = jsmp.SampleConfig(n_pad=N, g=G, batch=B, e_cap=1)
    return np.asarray(jsmp.sample_stratified(jax.random.PRNGKey(seed), cfg))


# (bm, n_slots, e_cap fraction): exact slots, overflowing slots, truncating
# e_cap
ELL_CASES = [(16, 4, 1.0), (16, 1, 1.0), (32, 2, 0.25)]


@pytest.mark.parametrize("bm,n_slots,e_frac", ELL_CASES)
@pytest.mark.parametrize("i,j", [(0, 0), (0, 1)])
def test_extract_block_ell_bitmatches_jax(graph, bm, n_slots, e_frac, i, j):
    """Stratified ELL extraction of block (i, j) of the reference's own
    sample: tiles and colidx bit for bit (diagonal and not, slots
    overflowing, e_cap exact and truncating)."""
    ids = _ref_ids()
    e_cap = int(B // G * graph.adj_norm.max_row_nnz() * e_frac)
    cfg = tsmp.SampleConfig(n_pad=N, g=G, batch=B, e_cap=e_cap)
    inv_same, inv_cross = tsmp.rescale_constants(cfg)
    kw = dict(row_range=i, col_range=j, inv_same=inv_same,
              inv_cross=inv_cross, bm=bm, bn=bm, n_slots=n_slots)
    jt, jc = jsmp.extract_block_ell_stratified(
        *_csr(graph, False), jnp.asarray(ids[i]), jnp.asarray(ids[j]),
        e_cap, **kw)
    tt, tc = tsmp.extract_block_ell_stratified(
        *_csr(graph, True), _t(ids[i]),
        _t(ids[j]), e_cap, **kw)
    assert np.count_nonzero(np.asarray(jt)) > 0
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    dense_kw = {k: kw[k] for k in ("row_range", "col_range", "inv_same",
                                   "inv_cross")}
    np.testing.assert_array_equal(
        tsmp.extract_dense_block_stratified(
            *_csr(graph, True), _t(ids[i]), _t(ids[j]), e_cap,
            **dense_kw).numpy(),
        np.asarray(jsmp.extract_dense_block_stratified(
            *_csr(graph, False), jnp.asarray(ids[i]), jnp.asarray(ids[j]),
            e_cap, **dense_kw)))
    # the dense route (the cuda backend's layout) gives the same blocks
    # when no slot overflows
    if n_slots >= 4 and e_frac == 1.0:
        builder = tmb.MinibatchBuilder(
            scfg=cfg, fmt=tmb.BlockFormat.ELL, impl="cuda", ell_tile=bm,
            ell_slots=n_slots, max_row_nnz=graph.adj_norm.max_row_nnz())
        dt, dc = builder.extract_block(
            *_csr(graph, True), _t(ids[i]),
            _t(ids[j]),
            col_scale=tsmp.stratified_col_scale(i, j, inv_same, inv_cross),
            diag=i == j)
        assert torch.equal(dt, tt) and torch.equal(dc, tc)


def test_extract_block_ell_per_column_scale_bitmatches_jax(graph):
    """The plain (non-stratified) form with a per-column rescale."""
    ids = _ref_ids(seed=8)[0]
    scale = np.random.default_rng(0).uniform(0.5, 3.0, ids.shape[0]) \
        .astype(np.float32)
    e_cap = ids.shape[0] * graph.adj_norm.max_row_nnz()
    kw = dict(is_diag_block=True, bm=16, bn=16, n_slots=3)
    jt, jc = jsmp.extract_block_ell(*_csr(graph, False), jnp.asarray(ids),
                                    jnp.asarray(ids), e_cap,
                                    rescale_offdiag=jnp.asarray(scale), **kw)
    tt, tc = tsmp.extract_block_ell(*_csr(graph, True), _t(ids),
                                    _t(ids), e_cap,
                                    rescale_offdiag=torch.from_numpy(scale),
                                    **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_make_minibatch_stratified_with_injected_ids(graph):
    ids = _ref_ids(seed=11)
    e_cap = B // G * graph.adj_norm.max_row_nnz()
    jcfg = jsmp.SampleConfig(n_pad=N, g=G, batch=B, e_cap=e_cap)
    feats = graph.features.astype(np.float32)
    labels = graph.labels.astype(np.int32)
    key = jax.random.PRNGKey(11)
    ref = jsmp.make_minibatch_stratified(
        key, *_csr(graph, False), jnp.asarray(feats), jnp.asarray(labels),
        jcfg)
    np.testing.assert_array_equal(np.asarray(ref.vertex_ids),
                                  ids.reshape(-1))
    got = tsmp.make_minibatch_stratified(
        None, *_csr(graph, True), torch.from_numpy(feats),
        torch.from_numpy(labels),
        tsmp.SampleConfig(n_pad=N, g=G, batch=B, e_cap=e_cap),
        ids=_t(ids))
    for name in ("adj", "feats", "labels", "vertex_ids"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))


@pytest.mark.parametrize("n_pad,g,batch", [(512, 2, 128), (1000, 1, 7),
                                           (64, 4, 64), (10, 1, 1)])
def test_rescale_constants_equal_reference(n_pad, g, batch):
    assert tsmp.rescale_constants(tsmp.SampleConfig(n_pad, g, batch, 1)) \
        == jsmp.rescale_constants(jsmp.SampleConfig(n_pad, g, batch, 1))
    for mode in ("exact", "stratified"):
        if mode == "exact" and g != 1:
            continue
        tb = tmb.MinibatchBuilder(tsmp.SampleConfig(n_pad, g, batch, 1),
                                  mode=mode)
        jb = jmb.MinibatchBuilder(jsmp.SampleConfig(n_pad, g, batch, 1),
                                  mode=mode)
        assert tb.rescale_constants() == jb.rescale_constants()
        assert tb.steps_per_epoch == jb.steps_per_epoch


@pytest.mark.parametrize("mode", ["exact", "stratified"])
def test_sampler_ids_sorted_distinct_in_range(mode):
    g = 1 if mode == "exact" else 4
    cfg = tsmp.SampleConfig(n_pad=400, g=g, batch=40, e_cap=1)
    b = tmb.MinibatchBuilder(cfg, mode=mode, seed=5)
    for schedule in ("step", "epoch"):
        b = tmb.MinibatchBuilder(cfg, mode=mode, schedule=schedule, seed=5)
        for step in (0, 3, 17):
            s2d = b.sample_ids(step, None, 0, device="cpu")
            assert s2d.shape == (g, 40 // g) and s2d.dtype == torch.int32
            for i, row in enumerate(s2d.numpy()):
                assert np.all(np.diff(row) > 0)
                assert row.min() >= i * cfg.n_local
                assert row.max() < (i + 1) * cfg.n_local


@pytest.mark.parametrize("mode", ["exact", "stratified"])
def test_epoch_schedule_covers_every_vertex_once(mode):
    g = 1 if mode == "exact" else 2
    cfg = tsmp.SampleConfig(n_pad=240, g=g, batch=24, e_cap=1)
    b = tmb.MinibatchBuilder(cfg, mode=mode, schedule="epoch", seed=1)
    assert b.steps_per_epoch == 10
    for epoch in (0, 1):
        seen = np.concatenate([
            b.sample_ids(epoch * 10 + t, epoch, 0, device="cpu")
            .numpy().reshape(-1) for t in range(10)])
        np.testing.assert_array_equal(np.sort(seen), np.arange(240))
    e0 = b.sample_ids(0, 0, 0, device="cpu")
    e1 = b.sample_ids(10, 1, 0, device="cpu")
    assert not torch.equal(e0, e1)


def test_epoch_slice0_equals_step_sampler_and_keys_are_pure():
    cfg = tsmp.SampleConfig(n_pad=300, g=3, batch=30, e_cap=1)
    key = tsmp.key_tensor(tsmp.epoch_key(9, 2, 1), "cpu")
    assert torch.equal(tsmp.sample_epoch_exact(key, 300, 30, 0),
                       tsmp.sample_uniform_exact(key, 300, 30))
    assert torch.equal(tsmp.sample_epoch_stratified(key, cfg, 0),
                       tsmp.sample_stratified(key, cfg))
    # a slice index on the device gives the host index's slice
    for t in (0, 3, 9):
        assert torch.equal(
            tsmp.sample_epoch_stratified(key, cfg, torch.tensor(t)),
            tsmp.sample_epoch_stratified(key, cfg, t))
    # step and epoch keys are the same mix, fixed across calls
    assert tsmp.step_key(9, 2, 1) == tsmp.epoch_key(9, 2, 1)
    keys = {tsmp.step_key(s, t, d) for s in range(3) for t in range(3)
            for d in range(3)}
    assert len(keys) == 27 and all(0 <= k < 2 ** 64 for k in keys)
    b = tmb.MinibatchBuilder(cfg, seed=4)
    same = [b.sample_ids(7, None, 1, device="cpu") for _ in range(2)]
    assert torch.equal(*same)
    assert not torch.equal(same[0], b.sample_ids(8, None, 1, device="cpu"))
    assert not torch.equal(same[0], b.sample_ids(7, None, 0, device="cpu"))
    # a device counter draws the sample of the same int
    assert torch.equal(same[0], b.sample_ids(
        torch.tensor(7, dtype=torch.int32), None, 1))


def test_build_single_and_build_match_direct_extraction(graph):
    A = graph.adj_norm
    cfg = tsmp.SampleConfig(n_pad=N, g=1, batch=64, e_cap=64 *
                            A.max_row_nnz())
    feats = torch.from_numpy(graph.features.astype(np.float32))
    labels = torch.from_numpy(graph.labels.astype(np.int32))
    b = tmb.MinibatchBuilder(cfg, mode="exact", seed=2)
    mb = b.build_single(tsmp.key_tensor(5, "cpu"), *_csr(graph, True),
                        feats, labels)
    s = mb.vertex_ids
    inv = (N - 1) / 63
    assert torch.equal(mb.adj, tsmp.extract_dense_block(
        *_csr(graph, True), s, s, cfg.e_cap, rescale_offdiag=inv,
        is_diag_block=True))
    # the exact Alg.-1 batch: the same key gives the same batch, and its
    # block is the reference's for those ids
    mb2 = tsmp.make_minibatch_exact(tsmp.key_tensor(5, "cpu"),
                                    *_csr(graph, True), feats, labels, N, 64,
                                    cfg.e_cap)
    assert torch.equal(mb2.vertex_ids, s) and torch.equal(mb2.adj, mb.adj)
    np.testing.assert_array_equal(mb2.adj.numpy(), np.asarray(
        jsmp.extract_dense_block(*_csr(graph, False), jnp.asarray(s.numpy()),
                                 jnp.asarray(s.numpy()), cfg.e_cap,
                                 rescale_offdiag=inv, is_diag_block=True)))
    assert torch.equal(mb2.labels, labels[s.long()])
    ell = tmb.MinibatchBuilder(cfg, fmt=tmb.BlockFormat.ELL, ell_tile=16,
                               ell_slots=4, seed=2)
    got = ell.build(*_csr(graph, True), feats, labels, step=3, epoch=None)
    ids = ell.sample_ids(3, None, 0, device="cpu")[0]
    want = tsmp.extract_block_ell(*_csr(graph, True), ids, ids, cfg.e_cap,
                                  rescale_offdiag=ell.rescale_constants()[0],
                                  is_diag_block=True, bm=16, bn=16, n_slots=4)
    assert all(torch.equal(a, w) for a, w in zip(got.adj[0], want))
    assert torch.equal(got.feats, feats[ids.long()])


def test_unported_modes_raise():
    """What the port still refuses: the locality modes on the fused
    extraction kernel, whose rescale is a scalar or per column (a per-pair
    one is a ROADMAP item, named by its title); DP-sliced permutations
    outside partition mode, as in the reference (the other modes fold the
    DP index into the key); g > 1 through the single-device ``build``
    (a rank of the mesh builds with ``build_local``)."""
    item = "the per-pair rescale inside the extraction kernel"
    with pytest.raises(ValueError, match=item):
        tmb.MinibatchBuilder(tsmp.SampleConfig(n_pad=64, g=1, batch=8,
                                               e_cap=16, clusters=8),
                             mode="partition", impl="cuda", max_row_nnz=2)
    with pytest.raises(ValueError, match=item):
        tmb.MinibatchBuilder(tsmp.SampleConfig(64, 1, 8, 16, walk_len=3,
                                               walk_k=4),
                             mode="walk", impl="cuda", max_row_nnz=2)
    with pytest.raises(ValueError, match="requires partition mode"):
        tsmp.SampleConfig(n_pad=64, g=1, batch=8, e_cap=1,
                          dp_groups=2).validate()
    with pytest.raises(ValueError, match="build_local"):
        tmb.MinibatchBuilder(tsmp.SampleConfig(64, 2, 8, 1)).build(
            *(torch.zeros(1),) * 5, step=0)


@pytest.mark.parametrize("coords", [(0, 0, 0), (1, 0, 1), (0, 1, 1),
                                    (1, 1, 1)])
def test_build_local_on_a_rank_of_the_2x2x2_mesh(graph, coords):
    """g = 2: one rank's batch from its CSR blocks of the three rotation
    planes, (z, x), (y, z) and (x, y), with the reference's sample: each
    plane's block is that (i, j) block of the one-device stratified batch,
    bit for bit; planes with the same block share it; the feature rows are
    range x's (all columns here) and the label rows range x's (the final
    row axis after 3 layers)."""
    from repro_torch.graphs import build_partitioned_graph
    pg = build_partitioned_graph(graph, g=G)
    c = dict(zip("xyz", coords), d=0)
    cfg = tsmp.SampleConfig(n_pad=N, g=G, batch=B,
                            e_cap=(B // G) * pg.max_block_row_nnz)
    ids = _t(_ref_ids())
    one = tsmp.make_minibatch_stratified(
        None, *_csr(graph, True), torch.zeros((N, 1)),
        torch.zeros(N, dtype=torch.int32), cfg, ids=ids)
    blk = lambda i, j: (torch.from_numpy(pg.block_rp[i, j]),
                        torch.from_numpy(pg.block_ci[i, j]),
                        torch.from_numpy(pg.block_val[i, j]))
    planes = [blk(c["z"], c["x"]), blk(c["y"], c["z"]), blk(c["x"], c["y"])]
    n_loc, b = N // G, B // G
    feats = torch.arange(N, dtype=torch.float32)[:, None]
    labels = torch.arange(N, dtype=torch.int32)
    x_rows = slice(c["x"] * n_loc, (c["x"] + 1) * n_loc)
    mb = tmb.MinibatchBuilder(cfg).build_local(
        planes, feats[x_rows], labels[x_rows], 0, 3, c, ids=ids)
    for (i, j), got in zip(((c["z"], c["x"]), (c["y"], c["z"]),
                            (c["x"], c["y"])), mb.adj):
        assert torch.equal(got, one.adj[i * b:(i + 1) * b,
                                        j * b:(j + 1) * b])
    pairs = [(c["z"], c["x"]), (c["y"], c["z"]), (c["x"], c["y"])]
    for p in range(3):
        for q in range(3):
            assert (mb.adj[p] is mb.adj[q]) == (pairs[p] == pairs[q])
    assert torch.equal(mb.feats[:, 0], ids[c["x"]].float())
    assert torch.equal(mb.labels, ids[c["x"]])
