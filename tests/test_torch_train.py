"""The port's training slice as a whole, against the JAX package: one
training step through ``fourd.make_train_step`` on a 1x1x1 plan (block-ELL
SpMM, fused tail, fused extraction) against the reference's on a 1x1x1
mesh with the reference's own sample injected; dropout through the model
with the reference's masks injected; and the port's ``Trainer`` resuming
bit for bit on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as jopt  # noqa: E402
from repro.core import fourd as jfourd  # noqa: E402
from repro.core import gcn_model as JM  # noqa: E402
from repro.graphs import build_partitioned_graph as jbuild  # noqa: E402
from repro.graphs import make_synthetic_dataset  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.core import fourd as tfourd  # noqa: E402
from repro_torch.core import gcn_model as TM  # noqa: E402
from repro_torch.core.forward import TrainOptions  # noqa: E402
from repro_torch.graphs import build_partitioned_graph as tbuild  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.train import Trainer, TrainLoopConfig  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

D_IN, D_H, LAYERS, CLASSES, BATCH, TILE = 16, 32, 3, 4, 64, 16


@pytest.fixture(scope="module")
def data():
    ds = make_synthetic_dataset(n=256, num_classes=CLASSES, d_in=D_IN,
                                avg_degree=8, seed=0)
    jcfg = JM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=LAYERS,
                        num_classes=CLASSES, dropout=0.0)
    jparams = JM.init_params(jax.random.PRNGKey(1), jcfg)
    for i, layer in enumerate(jparams["layers"]):
        layer["rms_scale"] = layer["rms_scale"] * (1.0 + 0.1 * i)
    return ds, jcfg, jax.tree.map(np.asarray, jparams)


def _tcfg(jcfg):
    return TM.GCNConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(jcfg)
                           if f.name not in ("elementwise_impl",
                                             "spmm_impl")})


def _tplan(ds, jcfg, **opts):
    kw = dict(spmm_impl="ell", fused_elementwise=True, extract_impl="cuda",
              ell_tile=TILE, ell_slots=BATCH // TILE)
    kw.update(opts)
    return tfourd.build_plan(tbuild(ds, g=1), _tcfg(jcfg),
                             tfourd.make_mesh_4d(1, 1, "cpu"), batch=BATCH,
                             opts=TrainOptions(**kw))


def test_train_step_matches_reference_1x1x1(data):
    """Loss within rtol 1e-5, grads within atol 1e-5 (f32 GEMMs summed in
    other orders), over two steps, with the reference's sample injected."""
    ds, jcfg, np_params = data
    jopts = jfourd.TrainOptions(spmm_impl="ell", fused_elementwise=True,
                                extract_impl="pallas", dropout=0.0,
                                ell_tile=TILE, ell_slots=BATCH // TILE)
    jplan = jfourd.build_plan(jbuild(ds, g=1), jcfg,
                              jfourd.make_mesh_4d(1, 1), batch=BATCH,
                              opts=jopts)
    jgraph = jplan.shard_graph(jbuild(ds, g=1))
    jloss = jfourd.make_loss_fn(jplan)
    jvg = jax.jit(jax.value_and_grad(
        lambda p, step: jloss(p, jgraph, step).mean()))
    jstep = jfourd.make_train_step(jplan, jopt.Sgd(lr=1.0))
    tplan = _tplan(ds, jcfg)
    tgraph = tplan.shard_graph(tbuild(ds, g=1))
    tloss = tfourd.make_loss_fn(tplan)
    tstep = tfourd.make_train_step(tplan, topt.Sgd(lr=1.0))

    jp = jplan.shard_params(jax.tree.map(jnp.asarray, np_params))
    tp = TM.params_from_numpy(np_params, device="cpu")
    jo, to = jopt.Sgd(lr=1.0).init(jp), topt.Sgd(lr=1.0).init(tp)
    for step in range(2):
        ids = torch.from_numpy(np.array(jplan.builder.sample_ids(step, None,
                                                                 0)))
        jl, jg = jvg(jp, jnp.asarray(step))
        tl, tg = tfourd.value_and_grad(tloss, tp, tgraph, step, ids=ids)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for a, b in zip(leaves(tg), jax.tree.leaves(jg)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        jp, jo, jl2 = jstep(jp, jo, jgraph, jnp.asarray(step))
        tp, to, tl2 = tstep(tp, to, tgraph, step, ids=ids)
        np.testing.assert_allclose(float(tl2), float(jl2), rtol=1e-5)
        for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=1e-5)


def test_dropout_through_the_ell_model_matches_reference(data):
    """The reference's ``jax.random.bernoulli`` masks injected into the
    port's model (ELL SpMM, fused tail): logits and grads within 1e-5."""
    ds, jcfg, np_params = data
    rng = np.random.default_rng(3)
    adj = (rng.random((BATCH, BATCH)) < 0.1) * rng.random((BATCH, BATCH))
    adj = adj.astype(np.float32)
    x = rng.normal(size=(BATCH, D_IN)).astype(np.float32)
    labels = rng.integers(-1, CLASSES, BATCH).astype(np.int32)
    from repro.kernels import ops as jops
    tiles, colidx = jops.dense_to_block_ell(jnp.asarray(adj), TILE, TILE,
                                            BATCH // TILE)
    cfg = dataclasses.replace(jcfg, dropout=0.3, spmm_impl="ell",
                              elementwise_impl="pallas")
    key = jax.random.PRNGKey(5)

    def jloss(p):
        logits = JM.forward(p, (tiles, colidx), jnp.asarray(x), cfg,
                            dropout_key=key, train=True)
        return JM.cross_entropy_loss(logits, jnp.asarray(labels))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, np_params))
    masks = [torch.from_numpy(np.array(jax.random.bernoulli(
        k, 0.7, (BATCH, D_H)))) for k in jax.random.split(key, LAYERS)]
    tcfg = dataclasses.replace(_tcfg(jcfg), dropout=0.3, spmm_impl="ell",
                               elementwise_impl="cuda")
    tp = TM.params_from_numpy(np_params, device="cpu")
    for t in leaves(tp):
        t.requires_grad_(True)
    tadj = (torch.from_numpy(np.array(tiles)),
            torch.from_numpy(np.array(colidx)))
    tl = TM.cross_entropy_loss(
        TM.forward(tp, tadj, torch.from_numpy(x), tcfg, train=True,
                   keep_masks=masks), torch.from_numpy(labels))
    tg = torch.autograd.grad(tl, leaves(tp))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for a, b in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _trainer(plan, steps, ckpt_dir=None):
    opt = topt.AdamW(lr=topt.linear_warmup_cosine(5e-3, 2, 6),
                     weight_decay=1e-4, grad_clip=1.0)
    loop = TrainLoopConfig(total_steps=steps, chunk_size=2,
                           ckpt_dir=ckpt_dir, ckpt_every=2)
    return Trainer(plan, opt, loop, eval_fn=lambda p, g: 0.0)


def test_trainer_resume_is_bit_identical_on_cpu(data, tmp_path):
    """6 steps straight == 3 steps, a save, a restore and 3 more: losses
    and params bit for bit (dropout on, so the masks' generators are
    exercised too)."""
    ds, jcfg, np_params = data
    plan = _tplan(ds, jcfg, dropout=0.3, seed=4)
    graph = plan.shard_graph(tbuild(ds, g=1))
    fresh = lambda: TM.params_from_numpy(np_params, device="cpu")
    tr = _trainer(plan, 6)
    full, log_full = tr.run(tr.init_state(fresh()), graph)
    part = _trainer(plan, 3, str(tmp_path))
    st, log_a = part.run(part.init_state(fresh()), graph)
    assert log_a.final_ckpt.endswith("state_00000003.npz")
    assert (tmp_path / "state_00000002.npz").exists()     # the async save
    rest = _trainer(plan, 6, str(tmp_path))
    restored = rest.restore(rest.init_state(fresh()))
    assert int(restored.step) == 3 and restored.step.dtype == torch.int32
    st, log_b = rest.run(restored, graph)
    assert log_a.losses + log_b.losses == log_full.losses
    assert len(log_full.losses) == 6 and log_full.ms_per_step > 0
    for a, b in zip(leaves(st), leaves(full)):
        assert torch.equal(a, b)
    assert np.mean(log_full.losses[-2:]) < np.mean(log_full.losses[:2])


def test_restore_backfills_a_missing_epoch(data, tmp_path):
    """A checkpoint without the ``.epoch`` leaf (the reference's layout
    before its epoch counter) restores with the epoch its step falls in."""
    ds, jcfg, np_params = data
    plan = _tplan(ds, jcfg)
    tr = _trainer(plan, 4, str(tmp_path))
    state = tr.init_state(TM.params_from_numpy(np_params, device="cpu"))
    state.step = torch.tensor(9, dtype=torch.int32)
    path = tr.save(state)
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files if k != ".epoch"}
    np.savez(path, **arrays)
    got = tr.restore(tr.init_state(TM.params_from_numpy(np_params,
                                                        device="cpu")))
    assert int(got.step) == 9 and plan.scfg.steps_per_epoch == 4
    assert int(got.epoch) == 2 and got.epoch.dtype == torch.int32


def test_trainer_eval_cadence_and_target_stop(data):
    ds, jcfg, np_params = data
    plan = _tplan(ds, jcfg, fused_elementwise=False, extract_impl="torch")
    graph = plan.shard_graph(tbuild(ds, g=1))
    calls = []
    accs = iter([0.1, 0.2, 0.95, 0.99])

    def eval_fn(p, g):
        calls.append(1)
        return next(accs)

    tr = Trainer(plan, topt.Sgd(lr=0.1),
                 TrainLoopConfig(total_steps=20, chunk_size=3, eval_every=2,
                                 target_acc=0.9), eval_fn=eval_fn)
    reports = []
    st, log = tr.run(tr.init_state(TM.params_from_numpy(np_params,
                                                        device="cpu")),
                     graph, report=lambda s, loss, a: reports.append(s))
    assert [s for s, _ in log.evals] == [3, 6, 9] == reports
    assert log.hit_target and int(st.step) == 9 and len(calls) == 3
    acc = float(tfourd.make_eval_step(plan)(st.params, graph))
    assert 0.0 <= acc <= 1.0


def test_unported_options_raise(data):
    """Options not ported raise, naming their ROADMAP item by its title; a
    mesh of more than one rank needs a process group (the mesh itself runs
    in ``test_torch_fourd_dist.py``), and reshard_impl="permute" is
    ported."""
    ds, jcfg, _ = data
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 8"):
        tfourd.make_mesh_4d(1, 2, "cpu")
    comm = "Ring overlap and compressed collectives"
    for kw, item in ((dict(compress="int8"), comm),
                     (dict(overlap_impl="ring"), comm),
                     (dict(bf16_collectives=True), comm),
                     (dict(sample_kind="walk"),
                      "Locality sampling modes and ingestion"),
                     (dict(block_dtype="bf16"), "bf16")):
        with pytest.raises(NotImplementedError, match=item):
            TrainOptions(**kw)
    assert TrainOptions(reshard_impl="permute").reshard_impl == "permute"
    with pytest.raises(NotImplementedError, match="§V-A prefetch"):
        Trainer(_tplan(ds, jcfg), topt.Sgd(),
                TrainLoopConfig(total_steps=1, prefetch=True))


def test_train_cli_rehearses_on_cpu(tmp_path, capsys):
    argv = lambda steps: [
        "--device", "cpu", "--vertices", "512", "--batch", "64",
        "--d-hidden", "32", "--steps", str(steps), "--eval-every", "2",
        "--fused-elementwise", "--ckpt-dir", str(tmp_path),
        "--metrics-json", str(tmp_path / "m.json")]
    tlaunch.main(argv(4))
    out = capsys.readouterr().out
    assert "full-graph accuracy" in out and "state_00000004.npz" in out
    tlaunch.main(argv(6) + ["--resume"])
    assert "resumed: step 4" in capsys.readouterr().out
    # a mesh of 8 ranks runs under torchrun (test_torch_fourd_dist.py)
    with pytest.raises(ValueError, match="torchrun"):
        tlaunch.main(["--device", "cpu", "--g", "2"])
