"""The port's 4D training step on a mesh of gloo ranks against the
reference's on forced host devices.

The reference runs once, in one subprocess with 8 forced CPU devices, on
(G_d, g) = (2, 1) and (1, 2) meshes (and (1, 2) with an odd class count,
which pads the output head): the ``ell`` backend, the fused tail, dropout
0. It writes its sampled ids, per-group losses, gradients (global, and
each device's shard), the params after one AdamW step clipped at 1.0, and
the full-graph accuracy after it. The port then runs each mesh once, one
process per rank over gloo (rank r at the row-major (d, x, y, z)
coordinates, the reference's device r), with the reference's ids
injected, and writes the same. Each test reads those runs; none is held
against the reference's ring path or its XLA collective counts.

Limits, the g = 1 slice's: losses within 1e-5 relative; every gradient
leaf and every parameter after the AdamW step within 1e-4 of the leaf's
largest |value| (f32 sums in other orders); the accuracy equal; a resumed
``Trainer`` run bit for bit. This file imports no JAX: the reference runs
in its subprocess. Run as a script, it is one rank of the port::

    python tests/test_torch_fourd_dist.py REF.npz OUT_DIR GD G
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D_IN, D_H, LAYERS, BATCH, TILE = 512, 16, 32, 3, 128, 16
MESHES = [(2, 1), (1, 2)]
ODD_CLASSES = 5             # the extra (1, 2) case: a padded output head
RANK_TIMEOUT_S = 240


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("XLA_FLAGS", None)
    return env


# ---------------------------------------------------------------------------
# The reference, on 8 forced host devices
# ---------------------------------------------------------------------------

REFERENCE = textwrap.dedent("""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro import optim as O
from repro.core import fourd, gcn_model as M
from repro.graphs import make_synthetic_dataset, build_partitioned_graph

N, D_IN, D_H, LAYERS, BATCH, TILE = {consts}
out_dir = sys.argv[1]


def run(gd, g, classes, name):
    ds = make_synthetic_dataset(n=N, num_classes=classes, d_in=D_IN,
                                avg_degree=8, seed=0)
    pg = build_partitioned_graph(ds, g=g)
    cfg = M.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=LAYERS,
                      num_classes=classes, dropout=0.0)
    opts = fourd.TrainOptions(spmm_impl="ell", fused_elementwise=True,
                              ell_tile=TILE, ell_slots=BATCH // g // TILE)
    plan = fourd.build_plan(pg, cfg, fourd.make_mesh_4d(gd, g), batch=BATCH,
                            opts=opts)
    p0 = M.init_params(jax.random.PRNGKey(1), cfg)
    padded, _ = fourd.pad_output_head(p0, classes, g)
    params = plan.shard_params(padded)
    graph = plan.shard_graph(pg)
    loss_fn = fourd.make_loss_fn(plan)
    mean = lambda p: loss_fn(p, graph, jnp.asarray(0)).mean()
    out = {{"ids": np.stack([np.asarray(plan.builder.sample_ids(0, None, d))
                            for d in range(gd)]),
           "losses": np.asarray(jax.jit(lambda p: loss_fn(
               p, graph, jnp.asarray(0)))(params))}}
    grads = jax.jit(jax.grad(mean))(params)
    opt = O.AdamW(lr=1e-2, weight_decay=1e-4, grad_clip=1.0)
    p1, _, _ = fourd.make_train_step(plan, opt)(params, opt.init(params),
                                                graph, jnp.asarray(0))
    out["acc"] = np.asarray(fourd.make_eval_step(plan)(p1, graph))
    for k, (a, gr, b) in enumerate(zip(jax.tree.leaves(p0),
                                       jax.tree.leaves(grads),
                                       jax.tree.leaves(p1))):
        out[f"p0_{{k}}"] = np.asarray(a)
        out[f"grad_{{k}}"] = np.asarray(gr)
        out[f"p1_{{k}}"] = np.asarray(b)
        for sh in gr.addressable_shards:
            out[f"grad_{{k}}_rank{{sh.device.id}}"] = np.asarray(sh.data)
    np.savez(f"{{out_dir}}/{{name}}.npz", **out)


for gd, g in {meshes}:
    run(gd, g, 4, f"ref_{{gd}}x{{g}}")
run(1, 2, {odd}, "ref_1x2_odd")
print("PASS")
""").format(consts=(N, D_IN, D_H, LAYERS, BATCH, TILE), meshes=MESHES,
            odd=ODD_CLASSES)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    env = dict(_env(), XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(d)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "PASS" in r.stdout, (
        f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-4000:]}")
    return d


# ---------------------------------------------------------------------------
# The port, one process per rank
# ---------------------------------------------------------------------------

def _spawn(gd, g, ref_dir, out_dir):
    """Run the ranks of a (gd, g) mesh of this file's worker; every rank
    must exit 0 within RANK_TIMEOUT_S, or all are killed and the test
    fails with their output."""
    world = gd * g ** 3
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for rank in range(world):
        env = dict(_env(), RANK=str(rank), WORLD_SIZE=str(world),
                   STORE=os.path.join(out_dir, "store"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(ref_dir),
             str(out_dir), str(gd), str(g)], env=env,
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
def runs(ref_dir, tmp_path_factory):
    """The port's run of each mesh: {(gd, g): out_dir}. The (1, 2) run
    also resumes a checkpoint of one device written here first."""
    out = {}
    for gd, g in MESHES:
        d = tmp_path_factory.mktemp(f"port_{gd}x{g}")
        if (gd, g) == (1, 2):
            _one_device_checkpoint(str(d / "from_one"))
        _spawn(gd, g, ref_dir, str(d))
        out[(gd, g)] = d
    return out


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _close(got, want, tol):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    return err <= tol * max(np.abs(want).max(), 1e-30), err


@pytest.mark.parametrize("mesh", MESHES)
def test_per_group_losses_match_reference(ref_dir, runs, mesh):
    ref = _load(ref_dir / f"ref_{mesh[0]}x{mesh[1]}.npz")
    got = _load(runs[mesh] / "rank0.npz")
    assert got["losses"].shape == (mesh[0],)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], ref["losses"].mean(), rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_gradients_match_reference_shard_by_shard(ref_dir, runs, mesh):
    """Rank r's gradient shards against the reference's device r's, and
    the unsharded leaves against the reference's global arrays."""
    ref = _load(ref_dir / f"ref_{mesh[0]}x{mesh[1]}.npz")
    n_leaves = sum(k.startswith("p0_") for k in ref)
    for r in range(mesh[0] * mesh[1] ** 3):
        got = _load(runs[mesh] / f"rank{r}.npz")
        for k in range(n_leaves):
            want = ref[f"grad_{k}"]
            ok, err = _close(got[f"grad_{k}"], ref[f"grad_{k}_rank{r}"], 1e-4)
            assert ok, (r, k, err)
            if r == 0:
                ok, err = _close(got[f"full_grad_{k}"], want, 1e-4)
                assert ok, (k, err)


@pytest.mark.parametrize("mesh", MESHES)
def test_adamw_step_with_clipping_matches_reference(ref_dir, runs, mesh):
    ref = _load(ref_dir / f"ref_{mesh[0]}x{mesh[1]}.npz")
    got = _load(runs[mesh] / "rank0.npz")
    for k in range(sum(key.startswith("p0_") for key in ref)):
        ok, err = _close(got[f"p1_{k}"], ref[f"p1_{k}"], 1e-4)
        assert ok, (k, err)


@pytest.mark.parametrize("mesh", MESHES)
def test_full_graph_accuracy_equals_reference(ref_dir, runs, mesh):
    ref = _load(ref_dir / f"ref_{mesh[0]}x{mesh[1]}.npz")
    got = _load(runs[mesh] / "rank0.npz")
    assert float(got["acc"]) == float(ref["acc"])


def test_odd_class_count_pads_the_head_1x2(ref_dir, runs):
    """5 classes on g = 2: the head shards padded to 6 columns; losses and
    the (unpadded) gradients match the reference's, which is handed the
    padded params."""
    ref = _load(ref_dir / "ref_1x2_odd.npz")
    got = _load(runs[(1, 2)] / "rank0.npz")
    np.testing.assert_allclose(got["odd_losses"], ref["losses"], rtol=1e-5)
    w_out = 2 * LAYERS + 1                  # the last leaf
    assert ref[f"grad_{w_out}"].shape == (D_H, ODD_CLASSES + 1)
    assert got[f"odd_full_grad_{w_out}"].shape == (D_H, ODD_CLASSES)
    for k in range(w_out + 1):
        want = ref[f"grad_{k}"]
        want = want[:, :ODD_CLASSES] if k == w_out else want
        ok, err = _close(got[f"odd_full_grad_{k}"], want, 1e-4)
        assert ok, (k, err)
        ok, err = _close(got[f"odd_grad_{k}"], ref[f"grad_{k}_rank0"], 1e-4)
        assert ok, (k, err)


def test_trainer_resumes_bit_identically_on_the_1x2_mesh(runs):
    """4 steps straight == 2 steps, a checkpoint, a restore and 2 more, on
    every rank: losses and each rank's state shards bit for bit (dropout
    on, so every block's mask key is exercised)."""
    for r in range(8):
        got = _load(runs[(1, 2)] / f"rank{r}.npz")
        assert got["resume_losses_equal"] and got["resume_state_equal"], r
        assert got["resume_loss_fell"]


def test_checkpoints_move_between_one_device_and_the_mesh(runs):
    """A checkpoint written on one device restores on the 1x2 mesh (each
    rank holds its slices of it), and the mesh's own checkpoint, written
    unsharded by rank 0, restores on one device."""
    from repro_torch.tree import leaves
    d = runs[(1, 2)]
    for r in range(8):
        assert _load(d / f"rank{r}.npz")["from_one_equal"], r
    tr, st = _one_device_trainer(str(d / "ckpt"))
    restored = tr.restore(st)
    got = _load(d / "rank0.npz")
    assert int(restored.step) == 4 and tr.plan.mesh.size == 1
    for k, t in enumerate(leaves(restored.params)):
        assert np.array_equal(t.numpy(), got[f"resumed_full_{k}"]), k


def test_train_cli_runs_under_torchrun_at_g2(tmp_path):
    """The CLI's rehearsal on 8 gloo ranks (``torchrun --standalone``):
    trains, evaluates, writes one unsharded checkpoint and resumes it; then
    resumes that checkpoint with the ring, the int8 wire and prefetch on
    (the warm-up batch rebuilt, zero EF accumulators backfilled)."""
    def cli(steps, *extra):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "8", "-m", "repro_torch.launch.train",
               "--device", "cpu", "--g", "2", "--vertices", "512",
               "--batch", "64", "--d-hidden", "32", "--steps", str(steps),
               "--eval-every", "2", "--fused-elementwise", "--ckpt-dir",
               str(tmp_path), *extra]
        r = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                           timeout=RANK_TIMEOUT_S)
        assert r.returncode == 0, f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
        return r.stdout
    out = cli(2)
    assert "full-graph accuracy" in out and "state_00000002.npz" in out
    assert out.count("done: steps") == 1           # rank 0 reports
    assert "resumed: step 2" in cli(4, "--resume")
    out = cli(6, "--resume", "--overlap", "ring", "--compress", "int8",
              "--prefetch")
    assert "resumed: step 4" in out and "state_00000006.npz" in out


# ---------------------------------------------------------------------------
# One device, and the rank worker
# ---------------------------------------------------------------------------

def _dataset(classes=4):
    from repro_torch.graphs import make_synthetic_dataset
    return make_synthetic_dataset(n=N, num_classes=classes, d_in=D_IN,
                                  avg_degree=8, seed=0)


def _plan(mesh, g, classes=4, **opts):
    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as TM
    from repro_torch.graphs import build_partitioned_graph
    kw = dict(spmm_impl="ell", fused_elementwise=True, extract_impl="cuda",
              ell_tile=TILE, ell_slots=BATCH // g // TILE)
    kw.update(opts)
    pg = build_partitioned_graph(_dataset(classes), g=g)
    cfg = TM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=LAYERS,
                       num_classes=classes)
    plan = fourd.build_plan(pg, cfg, mesh, batch=BATCH,
                            opts=fourd.TrainOptions(**kw))
    return plan, plan.shard_graph(pg)


def _resume_trainer(plan, steps, ckpt_dir):
    from repro_torch import optim as topt
    from repro_torch.train import Trainer, TrainLoopConfig
    opt = topt.AdamW(lr=topt.linear_warmup_cosine(1e-2, 1, 4),
                     weight_decay=1e-4, grad_clip=1.0)
    return Trainer(plan, opt, TrainLoopConfig(
        total_steps=steps, chunk_size=2, ckpt_dir=ckpt_dir, ckpt_every=2),
        eval_fn=lambda p, g: 0.0)


def _init_params(cfg):
    from repro_torch.core import gcn_model as TM
    return TM.init_params(cfg, torch.Generator().manual_seed(3),
                          device="cpu")


def _one_device_trainer(ckpt_dir):
    from repro_torch.core import fourd
    plan, _ = _plan(fourd.make_mesh_4d(1, 1, "cpu"), 1, dropout=0.3, seed=4)
    tr = _resume_trainer(plan, 4, ckpt_dir)
    return tr, tr.init_state(plan.shard_params(_init_params(plan.cfg)))


def _one_device_checkpoint(ckpt_dir):
    """Two steps on one device, saved (the mesh restores it)."""
    from repro_torch.core import fourd
    plan, graph = _plan(fourd.make_mesh_4d(1, 1, "cpu"), 1, dropout=0.3,
                        seed=4)
    tr = _resume_trainer(plan, 2, ckpt_dir)
    tr.run(tr.init_state(plan.shard_params(_init_params(plan.cfg))), graph)


def _worker(ref_dir, out_dir, gd, g):
    """One rank: the parity run of its mesh, then (on the 1x2 mesh) the
    odd class count, the resume and the checkpoint moves."""
    import datetime

    import torch.distributed as dist

    from repro_torch import optim as topt
    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as TM
    from repro_torch.tree import leaves

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.environ["STORE"], world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    mesh = fourd.make_mesh_4d(gd, g, "cpu")
    assert mesh.rank == rank
    out = {}

    def parity(classes, ref_name, prefix):
        ref = _load(os.path.join(ref_dir, ref_name))
        plan, graph = _plan(mesh, g, classes)
        # the reference's leaf order: layers (rms_scale, w), w_in, w_out
        tree = {"w_in": ref[f"p0_{2 * LAYERS}"],
                "w_out": ref[f"p0_{2 * LAYERS + 1}"],
                "layers": [{"rms_scale": ref[f"p0_{2 * i}"],
                            "w": ref[f"p0_{2 * i + 1}"]}
                           for i in range(LAYERS)]}
        fresh = lambda: plan.shard_params(TM.params_from_numpy(
            tree, device="cpu"))
        ids = torch.from_numpy(ref["ids"][mesh.coords["d"]])
        loss_fn = fourd.make_loss_fn(plan)
        out[prefix + "losses"] = loss_fn(fresh(), graph, 0, ids=ids).numpy()
        loss, grads = fourd.value_and_grad(loss_fn, fresh(), graph, 0,
                                           ids=ids)
        out[prefix + "loss"] = loss.numpy()
        full = plan.unshard(grads)
        for k, (a, b) in enumerate(zip(leaves(grads), leaves(full))):
            out[f"{prefix}grad_{k}"] = a.numpy()
            out[f"{prefix}full_grad_{k}"] = b.numpy()
        if prefix:
            return
        opt = topt.AdamW(lr=1e-2, weight_decay=1e-4, grad_clip=1.0)
        params = fresh()
        params, _, _ = fourd.make_train_step(plan, opt)(
            params, opt.init(params), graph, 0, ids=ids)
        for k, t in enumerate(leaves(plan.unshard(params))):
            out[f"p1_{k}"] = t.detach().numpy()
        out["acc"] = np.asarray(float(fourd.make_eval_step(plan)(params,
                                                                 graph)))

    parity(4, f"ref_{gd}x{g}.npz", "")
    if (gd, g) == (1, 2):
        parity(ODD_CLASSES, "ref_1x2_odd.npz", "odd_")
        resume(mesh, out, out_dir, g)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def resume(mesh, out, out_dir, g):
    from repro_torch.tree import leaves
    plan, graph = _plan(mesh, g, dropout=0.3, seed=4)
    fresh = lambda: plan.shard_params(_init_params(plan.cfg))
    ckpt = os.path.join(out_dir, "ckpt")
    tr = _resume_trainer(plan, 4, None)
    full, log_full = tr.run(tr.init_state(fresh()), graph)
    part = _resume_trainer(plan, 2, ckpt)
    _, log_a = part.run(part.init_state(fresh()), graph)
    rest = _resume_trainer(plan, 4, ckpt)
    st, log_b = rest.run(rest.restore(rest.init_state(fresh())), graph)
    out["resume_losses_equal"] = log_a.losses + log_b.losses == \
        log_full.losses
    out["resume_state_equal"] = all(torch.equal(a, b) for a, b in
                                    zip(leaves(st), leaves(full)))
    out["resume_loss_fell"] = log_full.losses[-1] < log_full.losses[0]
    for k, t in enumerate(leaves(plan.unshard(st.params))):
        out[f"resumed_full_{k}"] = t.detach().numpy()
    # a checkpoint of one device, restored here: this rank's slices of it
    one = _resume_trainer(plan, 4, os.path.join(out_dir, "from_one"))
    got = one.restore(one.init_state(fresh()))
    want = plan.shard(_load_state_params(os.path.join(out_dir, "from_one")))
    out["from_one_equal"] = int(got.step) == 2 and all(
        torch.equal(a, b) for a, b in zip(leaves(got.params), leaves(want)))


def _load_state_params(directory):
    """The params of the newest ``state`` checkpoint, as global tensors."""
    from repro_torch.checkpoint import latest_step
    step = latest_step(directory, name="state")
    with np.load(os.path.join(directory, f"state_{step:08d}.npz")) as f:
        p = {k[len(".params::"):]: torch.from_numpy(f[k]) for k in f.files
             if k.startswith(".params::")}
    return {"w_in": p["w_in"], "w_out": p["w_out"],
            "layers": [{"rms_scale": p[f"layers::{i}::rms_scale"],
                        "w": p[f"layers::{i}::w"]} for i in range(LAYERS)]}


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
