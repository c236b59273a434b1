"""The port's LLM production mesh on the CPU: ``models/sharding.py``,
``data.shard_batch_for_mesh``, the query-offset attention and the sharded
dense step (``models/sharded.py``) against the JAX package.

* Specs: ``param_pspecs`` (FSDP off and on), ``cache_pspecs`` (batch 128
  and 1) and ``batch_pspec`` (a batch that divides and one that does not)
  equal the reference's on ``AbstractMesh((16, 16), ("data", "model"))``
  and ``AbstractMesh((2, 16, 16), ("pod", "data", "model"))``, leaf for
  leaf, at all ten configs, on the port's ``param_tree`` of
  ``abstract_params``.
* Attention with a query offset: ``blockwise_attention(q_offset=o)`` (the
  kernels' plain versions on the CPU) and its ``torch.autograd.grad``
  against the reference's and ``jax.vjp`` (GQA 4/2, hd 64, T 128, Sq 64
  and 40, offsets 0, 24, 64 and 88, causal, windows None and 32), and the
  q-chunked path under ``set_q_chunk(32)`` at S 128; 1e-5 of the largest
  |.| in float32.
* The sharded step, in gloo ranks at meshes (1, 2) ``("data", "model")``
  and (2, 1, 2) ``("pod", "data", "model")`` with FSDP: tinyllama's and
  qwen2's smoke models (qwen2 for its QKV biases and tied embeddings),
  batch 4 x 32, ``remat``: each rank's loss (1e-5 relative) and
  ``unshard``ed gradients (1e-4 of each leaf's largest |.|) against the
  reference's single-device ``jax.value_and_grad``, one AdamW step's
  params the same way, and ``prefill`` + two ``decode_step``s on the
  sharded cache within 1e-5 of the largest |logit|. The reference runs
  once, in this process; the ranks are this file run as a script, one
  process each, over a ``FileStore``::

      python tests/test_torch_sharding.py REF_DIR OUT_DIR SHAPE AXES

* ``shard_batch_for_mesh``: the rows of every coordinate concatenate to
  the batch bit for bit; a batch that does not divide raises.
* A miniature LLM dry run (tinyllama's smoke config on a (2, 4) fake mesh,
  on the meta device, in a subprocess): train, prefill and decode are
  ``ok``, the argument bytes are this rank's blocks and inputs, the
  collective kinds are the expected ones, and a non-dense arch is an
  ``error`` naming its ROADMAP title.
"""
import functools
import itertools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["tinyllama-1.1b", "qwen2-0.5b"]
MESHES = [((1, 2), ("data", "model")), ((2, 1, 2), ("pod", "data", "model"))]
BATCH, SEQ, MAX_LEN = 4, 32, 40
RANK_TIMEOUT_S = 240
LOSS_RTOL, GRAD_RTOL, LOGIT_RTOL = 1e-5, 1e-4, 1e-5


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict (leaves: anything else)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {"::".join(prefix): tree}


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        keys = path.split("::")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


# ---------------------------------------------------------------------------
# Specs against the reference's, on its AbstractMesh
# ---------------------------------------------------------------------------

def _ref_flat(spec_tree):
    import jax
    from jax.sharding import PartitionSpec
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {"::".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): tuple(sp) for path, sp in flat}


@pytest.mark.parametrize("arch", [
    "whisper-base", "qwen2-0.5b", "llama4-scout-17b-a16e",
    "llama-3.2-vision-90b", "mixtral-8x7b", "command-r-plus-104b",
    "zamba2-2.7b", "tinyllama-1.1b", "internlm2-1.8b", "mamba2-780m"])
def test_specs_equal_the_reference(arch):
    import jax
    from jax.sharding import AbstractMesh

    from repro import configs as jconfigs
    from repro.models import sharding as SH
    from repro.models import transformer as JT
    from repro_torch import configs as tconfigs
    from repro_torch.models import sharding as TS
    from repro_torch.models import transformer as TT

    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jparams = JT.abstract_params(jcfg)
    tparams = TT.param_tree(TT.abstract_params(tcfg))
    for mesh in (AbstractMesh((16, 16), ("data", "model")),
                 AbstractMesh((2, 16, 16), ("pod", "data", "model"))):
        for fsdp in (False, True):
            want = _ref_flat(SH.param_pspecs(jcfg, mesh, jparams, fsdp))
            got = _flat(TS.param_pspecs(tcfg, mesh, tparams, fsdp))
            assert {k: tuple(v) for k, v in got.items()} == want, \
                (mesh.axis_names, fsdp)
            assert all(isinstance(v, TS.P) for v in got.values())
        for batch in (128, 1):
            jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, batch, 64))
            tcache = TT.init_cache(tcfg, batch, 64, "meta")
            want = _ref_flat(SH.cache_pspecs(jcfg, mesh, jcache, batch))
            got = _flat(TS.cache_pspecs(tcfg, mesh, tcache, batch))
            assert {k: tuple(v) for k, v in got.items()} == want, batch
        for batch, extra in itertools.product((256, 3, 32), (1, 2)):
            assert tuple(TS.batch_pspec(mesh, batch, extra)) == \
                tuple(SH.batch_pspec(mesh, batch, extra))


# ---------------------------------------------------------------------------
# Attention with a query offset, and the q-chunked path
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_attention_vjp(window, q_offset):
    import jax

    from repro.models import layers as JL

    @jax.jit
    def run(q, k, v, dout):
        f = lambda q, k, v: JL.blockwise_attention(
            q, k, v, causal=True, window=window, q_offset=q_offset)
        out, vjp = jax.vjp(f, q, k, v)
        return (out,) + vjp(dout)
    return run


def _attention_case(sq, t, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return mk(2, sq, 4, 64), mk(2, t, 2, 64), mk(2, t, 2, 64), \
        mk(2, sq, 4, 64)


def _port_attention_vjp(q, k, v, dout, **kw):
    from repro_torch.models import layers as TL
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = TL.blockwise_attention(*leaves, causal=True, attn_impl="cuda",
                                 **kw)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    return (out.detach(),) + grads


@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("q_offset", [0, 24, 64, 88])
@pytest.mark.parametrize("sq", [64, 40])
def test_offset_attention_matches_the_reference(sq, q_offset, window):
    q, k, v, dout = _attention_case(sq, 128, seed=sq + q_offset)
    want = _j_attention_vjp(window, q_offset)(q, k, v, dout)
    got = _port_attention_vjp(q, k, v, dout, window=window,
                              q_offset=q_offset)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        assert _rel_err(g.numpy(), w) <= 1e-5, name


def test_q_chunk_matches_the_reference(monkeypatch):
    """``set_q_chunk(32)`` at S 128: the reference's chunks (offsets 0,
    32, 64, 96, each against its KV prefix) through the port's kernels'
    plain versions, the same out and gradients."""
    import jax

    from repro.models import layers as JL
    from repro_torch.kernels import ops
    from repro_torch.models import layers as TL
    q, k, v, dout = _attention_case(128, 128, seed=5)
    calls = []
    real = ops.flash_attention

    def spy(q, k, *a, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("q_offset")))
        return real(q, k, *a, **kw)
    monkeypatch.setattr(TL.ops, "flash_attention", spy)
    JL.set_q_chunk(32)
    TL.set_q_chunk(32)
    try:
        @jax.jit
        def run(q, k, v, dout):
            f = lambda q, k, v: JL.blockwise_attention(q, k, v, causal=True)
            out, vjp = jax.vjp(f, q, k, v)
            return (out,) + vjp(dout)
        want = run(q, k, v, dout)
        got = _port_attention_vjp(q, k, v, dout)
    finally:
        JL.set_q_chunk(None)
        TL.set_q_chunk(None)
    assert calls == [(32, 32, 0), (32, 64, 32), (32, 96, 64), (32, 128, 96)]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel_err(g.numpy(), w) <= 1e-5, name


def test_set_attn_sharding_changes_nothing():
    from repro_torch.models import layers as TL
    q, k, v, dout = _attention_case(40, 128)
    base = _port_attention_vjp(q, k, v, dout, q_offset=24)
    TL.set_attn_sharding((("data", "model", None, None),
                          ("data", None, None, None)))
    try:
        again = _port_attention_vjp(q, k, v, dout, q_offset=24)
    finally:
        TL.set_attn_sharding(None)
    assert all(torch.equal(a, b) for a, b in zip(base, again))


# ---------------------------------------------------------------------------
# shard_batch_for_mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", MESHES + [
    ((2, 2, 2), ("pod", "data", "model")), ((4, 1), ("data", "model"))])
def test_shard_batch_for_mesh_recomposes_bit_for_bit(shape, axes):
    """Every coordinate's rows: ranks that differ only in ``model`` hold
    the same rows, and the DP blocks in (pod, data) order concatenate to
    the batch bit for bit; a batch the DP size does not divide raises."""
    from repro_torch.data import shard_batch_for_mesh
    from repro_torch.models import sharding as TS
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 1000, (8, 5)).astype(np.int32)
    tgts = rng.integers(0, 1000, (8, 5)).astype(np.int32)
    rows = {}
    for coords in itertools.product(*(range(n) for n in shape)):
        mesh = TS.LLMMesh(shape=dict(zip(axes, shape)),
                          coords=dict(zip(axes, coords)),
                          device=torch.device("cpu"))
        tk, tg = shard_batch_for_mesh(mesh, toks, tgts)
        assert tk.dtype == torch.int32 and tk.device.type == "cpu"
        dp = tuple(c for a, c in zip(axes, coords) if a != "model")
        if dp in rows:
            assert torch.equal(rows[dp][0], tk)
        rows[dp] = (tk, tg)
    order = sorted(rows)
    assert np.array_equal(torch.cat([rows[d][0] for d in order]).numpy(),
                          toks)
    assert np.array_equal(torch.cat([rows[d][1] for d in order]).numpy(),
                          tgts)
    n_dp = len(order)
    if n_dp > 1:
        mesh = TS.LLMMesh(shape=dict(zip(axes, shape)),
                          coords=dict.fromkeys(axes, 0),
                          device=torch.device("cpu"))
        with pytest.raises(ValueError, match="does not divide"):
            shard_batch_for_mesh(mesh, toks[:n_dp + 1], tgts[:n_dp + 1])


# ---------------------------------------------------------------------------
# The sharded step in gloo ranks
# ---------------------------------------------------------------------------

def _reference(arch, out_dir):
    """The reference's single-device numbers for ``arch``'s smoke model:
    the weights (qwen2's zero QKV biases made non-zero), the batch, the
    loss and gradients, the params after one AdamW(lr=1e-4) step, and the
    logits of prefill and two decode steps."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.data import TokenStream
    from repro.models import transformer as JT
    from repro.optim import AdamW as JAdamW

    cfg = jconfigs.get_smoke(arch)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    if cfg.qkv_bias:
        attn = params["blocks"]["attn"]
        for i, name in enumerate(("bq", "bk", "bv")):
            attn[name] = 0.1 * jax.random.normal(jax.random.PRNGKey(i + 1),
                                                 attn[name].shape)
    toks, tgts = TokenStream(cfg.vocab, BATCH, SEQ, seed=1).batch_at(0)

    def loss_fn(p):
        logits, aux = JT.forward_train(p, jnp.asarray(toks), cfg)
        return JT.lm_loss(logits, jnp.asarray(tgts), cfg.vocab) \
            + 0.01 * jnp.asarray(aux, jnp.float32)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    opt = JAdamW(lr=1e-4)
    p1, _ = jax.jit(opt.update)(params, grads, opt.init(params))
    steps = np.random.default_rng(2).integers(0, cfg.vocab, (2, BATCH, 1))
    logits, cache = jax.jit(lambda p, t: JT.prefill(p, t, cfg, MAX_LEN))(
        params, jnp.asarray(toks))
    out = {"toks": toks, "tgts": tgts, "loss": np.asarray(loss),
           "steps": steps.astype(np.int32), "logits_0": np.asarray(logits)}
    decode = jax.jit(lambda p, t, c: JT.decode_step(p, t, c, cfg))
    for i in range(2):
        logits, cache = decode(params, jnp.asarray(steps[i], jnp.int32),
                               cache)
        out[f"logits_{i + 1}"] = np.asarray(logits)
    for name, tree in (("p0", params), ("grad", grads), ("p1", p1)):
        for path, leaf in _ref_flat_arrays(tree).items():
            out[f"{name}/{path}"] = np.asarray(leaf, np.float32)
    np.savez(os.path.join(out_dir, f"{arch}.npz"), **out)


def _ref_flat_arrays(tree):
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"::".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    env.pop("XLA_FLAGS", None)
    return env


def _start(shape, axes, ref_dir, out_dir):
    """The ranks of a mesh, this file's worker each, started."""
    world = int(np.prod(shape))
    os.makedirs(out_dir, exist_ok=True)
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(ref_dir),
         str(out_dir), ",".join(map(str, shape)), ",".join(axes)],
        env=dict(_env(), RANK=str(rank), WORLD_SIZE=str(world),
                 STORE=os.path.join(out_dir, "store")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]


def _finish(procs):
    """Every process's output; each must exit 0 within RANK_TIMEOUT_S, or
    all are killed and the test fails with their output."""
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
    assert not bad, "\n".join(f"process {r} exited {rc}:\n{o[-3000:]}"
                              for r, rc, o in bad)
    return outs


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The reference's numbers (in this process, once), then the ranks of
    both meshes and the miniature dry run, all at once: {mesh id: each
    rank's errors, "dryrun": the dry run's records}."""
    ref = tmp_path_factory.mktemp("ref")
    for arch in ARCHS:
        _reference(arch, str(ref))
    runs = {}
    for shape, axes in MESHES:
        name = "x".join(map(str, shape))
        out = str(tmp_path_factory.mktemp(name))
        runs[name] = (out, _start(shape, axes, ref, out))
    dry = subprocess.Popen([sys.executable, "-c", MINI_DRYRUN], env=_env(),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    result = {}
    for name, (out, procs) in runs.items():
        _finish(procs)
        result[name] = [json.load(open(os.path.join(out, f"rank{r}.json")))
                        for r in range(len(procs))]
    stdout = _finish([dry])[0]
    line = [x for x in stdout.splitlines() if x.startswith("RESULT ")]
    assert line, stdout[-3000:]
    result["dryrun"] = json.loads(line[0][len("RESULT "):])
    return result


MESH_IDS = ["1x2", "2x1x2"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESH_IDS)
def test_sharded_loss_and_grads_match_the_reference(launched, mesh, arch):
    for r in launched[mesh]:
        e = r[arch]
        assert e["loss"] <= LOSS_RTOL, (r["rank"], e["loss"])
        assert e["n_grads"] == e["n_ref_leaves"]
        worst = max(e["grads"].items(), key=lambda kv: kv[1])
        assert worst[1] <= GRAD_RTOL, (r["rank"], worst)
        # the same step with each model rank's rows whole
        assert e["loss_replicated"] <= LOSS_RTOL
        assert e["grads_replicated"] <= GRAD_RTOL


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESH_IDS)
def test_sharded_adamw_step_matches_the_reference(launched, mesh, arch):
    for r in launched[mesh]:
        worst = max(r[arch]["p1"].items(), key=lambda kv: kv[1])
        assert worst[1] <= GRAD_RTOL, (r["rank"], worst)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESH_IDS)
def test_sharded_prefill_and_decode_match_the_reference(launched, mesh,
                                                        arch):
    for r in launched[mesh]:
        errs = r[arch]["logits"]
        assert len(errs) == 3 and max(errs) <= LOGIT_RTOL, (r["rank"], errs)


@pytest.mark.parametrize("mesh", MESH_IDS)
def test_sharded_step_sends_the_expected_collectives(launched, mesh):
    """What the ledger saw on each rank: weights gathered, K/V gathered
    over ``model``, the loss all-reduced, gradients reduce-scattered and
    all-reduced; decode's scores or outputs over ``model``."""
    for r in launched[mesh]:
        scopes = r["tinyllama-1.1b"]["scopes"]
        assert {"weights", "kv", "loss", "grads"} <= set(scopes["train"])
        assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(
            r["tinyllama-1.1b"]["kinds"]["train"])
        assert "scores" in scopes["decode"]


def _worker(ref_dir, out_dir, shape, axes):
    """One rank: both smoke models' sharded loss, gradients, AdamW step,
    prefill and decode against the reference's npz; writes the relative
    errors to ``rank{r}.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch import configs as tconfigs
    from repro_torch.data import shard_batch_for_mesh
    from repro_torch.launch.train_transformer import loss_and_grads
    from repro_torch.models import sharded
    from repro_torch.models import sharding as TS
    from repro_torch.models import transformer as TT
    from repro_torch.obs import comm
    from repro_torch.optim import AdamW
    from repro_torch.tree import leaves

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.environ["STORE"], world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    mesh = TS.make_llm_mesh(shape, axes, "cpu")
    dp = TS.batch_pspec(mesh, BATCH)[0]
    seq_par = TS.P(dp, "model", None)
    idx, n_dp = mesh.index(dp)
    rows = slice(idx * BATCH // n_dp, (idx + 1) * BATCH // n_dp)
    result = {"rank": rank}
    for arch in ARCHS:
        cfg = tconfigs.get_smoke(arch)
        with np.load(os.path.join(ref_dir, f"{arch}.npz")) as f:
            ref = {k: f[k] for k in f.files}
        p0 = _nest({k[3:]: v for k, v in ref.items() if k.startswith("p0/")})
        model = sharded.shard_model(
            TT.params_from_numpy(p0, cfg, "cpu", trainable=True), mesh,
            fsdp=True)
        specs = model.mesh_specs
        toks, tgts = shard_batch_for_mesh(mesh, ref["toks"], ref["tgts"])
        errs = {"scopes": {}, "kinds": {}}

        def full(tree):
            return {k: np.stack([t.numpy() for t in v]) if isinstance(
                v, list) else v.numpy()
                for k, v in _flat(TS.unshard(tree, specs, mesh)).items()}

        # prefill and two decode steps on the sharded cache
        with comm.recording() as led:
            with TT.run_options(act_sharding=seq_par):
                logits, cache = TT.prefill(model, toks, cfg, MAX_LEN,
                                           mesh=mesh)
            got = [logits]
            for i in range(2):
                step = torch.from_numpy(ref["steps"][i][rows])
                got.append(TT.decode_step(model, step, cache, cfg,
                                          mesh=mesh)[0])
        errs["scopes"]["decode"] = sorted(
            {op.op_name for op in led.report().sites})
        errs["logits"] = [
            float(np.abs(g.numpy() - ref[f"logits_{i}"][rows]).max()
                  / np.abs(ref[f"logits_{i}"]).max())
            for i, g in enumerate(got)]
        # the loss, the gradients, one AdamW step
        with comm.recording() as led:
            with TT.run_options(act_sharding=seq_par, remat=True):
                loss, grads = loss_and_grads(model, toks, tgts, cfg,
                                             mesh=mesh)
        rep = led.report()
        errs["scopes"]["train"] = sorted(
            {op.op_name.split("/")[-1] for op in rep.sites})
        errs["kinds"]["train"] = sorted(k for k, v in rep.counts.items()
                                        if v)
        errs["loss"] = abs(float(loss) - float(ref["loss"])) \
            / abs(float(ref["loss"]))
        gfull = full(grads)
        want = {k[5:]: v for k, v in ref.items() if k.startswith("grad/")}
        errs["n_grads"], errs["n_ref_leaves"] = len(gfull), len(want)
        errs["grads"] = {k: _rel_err(gfull[k], w) for k, w in want.items()}
        # without the sequence layout every model rank holds whole rows
        loss_r, grads_r = loss_and_grads(model, toks, tgts, cfg, mesh=mesh)
        errs["loss_replicated"] = abs(float(loss_r) - float(ref["loss"])) \
            / abs(float(ref["loss"]))
        grep = full(grads_r)
        errs["grads_replicated"] = max(_rel_err(grep[k], w)
                                       for k, w in want.items())
        tree = TT.param_tree(model)
        opt = AdamW(lr=1e-4)
        opt.update(tree, grads, opt.init(tree))
        pfull = full(tree)
        errs["p1"] = {k[3:]: _rel_err(pfull[k[3:]], v)
                      for k, v in ref.items() if k.startswith("p1/")}
        assert all(t.shape == b.shape for t, b in zip(
            leaves(tree), leaves(TS.shard(TS.unshard(tree, specs, mesh),
                                          specs, mesh))))
        result[arch] = errs
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# A miniature LLM dry run, on the fake backend and the meta device
# ---------------------------------------------------------------------------

MINI_DRYRUN = textwrap.dedent("""
import json
from repro_torch import configs
from repro_torch.configs import InputShape
from repro_torch.launch import dryrun
from repro_torch.models import sharded
from repro_torch.models import sharding as TS
from repro_torch.models import transformer as TT

cfg = configs.get_smoke("tinyllama-1.1b")
out = {}
for kind in ("train", "prefill", "decode"):
    shape = InputShape("mini_" + kind, 64, 8, kind)
    rec = dryrun.run_one("tinyllama-1.1b", shape.name, False, save=False,
                         rank=5, cfg=cfg, mesh_shape=(2, 4), shape=shape)
    out[kind] = {k: rec.get(k) for k in (
        "status", "error", "n_devices", "memory", "flops_per_device",
        "collective_bytes_per_device")}
rec = dryrun.run_one("mamba2-780m", "train_4k", False, save=False,
                     cfg=configs.get_smoke("mamba2-780m"), mesh_shape=(2, 4),
                     shape=InputShape("mini_train", 64, 8, "train"))
out["mamba2"] = {"status": rec["status"], "error": rec.get("error")}
rec = dryrun.run_one("tinyllama-1.1b", "long_500k", True, save=False)
out["long"] = {"status": rec["status"], "reason": rec.get("reason")}

# this rank's blocks, counted from the specs alone: rank 5 of (2, 4)
mesh = TS.LLMMesh(shape={"data": 2, "model": 4},
                  coords={"data": 1, "model": 1}, device=None)
specs = TS.param_pspecs(cfg, mesh, TT.param_tree(TT.abstract_params(cfg)))
def block_bytes(sp, shape):
    n = 1
    for d, e in zip(shape, sp):
        n *= d // mesh.index(e)[1] if e is not None else d
    return 4 * n
full = TT.param_tree(TT.abstract_params(cfg))
def walk(node, sp):
    if isinstance(node, dict):
        return sum(walk(node[k], sp[k]) for k in node)
    if isinstance(node, list):
        return len(node) * block_bytes(sp[1:], tuple(node[0].shape))
    return block_bytes(sp, tuple(node.shape))
out["param_block_bytes"] = walk(full, specs)
print("RESULT " + json.dumps(out))
""")


def test_mini_dryrun_runs_every_kind(launched):
    """Rank 5 of a (2, 4) mesh: train, prefill and decode are ``ok``; the
    arguments are this rank's parameter blocks (with AdamW's two f32
    moments and its step in training) and its inputs: 4 of the 8 rows of
    64 int32 tokens (and targets), one token and its cache block in
    decode (2 layers of 4 rows x 64 slots x 2 KV heads x a quarter of hd
    32, float32, K and V, and ``pos``)."""
    mini_dryrun = launched["dryrun"]
    pb = mini_dryrun["param_block_bytes"]
    args = {"train": 3 * pb + 4 + 2 * 4 * 64 * 4,
            "prefill": pb + 4 * 64 * 4,
            "decode": pb + 4 * 1 * 4 + 2 * (2 * 4 * 64 * 2 * 8 * 4) + 4}
    for kind, want in args.items():
        rec = mini_dryrun[kind]
        assert rec["status"] == "ok", rec["error"]
        assert rec["n_devices"] == 8 and rec["flops_per_device"] > 0
        assert rec["memory"]["argument_bytes"] == want, kind
        assert rec["memory"]["temp_bytes"] > 0


def test_mini_dryrun_collective_kinds(launched):
    kinds = {kind: {k for k, v in launched["dryrun"][kind][
        "collective_bytes_per_device"].items() if v}
        for kind in ("train", "prefill", "decode")}
    assert kinds == {"train": {"all-gather", "reduce-scatter", "all-reduce"},
                     "prefill": {"all-gather"},
                     "decode": {"all-gather", "all-reduce"}}


def test_mini_dryrun_non_dense_is_an_error_and_long_decode_skips(
        launched):
    mini_dryrun = launched["dryrun"]
    assert mini_dryrun["mamba2"]["status"] == "error"
    assert "The sharded LLM step beyond the dense family" in \
        mini_dryrun["mamba2"]["error"]
    assert mini_dryrun["long"] == {
        "status": "skipped",
        "reason": "full-attention arch: 524k dense KV decode is "
                  "architecturally unsupported (DESIGN.md §6)"}


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2],
            tuple(int(x) for x in sys.argv[3].split(",")),
            tuple(sys.argv[4].split(",")))
