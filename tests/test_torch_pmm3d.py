"""The port's 3D-PMM primitives against the reference's, rank by rank.

Each primitive runs on a (d, x, y, z) = (1, 2, 2, 2) mesh: the reference
inside ``shard_map(check_vma=False)`` on 8 forced host devices (one
subprocess), the port in 8 gloo ranks (this file run as a script), both
on the same numpy inputs, one block per device (rank r at the row-major
coordinates, the reference's device r). Each returns its outputs and the
gradient of ``sum(out * w)`` for a per-device ``w``, which holds the
transposes: an all-reduce to an all-reduce, a tiled all-gather to the sum
of its cotangents sliced back, a permutation to its inverse. Limits:
outputs and gradients within 1e-6 of their largest |value| (f32 sums in
another order; data movement and counts exactly). The single-device
tests need no process group: there every collective is the identity and
makes no call.

    python tests/test_torch_pmm3d.py INPUTS.npz OUT_DIR     # one rank
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, ROWS, D_LOC, C_LOC, N_CLASSES = 2, 6, 4, 4, 7     # 8 padded classes
RANK_TIMEOUT_S = 180

# name -> (inputs, outputs) of each primitive's case
CASES = {
    "psum": (("x", "w"), ("out",)),
    "rmsnorm": (("x", "scale", "w"), ("out",)),
    "xent": (("logits", "labels"), ("nll", "cnt")),
    "argmax": (("logits", "labels"), ("correct", "total")),
    "gather": (("t", "w"), ("out",)),
    "permute": (("t", "w"), ("out",)),
}
# the input each case differentiates
WRT = {"psum": "x", "rmsnorm": "x", "xent": "logits", "gather": "t",
       "permute": "t"}


def _inputs():
    """One block per device, (1, 2, 2, 2, ...) each."""
    rng = np.random.default_rng(0)
    dev = (1, G, G, G)
    f = lambda *s: rng.normal(size=dev + s).astype(np.float32)
    labels = rng.integers(-1, N_CLASSES, size=dev + (ROWS,)).astype(np.int32)
    logits = f(ROWS, C_LOC) * 3.0
    logits[..., 0, :] = 1.5                  # a row of ties
    return {"x": f(ROWS, D_LOC), "scale": f(D_LOC), "w": f(ROWS, D_LOC),
            "logits": logits, "labels": labels, "t": f(ROWS, D_LOC)}


REFERENCE = textwrap.dedent("""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import fourd, pmm3d
from repro.core.compat import shard_map

N_CLASSES = {n_classes}
mesh = fourd.make_mesh_4d(1, 2)
SPEC = P("d", "x", "y", "z")
inp = dict(np.load(sys.argv[1]))
st = pmm3d.initial_state()


def psum(x, w):
    out = pmm3d.psum_maybe_bf16(x, "y", False)
    return (out,), jnp.sum(out * w)


def rmsnorm(x, scale, w):
    out = pmm3d.parallel_rmsnorm(x, scale, "y", 2 * x.shape[-1], 1e-6)
    return (out,), jnp.sum(out * w)


def xent(logits, labels):
    nll, cnt = pmm3d.parallel_cross_entropy(logits, labels, "y", "x",
                                            N_CLASSES)
    return (nll, cnt), nll


def argmax(logits, labels):
    c, t = pmm3d.parallel_argmax_correct(logits, labels, "y", "x", N_CLASSES)
    return (c, t), 0.0 * jnp.sum(logits)


def gather(t, w):
    out = pmm3d.reshard_gather(t, st, (st.rep, st.row))
    return (out,), jnp.sum(out * w)


def permute(t, w):
    out = pmm3d.reshard_permute(t, st, (st.rep, st.row))
    return (out,), jnp.sum(out * w)


res = {{}}
for name, (args, outs, wrt) in {cases}.items():
    fn = globals()[name]

    def local(*a, fn=fn):
        o, s = fn(*(x[0, 0, 0, 0] for x in a))
        return tuple(jnp.asarray(v)[None, None, None, None]
                     for v in (*o, s))
    sm = shard_map(local, mesh=mesh, in_specs=(SPEC,) * len(args),
                   out_specs=(SPEC,) * (len(outs) + 1), check_vma=False)
    vals = [jnp.asarray(inp[a]) for a in args]
    got = jax.jit(sm)(*vals)
    for o, v in zip(outs, got):
        res[f"{{name}}_{{o}}"] = np.asarray(v)
    if wrt is not None:
        k = args.index(wrt)
        gr = jax.jit(jax.grad(lambda *a: jnp.sum(sm(*a)[-1]), argnums=k))(
            *vals)
        res[f"{{name}}_grad"] = np.asarray(gr)
np.savez(sys.argv[2], **res)
print("PASS")
""").format(n_classes=N_CLASSES,
            cases={k: (a, o, WRT.get(k)) for k, (a, o) in CASES.items()})


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(reference, {rank: port}) outputs and gradients of every case."""
    d = tmp_path_factory.mktemp("pmm3d")
    np.savez(d / "inputs.npz", **_inputs())
    env = dict(_env(), XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE,
                            str(d / "inputs.npz"), str(d / "ref.npz")],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(d / "inputs.npz"),
         str(d)], env=dict(_env(), RANK=str(r), WORLD_SIZE="8",
                           STORE=str(d / "store")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(8)]
    outs = []
    try:
        for p in [ref] + procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in [ref] + procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(i, p.returncode, o) for i, (p, o) in
           enumerate(zip([ref] + procs, outs)) if p.returncode != 0]
    assert not bad, "\n".join(f"process {i} (0: the reference) exited {rc}:"
                              f"\n{o[-3000:]}" for i, rc, o in bad)
    load = lambda p: dict(np.load(p))
    return load(d / "ref.npz"), {r: load(d / f"rank{r}.npz")
                                 for r in range(8)}


def _device(a, r):
    """Device r's block of a (1, 2, 2, 2, ...) reference output."""
    return a[(0,) + np.unravel_index(r, (G, G, G))]


@pytest.mark.parametrize("case", list(CASES))
def test_primitive_outputs_match_reference_rank_by_rank(both, case):
    ref, port = both
    for r in range(8):
        for o in CASES[case][1]:
            want, got = _device(ref[f"{case}_{o}"], r), port[r][f"{case}_{o}"]
            assert got.shape == want.shape, (case, o, r)
            if case in ("gather", "permute", "argmax"):
                assert np.array_equal(got, want), (case, o, r)
            else:
                np.testing.assert_allclose(
                    got, want, atol=1e-6 * max(1.0, np.abs(want).max()),
                    err_msg=f"{case} {o} rank {r}")


@pytest.mark.parametrize("case", list(WRT))
def test_primitive_gradients_match_reference_rank_by_rank(both, case):
    """The transposes: all-reduce -> all-reduce (psum, RMSNorm, the
    loss), all-gather -> summed and sliced back (reshard_gather),
    permutation -> its inverse (reshard_permute)."""
    ref, port = both
    for r in range(8):
        want, got = _device(ref[f"{case}_grad"], r), port[r][f"{case}_grad"]
        np.testing.assert_allclose(
            got, want, atol=1e-6 * max(1.0, np.abs(want).max()),
            err_msg=f"{case} gradient, rank {r}")


def test_reshards_agree_on_replicated_blocks(both):
    """With the input replicated over the rep axis, as the layer program
    holds it, the two reshards move the same bits; with a block of its own
    on every device (the cases above) they differ, so each is held to the
    reference's own routing there."""
    _, port = both
    assert any(not np.array_equal(port[r]["gather_out"],
                                  port[r]["permute_out"]) for r in range(8))
    assert all(port[r]["replicated_equal"] for r in range(8))


# ---------------------------------------------------------------------------
# One device: no process group, no call
# ---------------------------------------------------------------------------

def test_collectives_without_a_group_are_the_identity(monkeypatch):
    """At 1x1x1x1 with no process group every primitive is its local math
    and calls no collective: all_reduce and all_gather raise if called."""
    import torch.distributed as dist

    from repro_torch.core import fourd, pmm3d
    from repro_torch.core import gcn_model as TM
    from repro_torch.core.precision import psum

    def boom(*a, **k):
        raise AssertionError("a collective was called")
    for name in ("all_reduce", "all_gather", "batch_isend_irecv"):
        monkeypatch.setattr(dist, name, boom)
    mesh = fourd.make_mesh_4d(1, 1, "cpu")
    assert mesh.groups is None and mesh.size == 1
    ax = mesh.axis("x")
    x = torch.randn(5, 8)
    assert psum(x, ax) is x
    st = pmm3d.initial_state()
    for impl in ("gather", "permute"):
        assert torch.equal(pmm3d.reshard(x, mesh, st, (st.rep, st.row),
                                         impl=impl), x)
    scale = torch.rand(8) + 0.5
    torch.testing.assert_close(pmm3d.parallel_rmsnorm(x, scale, ax, 8),
                               TM.rmsnorm(x, scale), rtol=1e-6, atol=1e-6)
    labels = torch.tensor([0, 3, -1, 7, 2])
    nll, cnt = pmm3d.parallel_cross_entropy(x, labels, ax, ax, 8)
    torch.testing.assert_close(nll / cnt, TM.cross_entropy_loss(x, labels))
    c, t = pmm3d.parallel_argmax_correct(x, labels, ax, ax, 8)
    assert float(c / t) == float(TM.accuracy(x, labels))


def test_single_device_step_is_the_model_forward():
    """The engine at 1x1x1x1 computes exactly ``gcn_model.forward`` (the
    same ops in the same order): logits bit for bit, dense and ELL, plain
    and fused tail, dropout on."""
    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as TM
    from repro_torch.core.forward import ForwardEngine, TrainOptions
    from repro_torch.core.forward import dropout_masks
    from repro_torch.kernels.spmm_ell import dense_to_block_ell
    rng = np.random.default_rng(1)
    b, d_in = 64, 12
    adj = torch.from_numpy(((rng.random((b, b)) < 0.1)
                            * rng.random((b, b))).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(b, d_in)).astype(np.float32))
    cfg = TM.GCNConfig(d_in=d_in, d_hidden=16, num_layers=3, num_classes=5)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = fourd.make_mesh_4d(1, 1, "cpu")
    for spmm, fused in (("dense", False), ("ell", True)):
        opts = TrainOptions(spmm_impl=spmm, fused_elementwise=fused,
                            dropout=0.3, seed=2)
        blk = adj if spmm == "dense" else dense_to_block_ell(adj, 16, 16, 4)
        mcfg = fourd.model_config(cfg, opts)
        eng = ForwardEngine.from_options(mcfg, opts, mesh)
        got, _ = eng(params, (blk,), x, step=5, train=True)
        want = TM.forward(params, blk, x, mcfg, train=True,
                          keep_masks=dropout_masks(opts, 5, 3, (b, 16),
                                                   "cpu"))
        if fused:
            assert torch.equal(got, want)
        else:                  # the norm's mean is a sum over d here
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The rank worker
# ---------------------------------------------------------------------------

def _worker(inputs, out_dir):
    import datetime

    import torch.distributed as dist

    from repro_torch.core import fourd, pmm3d
    from repro_torch.core.precision import psum_maybe_bf16

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.environ["STORE"], 8), rank=rank,
        world_size=8, timeout=datetime.timedelta(seconds=120))
    mesh = fourd.make_mesh_4d(1, G, "cpu")
    inp = np.load(inputs)
    c = mesh.coords
    local = {k: torch.from_numpy(inp[k][0, c["x"], c["y"], c["z"]].copy())
             for k in inp.files}
    ax = mesh.axis
    st = pmm3d.initial_state()
    fns = {
        "psum": lambda x, w: (psum_maybe_bf16(x, ax("y"), False),),
        "rmsnorm": lambda x, scale, w: (pmm3d.parallel_rmsnorm(
            x, scale, ax("y"), 2 * D_LOC, 1e-6),),
        "xent": lambda logits, labels: pmm3d.parallel_cross_entropy(
            logits, labels, ax("y"), ax("x"), N_CLASSES),
        "argmax": lambda logits, labels: pmm3d.parallel_argmax_correct(
            logits, labels, ax("y"), ax("x"), N_CLASSES),
        "gather": lambda t, w: (pmm3d.reshard_gather(t, mesh, st,
                                                     (st.rep, st.row)),),
        "permute": lambda t, w: (pmm3d.reshard_permute(t, mesh, st,
                                                       (st.rep, st.row)),),
    }
    out = {}
    for name, (args, outs) in CASES.items():
        vals = [local[a].clone() for a in args]
        wrt = WRT.get(name)
        if wrt is not None:
            vals[args.index(wrt)].requires_grad_(True)
        with torch.enable_grad():
            got = fns[name](*vals)
            for o, v in zip(outs, got):
                out[f"{name}_{o}"] = v.detach().numpy()
            if wrt is not None:
                s = got[0] if name == "xent" else torch.sum(got[0]
                                                            * local["w"])
                out[f"{name}_grad"] = torch.autograd.grad(
                    s, vals[args.index(wrt)])[0].numpy()
    # a block replicated over the rep axis (z): both reshards move it alike
    rep = torch.from_numpy(inp["t"][0, c["x"], c["y"], 0].copy())
    out["replicated_equal"] = np.asarray(torch.equal(
        pmm3d.reshard_gather(rep, mesh, st, (st.rep, st.row)),
        pmm3d.reshard_permute(rep, mesh, st, (st.rep, st.row))))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
