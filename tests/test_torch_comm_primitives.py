"""The port's §V communication primitives against the reference's, rank by
rank, bit for bit.

The ring forms (``ring_psum``, ``ring_psum_gemm``, ``ring_all_gather``)
and the compressed ones (``ring_psum_q``, ``ring_reduce_scatter_q``,
``compressed_psum``, ``compressed_psum_gemm``, ``reshard_compressed`` with
both impls) run on a (d, x, y, z) = (1, 2, 2, 2) mesh: the reference
inside ``shard_map(check_vma=False)`` on 8 forced host devices (one
subprocess), the port in 8 gloo ranks (this file run as a script), on the
same numpy inputs, one block per device (rank r at the row-major
coordinates, the reference's device r). Each case returns its outputs
(the residual of a compressed form among them) and, where it is
differentiable, the gradient of ``sum(out * w)`` for a per-device ``w``
with respect to each input named in ``WRT``. At g = 2 every reduction is
one add and every quantized hop the same elementwise ops, so outputs,
residuals and gradients must be equal bit for bit. The quantizers are
held against the reference's on one process, and the g = 1 rules (a bf16
wire keeps its casts, a quantized wire is exact with a zero residual, no
collective is called) without a process group.

    python tests/test_torch_comm_primitives.py INPUTS.npz OUT_DIR   # one rank
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, ROWS, D = 2, 5, 4          # 5 rows: the rings pad a chunk
RANK_TIMEOUT_S = 180

# name -> (inputs, outputs); "w" (or "w2") weighs the differentiated sum
CASES = {
    "ring_psum": (("x", "w"), ("out",)),
    "ring_psum_bf16": (("x", "w"), ("out",)),
    "ring_gemm": (("x", "wm", "w2"), ("out",)),
    "ring_gemm_bf16": (("x", "wm", "w2"), ("out",)),
    "ring_ag0": (("x", "wag0"), ("out",)),
    "ring_ag1": (("x", "wag1"), ("out",)),
    "psum_q8": (("x", "ef"), ("out", "resid")),
    "psum_q4": (("x", "ef"), ("out", "resid")),
    "rs_q8": (("v",), ("out",)),
    "rs_q4": (("v",), ("out",)),
    "cpsum_q8": (("x", "ef", "w"), ("out", "resid")),
    "cgemm_q8": (("x", "wm", "ef", "w2"), ("out", "resid")),
    "cgemm_q4": (("x", "wm", "ef", "w2"), ("out", "resid")),
    "reshard_gather_q8": (("t", "eft", "wt"), ("out", "resid")),
    "reshard_gather_q4": (("t", "eft", "wt"), ("out", "resid")),
    "reshard_permute_q8": (("t", "eft", "wt"), ("out", "resid")),
}
WRT = {"ring_psum": ("x",), "ring_psum_bf16": ("x",),
       "ring_gemm": ("x", "wm"), "ring_gemm_bf16": ("x", "wm"),
       "ring_ag0": ("x",), "ring_ag1": ("x",), "cpsum_q8": ("x",),
       "cgemm_q8": ("x", "wm"), "cgemm_q4": ("x", "wm"),
       "reshard_gather_q8": ("t",), "reshard_gather_q4": ("t",),
       "reshard_permute_q8": ("t",)}


def _inputs():
    """One block per device, (1, 2, 2, 2, ...) each."""
    rng = np.random.default_rng(0)
    dev = (1, G, G, G)
    f = lambda *s: rng.normal(size=dev + s).astype(np.float32)
    x = f(ROWS, D)
    x[..., 1, :] = 0.0                       # a zero row: scale 1.0
    x[..., 2, :] *= 1e3
    return {"x": x, "w": f(ROWS, D), "wm": f(D, 6), "w2": f(ROWS, 6),
            "wag0": f(G * ROWS, D), "wag1": f(ROWS, G * D),
            "ef": 0.01 * f(ROWS, D), "v": f(2 * G, 2 * D),
            "t": f(2 * G, D), "eft": 0.01 * f(2 * G, D), "wt": f(2 * G, D)}


REFERENCE = textwrap.dedent("""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import fourd, pmm3d
from repro.core.compat import shard_map

mesh = fourd.make_mesh_4d(1, 2)
SPEC = P("d", "x", "y", "z")
inp = dict(np.load(sys.argv[1]))
st = pmm3d.initial_state()
TO = (st.rep, st.row)


def weighed(out, w):
    return jnp.sum(out * w)


def ring_psum(x, w):
    out = pmm3d.ring_psum(x, "y")
    return (out,), weighed(out, w)


def ring_psum_bf16(x, w):
    out = pmm3d.ring_psum(x, "y", bf16=True)
    return (out,), weighed(out, w)


def ring_gemm(x, wm, w2):
    out = pmm3d.ring_psum_gemm(x, wm, "y")
    return (out,), weighed(out, w2)


def ring_gemm_bf16(x, wm, w2):
    out = pmm3d.ring_psum_gemm(x, wm, "y", bf16=True)
    return (out,), weighed(out, w2)


def ring_ag0(x, w):
    out = pmm3d.ring_all_gather(x, "y", axis=0)
    return (out,), weighed(out, w)


def ring_ag1(x, w):
    out = pmm3d.ring_all_gather(x, "y", axis=1)
    return (out,), weighed(out, w)


def psum_q8(x, ef):
    out, r = pmm3d.ring_psum_q(x, "y", 8, ef)
    return (out, r), 0.0 * jnp.sum(x)


def psum_q4(x, ef):
    out, r = pmm3d.ring_psum_q(x, "y", 4, ef)
    return (out, r), 0.0 * jnp.sum(x)


def rs_q8(v):
    out = pmm3d.ring_reduce_scatter_q(v, "y", 8, dim=0)
    return (out,), 0.0 * jnp.sum(v)


def rs_q4(v):
    out = pmm3d.ring_reduce_scatter_q(v, "y", 4, dim=1)
    return (out,), 0.0 * jnp.sum(v)


def cpsum_q8(x, ef, w):
    out, r = pmm3d.compressed_psum(x, "y", "int8", ef)
    return (out, r), weighed(out, w)


def cgemm_q8(x, wm, ef, w2):
    out, r = pmm3d.compressed_psum_gemm(x, wm, "y", "int8", ef)
    return (out, r), weighed(out, w2)


def cgemm_q4(x, wm, ef, w2):
    out, r = pmm3d.compressed_psum_gemm(x, wm, "y", "int4", ef)
    return (out, r), weighed(out, w2)


def reshard_gather_q8(t, ef, w):
    out, r = pmm3d.reshard_compressed(t, st, TO, "int8", ef, impl="gather")
    return (out, r), weighed(out, w)


def reshard_gather_q4(t, ef, w):
    out, r = pmm3d.reshard_compressed(t, st, TO, "int4", ef, impl="gather")
    return (out, r), weighed(out, w)


def reshard_permute_q8(t, ef, w):
    out, r = pmm3d.reshard_compressed(t, st, TO, "int8", ef, impl="permute")
    return (out, r), weighed(out, w)


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
    for a in wrt:
        k = args.index(a)
        gr = jax.jit(jax.grad(lambda *v: jnp.sum(sm(*v)[-1]), argnums=k))(
            *vals)
        res[f"{{name}}_grad_{{a}}"] = np.asarray(gr)
np.savez(sys.argv[2], **res)
print("PASS")
""").format(cases={k: (a, o, WRT.get(k, ())) for k, (a, o) in CASES.items()})


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(reference, {rank: port}) outputs and gradients of every case."""
    d = tmp_path_factory.mktemp("comm")
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
def test_outputs_and_residuals_match_reference_bit_for_bit(both, case):
    ref, port = both
    for r in range(8):
        for o in CASES[case][1]:
            want, got = _device(ref[f"{case}_{o}"], r), port[r][f"{case}_{o}"]
            assert got.shape == want.shape and got.dtype == want.dtype, (
                case, o, r, got.shape, want.shape)
            assert np.array_equal(got, want), (
                case, o, r, np.abs(got - want).max())


@pytest.mark.parametrize("case", list(WRT))
def test_gradients_match_reference_bit_for_bit(both, case):
    """The backwards: a ring's psum transposes to the same ring, a ring
    all-gather to a sum sliced back, ``ring_psum_gemm`` to the reference's
    full-width backward, and each compressed form to its uncompressed
    transpose with every hop quantized at the forward's width."""
    ref, port = both
    for r in range(8):
        for a in WRT[case]:
            want = _device(ref[f"{case}_grad_{a}"], r)
            got = port[r][f"{case}_grad_{a}"]
            assert np.array_equal(got, want), (
                case, a, r, np.abs(got - want).max())


def test_quantized_ring_sends_int8_at_half_width_for_int4(both):
    """Every payload of ``ring_psum_q`` goes through ``pmm3d._post`` as
    int8 q (the row's D values at int8, D / 2 bytes at int4) and float32
    row scales: no float32 activation travels."""
    _, port = both
    for r in range(8):
        for bits in (8, 4):
            # (hops, 2, 3): each payload's dtype code (0 int8, 1 float32)
            # and shape
            sent = port[r][f"sent_q{bits}"]
            assert len(sent) == 2 * (G - 1)
            width = D if bits == 8 else D // 2
            for q, s in sent:
                assert tuple(q) == (0, -(-ROWS // G), width), (bits, q)
                assert tuple(s) == (1, -(-ROWS // G), 1), (bits, s)


def test_ring_equals_the_monolithic_sum_at_g2(both):
    """At g = 2 the ring is one add per element: bit for bit the port's
    own all-reduce, and its gather the port's ``all_gather``."""
    _, port = both
    for r in range(8):
        assert port[r]["ring_is_psum"] and port[r]["ring_is_gather"], r


# ---------------------------------------------------------------------------
# One process: the quantizers, and the g = 1 rules
# ---------------------------------------------------------------------------

def _ref_precision():
    from repro.core import precision
    return precision


@settings(max_examples=30, deadline=None)
@given(rows=hst.integers(1, 9), cols=hst.integers(1, 12),
       lead=hst.integers(0, 2), exp=hst.integers(-30, 30),
       zero_rows=hst.integers(0, 3), seed=hst.integers(0, 2 ** 16),
       bits=hst.sampled_from([8, 4]))
def test_quantizers_match_reference_bit_for_bit(rows, cols, lead, exp,
                                                zero_rows, seed, bits):
    """``quantize``/``dequantize`` (and at 4 bits the nibble packing) on
    the same inputs give the reference's bits as its rings run them, under
    ``jit`` (where XLA turns ``amax / qmax`` into ``amax * (1 / qmax)``):
    shapes with 0-2 leading dims, magnitudes 1e-30 to 1e30 (normal floats:
    XLA's CPU flushes subnormals to zero, the port keeps them, see
    ``test_subnormal_rows_keep_their_scale``), all-zero rows."""
    import jax
    import jax.numpy as jnp

    from repro_torch.core import precision as T
    J = _ref_precision()
    cols = 2 * cols if bits == 4 else cols
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2,) * lead + (rows, cols))
         * 10.0 ** exp).astype(np.float32)
    x.reshape(-1, cols)[:zero_rows] = 0.0
    jq, js = jax.jit(lambda v: J.quantize(v, bits))(jnp.asarray(x))
    tq, ts = T.quantize(torch.from_numpy(x), bits)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(T.dequantize(tq, ts, bits).numpy(),
                          np.asarray(J.dequantize(jq, js, bits)))


@pytest.mark.parametrize("rows,cols,bits,exp", [
    (3, 4, 8, 0), (3, 4, 4, 0), (64, 256, 8, 0), (64, 256, 4, 3),
    (1, 2, 4, 17), (8, 16, 8, -20)])
def test_dequantize_add_rounds_once_as_xla_fuses_it(rows, cols, bits, exp):
    """``acc ± dequantize(q, s)`` rounded once, as the fused multiply-add
    XLA's CPU backend contracts it to in the reference's rings: the ring
    chunk's shape, the training width, an accumulator 1e17 times smaller
    than the product (where rounding the float64 sum to nearest first
    would round twice; the port rounds it to odd). XLA contracts in its
    vectorised loops; in the scalar remainder of some shapes ((4, 3), for
    one) it rounds the product first, and there the port keeps the single
    rounding."""
    import jax
    import jax.numpy as jnp

    from repro_torch.core import precision as T
    J = _ref_precision()
    rng = np.random.default_rng(rows * cols + bits)
    x = (rng.normal(size=(rows, cols)) * 10.0 ** exp).astype(np.float32)
    acc = rng.normal(size=x.shape).astype(np.float32)
    jq, js = jax.jit(lambda v: J.quantize(v, bits))(jnp.asarray(x))
    tq, ts = T.quantize(torch.from_numpy(x), bits)
    for sign in (1, -1):
        want = jax.jit(lambda a, q, s: a + sign * J.dequantize(q, s, bits))(
            jnp.asarray(acc), jq, js)
        got = T.dequantize_add(torch.from_numpy(acc), tq, ts, bits, sign)
        assert np.array_equal(got.numpy(), np.asarray(want)), sign


@settings(max_examples=15, deadline=None)
@given(rows=hst.integers(1, 6), half=hst.integers(1, 8),
       seed=hst.integers(0, 2 ** 16))
def test_int4_packing_matches_reference(rows, half, seed):
    import jax.numpy as jnp

    from repro_torch.core import precision as T
    J = _ref_precision()
    q = np.random.default_rng(seed).integers(
        -7, 8, size=(rows, 2 * half)).astype(np.int8)
    packed = T.pack_int4(torch.from_numpy(q))
    assert packed.shape == (rows, half) and packed.dtype == torch.int8
    assert np.array_equal(packed.numpy(), np.asarray(J.pack_int4(
        jnp.asarray(q))))
    assert np.array_equal(T.unpack_int4(packed).numpy(), q)
    with pytest.raises(ValueError, match="even"):
        T.pack_int4(torch.zeros(2, 3, dtype=torch.int8))


def test_subnormal_rows_keep_their_scale():
    """A row whose absmax is subnormal keeps an IEEE scale in the port
    (and rebuilds within half a step), where XLA's CPU flushes it to zero
    and takes the all-zero scale 1.0: the one input class on which the
    quantizers differ."""
    from repro_torch.core import precision as T
    x = torch.tensor([[3e-39, -1e-39, 0.0, 2e-39]])
    q, s = T.quantize(x, 8)
    assert 0.0 < float(s) < 1.2e-38 and int(q[0, 0]) == 127
    assert float((T.dequantize(q, s, 8) - x).abs().max()) <= float(s) / 2


def _no_collectives(monkeypatch):
    import torch.distributed as dist

    from repro_torch.core import pmm3d

    def boom(*a, **k):
        raise AssertionError("a collective was called")
    for name in ("all_reduce", "all_gather", "batch_isend_irecv"):
        monkeypatch.setattr(dist, name, boom)
    monkeypatch.setattr(pmm3d, "_post", boom)


def test_bf16_wire_at_g1_keeps_its_casts(monkeypatch):
    """Without a group nothing travels, yet ``psum_maybe_bf16`` and the
    ring keep the bf16 round trip forward and backward, as the reference's
    do: the single device computes what a mesh computes."""
    from repro_torch.core import fourd, pmm3d
    from repro_torch.core.precision import psum_maybe_bf16
    _no_collectives(monkeypatch)
    ax = fourd.make_mesh_4d(1, 1, "cpu").axis("y")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    rt = lambda t: t.to(torch.bfloat16).to(torch.float32)
    assert not torch.equal(rt(x), x)
    for fn in (lambda t: psum_maybe_bf16(t, ax, True),
               lambda t: pmm3d.ring_psum(t, ax, bf16=True)):
        xi = x.clone().requires_grad_(True)
        y = fn(xi)
        assert torch.equal(y, rt(x))
        (dx,) = torch.autograd.grad(y, xi, g)
        assert torch.equal(dx, rt(g))
    assert pmm3d.ring_psum(x, ax) is x
    assert psum_maybe_bf16(x, ax, False) is x
    xi = x.clone().requires_grad_(True)
    wi = w.clone().requires_grad_(True)
    out = pmm3d.ring_psum_gemm(xi, wi, ax, bf16=True)
    assert torch.equal(out, rt(x) @ w)
    dx, dw = torch.autograd.grad(out, (xi, wi), torch.ones(6, 3))
    assert torch.equal(dx, rt(torch.ones(6, 3) @ w.T))
    assert torch.equal(dw, rt(x).T @ torch.ones(6, 3))


def test_quantized_wire_at_g1_is_exact_with_a_zero_residual(monkeypatch):
    """No hop, so no quantization: every compressed form returns ``x +
    ef`` (the reshard ``t`` itself) and a zero residual, calling no
    collective."""
    from repro_torch.core import fourd, pmm3d
    _no_collectives(monkeypatch)
    mesh = fourd.make_mesh_4d(1, 1, "cpu")
    ax = mesh.axis("x")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    zero = torch.zeros_like(x)
    for fmt, bits in (("int8", 8), ("int4", 4)):
        y, r = pmm3d.ring_psum_q(x, ax, bits, zero)
        assert torch.equal(y, x) and not r.any()
        y, r = pmm3d.compressed_psum(x, ax, fmt, zero)
        assert torch.equal(y, x) and not r.any()
        conv, r = pmm3d.compressed_psum_gemm(x, w, ax, fmt, zero)
        assert torch.equal(conv, x @ w) and not r.any()
        st = pmm3d.initial_state()
        for impl in ("gather", "permute"):
            y, r = pmm3d.reshard_compressed(x, mesh, st, (st.rep, st.row),
                                            fmt, zero, impl=impl)
            assert y is x and not r.any()
        assert torch.equal(pmm3d.ring_reduce_scatter_q(x, ax, bits), x)


# ---------------------------------------------------------------------------
# The rank worker
# ---------------------------------------------------------------------------

def _worker(inputs, out_dir):
    import datetime

    import torch.distributed as dist

    from repro_torch.core import fourd, pmm3d
    from repro_torch.core.precision import psum

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
    y = mesh.axis("y")
    st = pmm3d.initial_state()
    to = (st.rep, st.row)
    rs = lambda impl, fmt: (lambda t, ef, w: pmm3d.reshard_compressed(
        t, mesh, st, to, fmt, ef, impl=impl))
    fns = {
        "ring_psum": lambda x, w: (pmm3d.ring_psum(x, y),),
        "ring_psum_bf16": lambda x, w: (pmm3d.ring_psum(x, y, bf16=True),),
        "ring_gemm": lambda x, wm, w2: (pmm3d.ring_psum_gemm(x, wm, y),),
        "ring_gemm_bf16": lambda x, wm, w2: (
            pmm3d.ring_psum_gemm(x, wm, y, bf16=True),),
        "ring_ag0": lambda x, w: (pmm3d.ring_all_gather(x, y, dim=0),),
        "ring_ag1": lambda x, w: (pmm3d.ring_all_gather(x, y, dim=1),),
        "psum_q8": lambda x, ef: pmm3d.ring_psum_q(x, y, 8, ef),
        "psum_q4": lambda x, ef: pmm3d.ring_psum_q(x, y, 4, ef),
        "rs_q8": lambda v: (pmm3d.ring_reduce_scatter_q(v, y, 8, dim=0),),
        "rs_q4": lambda v: (pmm3d.ring_reduce_scatter_q(v, y, 4, dim=1),),
        "cpsum_q8": lambda x, ef, w: pmm3d.compressed_psum(x, y, "int8",
                                                           ef),
        "cgemm_q8": lambda x, wm, ef, w2: pmm3d.compressed_psum_gemm(
            x, wm, y, "int8", ef),
        "cgemm_q4": lambda x, wm, ef, w2: pmm3d.compressed_psum_gemm(
            x, wm, y, "int4", ef),
        "reshard_gather_q8": rs("gather", "int8"),
        "reshard_gather_q4": rs("gather", "int4"),
        "reshard_permute_q8": rs("permute", "int8"),
    }
    out = {}
    for name, (args, outs) in CASES.items():
        vals = [local[a].clone() for a in args]
        wrt = WRT.get(name, ())
        for a in wrt:
            vals[args.index(a)].requires_grad_(True)
        with torch.enable_grad():
            got = fns[name](*vals)
            for o, v in zip(outs, got):
                out[f"{name}_{o}"] = v.detach().numpy()
            if wrt:
                weight = local[args[-1]]
                grads = torch.autograd.grad(
                    torch.sum(got[0] * weight),
                    [vals[args.index(a)] for a in wrt])
                for a, gr in zip(wrt, grads):
                    out[f"{name}_grad_{a}"] = gr.numpy()
    # what the quantized ring puts on the wire
    post = pmm3d._post
    codes = {torch.int8: 0, torch.float32: 1}
    for bits in (8, 4):
        sent = []

        def spy(xs, dst, src):
            sent.append([(codes.get(t.dtype, -1),) + tuple(t.shape)
                         for t in xs])
            return post(xs, dst, src)
        pmm3d._post = spy
        pmm3d.ring_psum_q(local["x"], y, bits, local["ef"])
        pmm3d._post = post
        out[f"sent_q{bits}"] = np.asarray(sent)
    out["ring_is_psum"] = np.asarray(torch.equal(
        pmm3d.ring_psum(local["x"], y), psum(local["x"], y)))
    out["ring_is_gather"] = np.asarray(torch.equal(
        pmm3d.ring_all_gather(local["x"], y, dim=1),
        pmm3d.all_gather(local["x"], y, dim=1)))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
