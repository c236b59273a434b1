"""The port's optimizers, schedules and checkpoints against the JAX
package: the same numpy grads through both optimizers, the same steps
through both schedules, and a ``TrainState`` checkpoint written by each
package loaded by the other."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as jopt  # noqa: E402
from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.checkpoint.ckpt import _flatten_with_paths as _jflat  # noqa: E402
from repro.train.state import init_train_state as jinit  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.checkpoint import load_checkpoint as tload  # noqa: E402
from repro_torch.checkpoint import save_checkpoint as tsave  # noqa: E402
from repro_torch.train.state import init_train_state as tinit  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402


def _tree(rng, scale=1.0):
    mk = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)
    return {"w_in": mk(6, 4), "w_out": mk(4, 3),
            "layers": [{"w": mk(4, 4), "rms_scale": mk(4)} for _ in range(2)]}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _flat(tree):
    return {"::".join(p): t.numpy() for p, t in flatten_with_paths(tree)}


SCHEDULES = [
    ("constant_schedule", (3e-3,)),
    ("cosine_schedule", (5e-3, 40, 0.1)),
    ("linear_warmup_cosine", (5e-3, 20, 48)),
    ("cosine_schedule_epochs", (1e-2, 3, 7)),
    ("linear_warmup_cosine_epochs", (5e-3, 0.5, 4, 10)),
]


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedules_equal_reference(name, args):
    """float32 on both sides; cos from two libraries: rtol 1e-6."""
    jf, tf = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for step in (0, 1, 5, 19, 20, 21, 33, 47, 48, 60):
        got = tf(torch.tensor(step, dtype=torch.int32))
        ref = jf(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


OPTIMIZERS = [
    ("AdamW", dict(lr=jopt.linear_warmup_cosine(1e-2, 2, 5), grad_clip=1.0,
                   weight_decay=1e-4),
     dict(lr=topt.linear_warmup_cosine(1e-2, 2, 5), grad_clip=1.0,
          weight_decay=1e-4)),
    ("AdamW", dict(lr=3e-3), dict(lr=3e-3)),
    ("Sgd", dict(lr=0.1), dict(lr=0.1)),
    ("Sgd", dict(lr=jopt.cosine_schedule(0.1, 5), momentum=0.9),
     dict(lr=topt.cosine_schedule(0.1, 5), momentum=0.9)),
]


@pytest.mark.parametrize("name,jkw,tkw", OPTIMIZERS)
def test_optimizers_match_reference_over_5_steps(name, jkw, tkw):
    """Identical numpy grads, five steps: rtol 1e-6 (clipping at 1.0 is
    active: the grads' norm is about 4)."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, 0.7) for _ in range(5)]
    jo, to = getattr(jopt, name)(**jkw), getattr(topt, name)(**tkw)
    jp = _to_jax(params)
    js = jo.init(jp)
    tp = _to_torch(params)
    ts = to.init(tp)
    for g in grads:
        jp, js = jo.update(jp, _to_jax(g), js)
        tp2, ts = to.update(tp, _to_torch(g), ts)
        assert tp2 is tp                       # updated in place
    ref = _jflat(jp)
    assert sorted(ref) == sorted(_flat(tp))
    for k, v in _flat(tp).items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-6, atol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 5
    assert ts["step"].dtype == torch.int32


@pytest.mark.parametrize("name,jkw,tkw", OPTIMIZERS[:2])
def test_adamw_updates_a_large_leaf_in_slices_to_the_same_bits(
        monkeypatch, name, jkw, tkw):
    """A leaf above ``UPDATE_SLICE`` elements is updated a slice of its
    flat view at a time (a remainder slice included): three steps give the
    bits of the whole-leaf update, moments and step included."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(2)
    params = _tree(rng)
    grads = [_tree(rng, 0.7) for _ in range(3)]
    out = []
    for limit in (adamw.UPDATE_SLICE, 5):
        monkeypatch.setattr(adamw, "UPDATE_SLICE", limit)
        opt = getattr(topt, name)(**tkw)
        tp = _to_torch(params)
        ts = opt.init(tp)
        for g in grads:
            opt.update(tp, _to_torch(g), ts)
        out.append(_flat({"p": tp, "mu": ts["mu"], "nu": ts["nu"]}))
    assert list(adamw._slices(torch.zeros(24)))[-1][0].numel() == 4
    assert out[0].keys() == out[1].keys()
    for k in out[0]:
        assert np.array_equal(out[0][k], out[1][k]), k


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    g = _tree(rng, 2.0)
    jg, jn = jopt.clip_by_global_norm(_to_jax(g), 1.0)
    tg, tn = topt.clip_by_global_norm(_to_torch(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(tg["w_in"].numpy(), np.asarray(jg["w_in"]),
                               rtol=1e-6)


def _jax_state(rng):
    params = _to_jax(_tree(rng))
    opt = jopt.AdamW(lr=1e-2)
    state = jinit(params, opt.init(params))
    p, o = opt.update(params, _to_jax(_tree(rng)), state.opt_state)
    return state.__class__(params=p, opt_state=o,
                           step=jnp.asarray(7, jnp.int32),
                           epoch=jnp.asarray(2, jnp.int32))


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    ref = _jax_state(np.random.default_rng(2))
    jsave(str(tmp_path), 7, ref, name="state")
    example = tinit(_to_torch(_tree(np.random.default_rng(9))),
                    topt.AdamW().init(_to_torch(_tree(
                        np.random.default_rng(9)))))
    got, step = tload(str(tmp_path), 7, example, name="state")
    assert step == 7 and int(got.step) == 7 and int(got.epoch) == 2
    assert got.step.dtype == torch.int32
    np.testing.assert_array_equal(got.params["layers"][1]["w"].numpy(),
                                  np.asarray(ref.params["layers"][1]["w"]))
    np.testing.assert_array_equal(got.opt_state["nu"]["w_out"].numpy(),
                                  np.asarray(ref.opt_state["nu"]["w_out"]))
    assert int(got.opt_state["step"]) == 1


def test_port_checkpoint_loads_in_jax(tmp_path):
    rng = np.random.default_rng(3)
    tp = _to_torch(_tree(rng))
    opt = topt.AdamW(lr=1e-2)
    state = tinit(tp, opt.init(tp))
    opt.update(state.params, _to_torch(_tree(rng)), state.opt_state)
    state.step = torch.tensor(5, dtype=torch.int32)
    path = tsave(str(tmp_path), 5, state, name="state")
    ref_example = _jax_state(np.random.default_rng(4))
    got, _ = jload(str(tmp_path), 5, ref_example, name="state")
    assert int(got.step) == 5 and int(got.epoch) == 0
    np.testing.assert_array_equal(np.asarray(got.params["w_in"]),
                                  state.params["w_in"].numpy())
    np.testing.assert_array_equal(np.asarray(got.opt_state["mu"]["layers"]
                                             [0]["rms_scale"]),
                                  state.opt_state["mu"]["layers"][0]
                                  ["rms_scale"].numpy())
    with np.load(path) as data:
        assert sorted(data.files) == sorted(_jflat(ref_example))


def test_lossy_dtype_restore_fails(tmp_path):
    state = tinit({"w": torch.ones(2)},
                  {"step": torch.zeros((), dtype=torch.int32)})
    tsave(str(tmp_path), 1, {"w": torch.tensor([1.5, 2.0])}, name="x")
    with pytest.raises(ValueError, match="losslessly"):
        tload(str(tmp_path), 1, {"w": torch.zeros(2, dtype=torch.int32)},
              name="x")
    with pytest.raises(ValueError, match="no leaf"):
        tload(str(tmp_path), 1, state, name="x")
