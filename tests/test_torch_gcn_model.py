"""The port's GCN model against the JAX reference, weights carried across
with ``params_from_numpy``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gcn_model as JM  # noqa: E402
from repro_torch.core import gcn_model as TM  # noqa: E402
from repro_torch.kernels import spmm_ell  # noqa: E402

B, D_IN, D_H, LAYERS, CLASSES = 48, 12, 32, 3, 5
# f32 GEMM chains on both sides, summed in different orders
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    adj = rng.random((B, B)).astype(np.float32)
    adj *= rng.random((B, B)) < 0.2
    adj /= np.maximum(adj.sum(1, keepdims=True), 1e-3)
    x = rng.normal(size=(B, D_IN)).astype(np.float32)
    jcfg = JM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=LAYERS,
                        num_classes=CLASSES, dropout=0.25)
    jparams = JM.init_params(jax.random.PRNGKey(3), jcfg)
    # non-trivial RMSNorm scales so the carried scales matter
    for i, layer in enumerate(jparams["layers"]):
        layer["rms_scale"] = layer["rms_scale"] * (1.0 + 0.1 * i)
    np_params = jax.tree.map(np.asarray, jparams)
    return adj, x, jcfg, jparams, np_params


def _port_cfg(jcfg, impl):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["elementwise_impl"] = impl
    return TM.GCNConfig(**fields)


@pytest.mark.parametrize("jimpl,timpl", [("jnp", "torch"),
                                         ("pallas", "cuda")])
def test_forward_matches_jax(setup, jimpl, timpl):
    adj, x, jcfg, jparams, np_params = setup
    ref = JM.forward(jparams, jnp.asarray(adj), jnp.asarray(x),
                     dataclasses.replace(jcfg, elementwise_impl=jimpl),
                     train=False)
    params = TM.params_from_numpy(np_params, device="cpu")
    got = TM.forward(params, torch.from_numpy(adj), torch.from_numpy(x),
                     _port_cfg(jcfg, timpl), train=False)
    assert got.shape == (B, CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("jimpl,timpl", [("jnp", "torch"),
                                         ("pallas", "cuda")])
def test_forward_train_with_injected_keep_masks(setup, jimpl, timpl):
    """The JAX model draws its dropout masks from a key; the port is handed
    the same masks (rebuilt here from that key) and must agree."""
    adj, x, jcfg, jparams, np_params = setup
    key = jax.random.PRNGKey(11)
    ref = JM.forward(jparams, jnp.asarray(adj), jnp.asarray(x),
                     dataclasses.replace(jcfg, elementwise_impl=jimpl),
                     dropout_key=key, train=True)
    masks = [torch.from_numpy(np.array(jax.random.bernoulli(
        k, 1.0 - jcfg.dropout, (B, D_H))))
        for k in jax.random.split(key, LAYERS)]
    params = TM.params_from_numpy(np_params, device="cpu")
    cfg = _port_cfg(jcfg, timpl)
    got = TM.forward(params, torch.from_numpy(adj), torch.from_numpy(x),
                     cfg, train=True, keep_masks=masks)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    eval_out = TM.forward(params, torch.from_numpy(adj), torch.from_numpy(x),
                          cfg, train=False, keep_masks=masks)
    assert not np.allclose(eval_out.numpy(), got.numpy())


def test_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(40, CLASSES)).astype(np.float32) * 3
    labels = rng.integers(-1, CLASSES, 40).astype(np.int32)
    weights = rng.random(40).astype(np.float32)
    mask = rng.random(40) < 0.6
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    for w in (None, weights):
        ref = JM.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                    None if w is None else jnp.asarray(w))
        got = TM.cross_entropy_loss(tl, tlab,
                                    None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    for m in (None, mask):
        ref = JM.accuracy(jnp.asarray(logits), jnp.asarray(labels),
                          None if m is None else jnp.asarray(m))
        got = TM.accuracy(tl, tlab, None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def test_params_carry_is_a_copy_and_init_is_seeded():
    cfg = TM.GCNConfig(d_in=D_IN, d_hidden=D_H, num_layers=2,
                       num_classes=CLASSES)
    a = TM.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = TM.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    assert a["w_in"].shape == (D_IN, D_H) and len(a["layers"]) == 2
    assert a["w_out"].shape == (D_H, CLASSES)
    assert all(torch.equal(x, y) for x, y in
               zip([a["w_in"], a["w_out"]], [b["w_in"], b["w_out"]]))
    tree = {"w_in": a["w_in"].numpy(), "w_out": a["w_out"].numpy(),
            "layers": [{k: v.numpy() for k, v in layer.items()}
                       for layer in a["layers"]]}
    c = TM.params_from_numpy(tree, device="cpu")
    assert torch.equal(c["layers"][1]["w"], a["layers"][1]["w"])
    # the block-ELL aggregation gives the dense forward on the same block
    rng = np.random.default_rng(2)
    adj = rng.random((B, B)).astype(np.float32) * (rng.random((B, B)) < 0.1)
    x = torch.from_numpy(rng.normal(size=(B, D_IN)).astype(np.float32))
    ell = spmm_ell.dense_to_block_ell(torch.from_numpy(adj), 16, 16, B // 16)
    dense_out = TM.forward(c, torch.from_numpy(adj), x, cfg)
    ell_out = TM.forward(c, ell, x,
                         dataclasses.replace(cfg, spmm_impl="ell"))
    np.testing.assert_allclose(ell_out.numpy(), dense_out.numpy(),
                               rtol=RTOL, atol=ATOL)
