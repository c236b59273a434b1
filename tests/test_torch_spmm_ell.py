"""The port's block-ELL SpMM and the autograd rules of ``kernels/ops.py``
against the JAX package.

On the CPU ``spmm_ell`` runs its plain version, held here against the
Pallas kernel (interpret mode, as the reference's own tests run it) at the
reference's shape sweep; the layout helpers must give the reference's
layouts bit for bit; the autograd rules of the SpMM and of the fused tail
are held against ``jax.grad`` through the reference's custom VJPs. The CUDA
kernel itself is held against the plain version on a card by
``test_torch_cuda_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import spmm_ell as jspmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import spmm_ell as tspmm  # noqa: E402

# the reference's sweep (tests/test_kernels.py)
SWEEP = [(8, 8, 4, 4, 16), (16, 32, 2, 4, 64), (32, 16, 4, 2, 8),
         (8, 128, 2, 2, 128)]


def _random_block_matrix(rng, n_rb, n_cb, bm, bn, density):
    dense = np.zeros((n_rb * bm, n_cb * bn), np.float32)
    for i in range(n_rb):
        for j in range(n_cb):
            if rng.random() < density:
                dense[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] = \
                    rng.normal(size=(bm, bn))
    return dense


def _t(a):
    """A torch tensor holding a copy of a numpy or JAX array."""
    return torch.from_numpy(np.array(a))


def _case(bm, bn, n_rb, n_cb, d, density, seed=0):
    rng = np.random.default_rng(seed)
    dense = _random_block_matrix(rng, n_rb, n_cb, bm, bn, density)
    nz = np.abs(dense).reshape(n_rb, bm, n_cb, bn).sum((1, 3)) > 0
    n_slots = max(int(nz.sum(1).max()), 1)
    x = rng.normal(size=(n_cb * bn, d)).astype(np.float32)
    return dense, n_slots, x


@pytest.mark.parametrize("bm,bn,n_rb,n_cb,d", SWEEP)
@pytest.mark.parametrize("density", [0.2, 0.7])
def test_spmm_ell_plain_matches_pallas(bm, bn, n_rb, n_cb, d, density):
    """f32, summed in another order than the Pallas kernel: atol 1e-4."""
    dense, n_slots, x = _case(bm, bn, n_rb, n_cb, d, density)
    tiles, colidx = jops.dense_to_block_ell(jnp.asarray(dense), bm, bn,
                                            n_slots)
    ref = np.asarray(jops.spmm_ell(tiles, colidx, jnp.asarray(x)))
    got = tspmm.spmm_ell(_t(tiles),
                         _t(colidx),
                         torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n_rb * bm, d)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), dense @ x, atol=1e-3)


@pytest.mark.parametrize("bm,bn,n_rb,n_cb,d", SWEEP)
def test_layout_helpers_bitmatch_jax(bm, bn, n_rb, n_cb, d):
    """dense_to_block_ell (exact and dropping slot counts),
    dense_to_block_ell_ranked, ell_to_dense and block_density give the
    reference's arrays bit for bit."""
    dense, n_slots, _ = _case(bm, bn, n_rb, n_cb, d, 0.5, seed=3)
    jd, td = jnp.asarray(dense), torch.from_numpy(dense)
    for slots in sorted({n_slots, max(n_slots - 1, 1), n_cb}):
        for jfn, tfn in ((jspmm.dense_to_block_ell,
                          tspmm.dense_to_block_ell),
                         (jspmm.dense_to_block_ell_ranked,
                          tspmm.dense_to_block_ell_ranked)):
            jt, jc = jfn(jd, bm, bn, slots)
            tt, tc = tfn(td, bm, bn, slots)
            assert tc.dtype == torch.int32
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            np.testing.assert_array_equal(
                tspmm.ell_to_dense(tt, tc, n_cb * bn).numpy(),
                np.asarray(jspmm.ell_to_dense(jt, jc, n_cb * bn)))
    assert float(tspmm.block_density(td, bm, bn)) == \
        float(jspmm.block_density(jd, bm, bn))


def test_spmm_ell_bf16_matches_pallas():
    """bf16 tiles and x, f32 accumulation, bf16 out: 5e-2, the reference's
    bf16 tolerance."""
    dense, _, x = _case(16, 16, 2, 2, 32, 0.8, seed=1)
    tiles, colidx = jops.dense_to_block_ell(jnp.asarray(dense), 16, 16, 2)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jops.spmm_ell(tiles.astype(jnp.bfloat16), colidx, jx),
                     np.float32)
    tt = _t(tiles).to(torch.bfloat16)
    got = tspmm.spmm_ell(tt, _t(colidx),
                         torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=5e-2,
                               rtol=5e-2)


@pytest.mark.parametrize("density", [0.4, 0.7])
def test_spmm_ell_autograd_matches_jax_grad(density):
    """dX = A^T g and dTiles = g_rb @ x_cb^T against ``jax.grad`` through
    the reference's custom VJP, with as many slots as column blocks, so
    sparser row-blocks carry padding slots: atol 1e-4."""
    dense, _, x = _case(8, 8, 3, 4, 12, density, seed=2)
    tiles, colidx = jops.dense_to_block_ell(jnp.asarray(dense), 8, 8, 4)
    assert int((np.asarray(colidx) == 0).sum()) > 3       # padding present
    w = np.random.default_rng(5).normal(size=(24, 12)).astype(np.float32)

    def jloss(t, xx):
        return jnp.sum(jops.spmm_ell(t, colidx, xx) * w)

    jdt, jdx = jax.grad(jloss, argnums=(0, 1))(tiles, jnp.asarray(x))
    tt = _t(tiles).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tops.spmm_ell(tt, _t(colidx), tx)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-4)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jdt), atol=1e-4)
    # training never asks for dTiles: only dX is computed then
    tx.grad = None
    out = tops.spmm_ell(tt.detach(), _t(colidx),
                        tx)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-4)


@pytest.mark.parametrize("has_mask", [False, True])
@pytest.mark.parametrize("has_res", [False, True])
@pytest.mark.parametrize("use_rmsnorm", [False, True])
def test_fused_tail_autograd_matches_jax_grad(has_mask, has_res,
                                              use_rmsnorm):
    """dx, d_scale and d_res against ``jax.grad`` of the reference's
    ``fused_layer_tail`` (Pallas forward, jnp backward): atol 1e-5."""
    rng = np.random.default_rng(7)
    b, d = 32, 24
    x = rng.normal(size=(b, d)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    res = rng.normal(size=(b, d)).astype(np.float32)
    mask = rng.random((b, d)) < 0.7
    w = rng.normal(size=(b, d)).astype(np.float32)
    kw = dict(dropout_rate=0.3, eps=1e-6, use_rmsnorm=use_rmsnorm,
              use_relu=True)

    def jloss(xx, ss, rr):
        y = jops.fused_layer_tail(
            xx, rr if has_res else None, ss,
            dropout_mask=jnp.asarray(mask) if has_mask else None,
            row_tile=b, **kw)
        return jnp.sum(y * w)

    jdx, jds, jdr = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(res))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tr = torch.from_numpy(res).requires_grad_(True)
    y = tops.fused_layer_tail(
        tx, tr if has_res else None, ts,
        dropout_mask=torch.from_numpy(mask) if has_mask else None, **kw)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds), atol=1e-5)
    if has_res:
        np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jdr),
                                   atol=1e-5)
    else:
        assert tr.grad is None
    if not use_rmsnorm:
        assert not ts.grad.any()


def test_spmm_ell_on_cpu_counts_no_launch_and_rejects_meta():
    dense, n_slots, x = _case(8, 8, 2, 2, 4, 0.7)
    tt, tc = tspmm.dense_to_block_ell(torch.from_numpy(dense), 8, 8, n_slots)
    n0 = tspmm.LAUNCHES
    tspmm.spmm_ell(tt, tc, torch.from_numpy(x))
    assert tspmm.LAUNCHES == n0
    # the meta route: the output's shape and type, no launch; a tensor on
    # another device than x's is rejected
    out = tspmm.spmm_ell(tt.to("meta"), tc.to("meta"),
                         torch.from_numpy(x).to("meta"))
    assert out.device.type == "meta" and out.shape == (dense.shape[0],
                                                       x.shape[1])
    assert tspmm.LAUNCHES == n0
    with pytest.raises(ValueError, match="on meta"):
        tspmm.spmm_ell(tt.to("meta"), tc, torch.from_numpy(x).to("meta"))
