"""The port's flash-attention module against the JAX package's.

On the CPU the wrapper runs the kernel's plain version (the dense masked
softmax in float32, plus the lse), held here against the Pallas kernel in
interpret mode (``tests/test_kernels_flash.py``'s own setting) and the
reference's dense oracle on the same numpy inputs. The CUDA kernel itself
is held against the plain version on a card by
``test_torch_cuda_kernels.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops, ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# tests/test_kernels_flash.py's sweep: (sq, t, h, kv, hd, causal, window)
SWEEP = [
    (64, 64, 4, 2, 32, True, None),
    (32, 96, 4, 4, 16, False, None),      # cross-attention shape
    (128, 128, 8, 2, 16, True, 32),       # sliding window
    (64, 100, 2, 1, 32, False, None),     # KV padding path
    (256, 256, 2, 2, 64, True, None),     # MHA, multiple q tiles
]


def _case(sq, t, h, kv, hd, b=2, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return mk(b, sq, h, hd), mk(b, t, kv, hd), mk(b, t, kv, hd)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _pallas(q, k, v, causal, window):
    return flash_attention_pallas(q, k, v, causal=causal, window=window,
                                  interpret=True)


@pytest.mark.parametrize("sq,t,h,kv,hd,causal,window", SWEEP)
def test_plain_matches_pallas_kernel_and_oracle(sq, t, h, kv, hd, causal,
                                                window):
    """out within 1e-5 of ``ops.flash_attention`` (the Pallas kernel) and
    of the dense oracle; lse within 1e-5 of the Pallas kernel's."""
    q, k, v = _case(sq, t, h, kv, hd)
    out, lse = tflash.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, window)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ops.flash_attention(jq, jk, jv, causal,
                                                    window)), atol=1e-5)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref.flash_attention_ref(
            jq, jk, jv, causal=causal, window=window)), atol=1e-5)
    _, jlse = _pallas(jq, jk, jv, causal, window)
    assert lse.shape == jlse.shape == (2, h, sq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5)


def test_plain_bf16_matches_pallas_kernel():
    """bf16 inputs, output in bf16: 5e-2, the reference's bf16 tolerance
    (the Pallas kernel rounds p to bf16 before p @ v, the plain version
    does not)."""
    q, k, v = _case(64, 64, 4, 2, 16, b=1, seed=1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    expect = np.asarray(ops.flash_attention(jq, jk, jv, True, None),
                        np.float32)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out, lse = tflash.flash_attention_plain(tq, tk, tv, True, None)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), expect, atol=5e-2,
                               rtol=5e-2)


def test_cpu_wrappers_return_the_plain_result():
    """On CPU tensors the kernel wrapper and the public op take the plain
    version, and count no launch."""
    q, k, v = (torch.from_numpy(a) for a in _case(40, 70, 4, 2, 32))
    n0 = tflash.LAUNCHES
    out, lse = tflash.flash_attention(q, k, v, False, 16)
    plain_out, plain_lse = tflash.flash_attention_plain(q, k, v, False, 16)
    assert torch.equal(out, plain_out) and torch.equal(lse, plain_lse)
    assert torch.equal(tops.flash_attention(q, k, v, False, 16), plain_out)
    assert tflash.LAUNCHES == n0


def test_row_with_no_key_gives_zeros_as_the_kernel_does():
    """A query row that sees no key (its window ends before T starts)
    gives out 0 and lse log(1e-20), as ``_flash_kernel`` computes it."""
    q, k, v = (torch.from_numpy(a) for a in _case(8, 4, 2, 1, 16, b=1))
    out, lse = tflash.flash_attention_plain(q, k, v, True, 2)
    assert torch.all(out[0, 6:] == 0)
    torch.testing.assert_close(lse[0, :, 6:],
                               torch.full((2, 2), float(np.log(1e-20))))
    assert torch.all(torch.isfinite(out))


def test_cpu_autograd_gives_the_plain_backward():
    """``ops.flash_attention`` on CPU tensors that require grad: the
    gradients are the plain backward's on the saved (out, lse), with or
    without ``plain``, and no kernel launch is counted."""
    q, k, v = (torch.from_numpy(a) for a in _case(40, 70, 4, 2, 32))
    dout = torch.from_numpy(np.random.default_rng(5).normal(
        size=q.shape).astype(np.float32))
    out, lse = tflash.flash_attention_plain(q, k, v, False, 16)
    want = tflash.flash_attention_bwd_plain(q, k, v, out, lse, dout, False,
                                            16)
    n0 = (tflash.LAUNCHES, tflash.BWD_LAUNCHES)
    for plain in (False, True):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        got = tops.flash_attention(*leaves, False, 16, plain=plain)
        assert torch.equal(got.detach(), out)
        got.backward(dout)
        for x, w in zip(leaves, want):
            assert torch.equal(x.grad, w)
    assert (tflash.LAUNCHES, tflash.BWD_LAUNCHES) == n0
