"""The registered backward of ``flash_attention`` (``kernels.library``,
math in ``kernels.attention_grad``) against ``jax.grad`` of the reference's
``chunked_attention`` and ``full_attention``.

On the CPU the op's forward is the kernel's plain version and its backward
is the registered one, so autograd through ``attention.attention`` (the
model's call, transpose views and all) runs exactly what training runs on
the card, the kernel's forward aside. Inputs come from a numpy seed;
gradients of ``sum(out * cotangent)`` agree at 1e-5 in fp32 over causal
self-attention and cross-attention (Sq != Skv, no mask), GQA groups 1 and
4, and head dims 16, 64, 80 and MLA's (192, 128)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import ops, ref
from repro_torch.kernels.attention_grad import attention_grad
from repro_torch.models.attention import attention

TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = [(16, 16), (64, 64), (80, 80), (192, 128)]


def _inputs(B, Sq, Skv, H, KVH, D, Dv, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, Sq, H, D), f(B, Skv, KVH, D), f(B, Skv, KVH, Dv),
            f(B, Sq, H * Dv))


def _jax_grads(which, q, k, v, ct, causal):
    def fn(q, k, v):
        if which == "chunked":
            o = jlayers.chunked_attention(q, k, v, causal=causal, chunk_q=8,
                                          chunk_kv=8,
                                          compute_dtype=jnp.float32)
        else:
            o = jlayers.full_attention(q, k, v, causal=causal,
                                       compute_dtype=jnp.float32)
        return jnp.sum(o.reshape(*o.shape[:2], -1) * ct)

    return jax.grad(fn, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _port_grads(q, k, v, ct, causal):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention(q, k, v, causal)
    return torch.autograd.grad((out * torch.from_numpy(ct)).sum(), (q, k, v))


@pytest.mark.parametrize("which", ["chunked", "full"])
@pytest.mark.parametrize("mode", ["causal", "cross"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("D,Dv", DIMS, ids=[f"D{d}-{v}" for d, v in DIMS])
def test_backward_matches_jax_grad(which, mode, G, D, Dv):
    causal = mode == "causal"
    Sq, Skv = (24, 24) if causal else (9, 31)
    q, k, v, ct = _inputs(2, Sq, Skv, 2 * G, 2, D, Dv)
    want = _jax_grads(which, q, k, v, ct, causal)
    got = _port_grads(q, k, v, ct, causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,Sq", [(True, 9), (False, 5)])
def test_backward_gradcheck_float64(causal, Sq):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, Sq, 8, generator=gen, dtype=torch.float64)
    k, v = (torch.randn(1, 2, 9, 8, generator=gen, dtype=torch.float64)
            for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=causal),
        tuple(t.requires_grad_() for t in (q, k, v)))


@pytest.mark.parametrize("causal", [True, False])
def test_query_blocks_that_do_not_divide_the_sequence(causal):
    """Blocks of 5 queries over 23 (the last block ragged, causal blocks
    cut at their last visible key) against autograd through the plain
    forward, and against one block holding every query."""
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(2, 4, 23, 16, generator=gen)
    k, v = (torch.randn(2, 1, 23, 16, generator=gen) for _ in range(2))
    do = torch.randn(2, 4, 23, 16, generator=gen)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*leaves, causal=causal),
                               leaves, do)
    for block in (5, 128):
        got = attention_grad(q, k, v, do, causal=causal, block=block)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)


def test_backward_takes_strided_inputs_and_keeps_dtypes():
    """Transpose views in bf16, as the model passes them: grads come back
    in bf16 with the inputs' shapes, equal to the fp32 math rounded."""
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 12, h, 16, generator=gen).to(torch.bfloat16)
               .transpose(1, 2) for h in (4, 2, 2))
    do = torch.randn(2, 4, 12, 16, generator=gen).to(torch.bfloat16)
    got = attention_grad(q, k, v, do, causal=True)
    want = attention_grad(*(t.float() for t in (q, k, v, do)), causal=True)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        torch.testing.assert_close(g, w.to(torch.bfloat16), rtol=0, atol=0)
