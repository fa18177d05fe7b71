"""Parity of the port's layers (repro_torch.models.layers) with the JAX
reference (repro.models.layers): the same numpy inputs through both, in
fp32, at atol = rtol = 1e-5; ``unembed`` also in bf16 compute."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 32, scale=3.0)
    p = {"scale": _rand(rng, 32)}
    if norm == "layernorm":
        p["bias"] = _rand(rng, 32)
    want = jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), norm)
    got = tl.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), norm)
    _close(got, want)


def test_rmsnorm():
    rng = np.random.default_rng(1)
    x, s = _rand(rng, 2, 3, 4, 16), _rand(rng, 16)
    _close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)),
           jl.rmsnorm(jnp.asarray(x), jnp.asarray(s)))


@pytest.mark.parametrize("pos_shape", ["bs", "s"])
def test_apply_rope(pos_shape):
    rng = np.random.default_rng(2)
    B, S, H, D = 2, 7, 3, 16
    x = _rand(rng, B, S, H, D)
    pos = rng.integers(0, 500, size=(B, S) if pos_shape == "bs" else (S,))
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 10_000.0)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    _close(got, want)


def test_rope_freqs():
    _close(tl.rope_freqs(64, 1e6), jl.rope_freqs(64, 1e6))


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", False),
                                     ("gelu", True)])
def test_mlp(act, glu):
    rng = np.random.default_rng(3)
    d, ff = 16, 40
    x = _rand(rng, 2, 3, d)
    p = {"up": {"w": _rand(rng, d, ff, scale=0.3)},
         "down": {"w": _rand(rng, ff, d, scale=0.3)}}
    if glu:
        p["gate"] = {"w": _rand(rng, d, ff, scale=0.3)}
    jp = {k: {"w": jnp.asarray(v["w"])} for k, v in p.items()}
    tp = {k: {"w": torch.from_numpy(v["w"])} for k, v in p.items()}
    want = jl.mlp(jp, jnp.asarray(x), act, glu, jnp.float32)
    got = tl.mlp(tp, torch.from_numpy(x), act, glu, torch.float32)
    _close(got, want)


def test_dense_with_bias():
    rng = np.random.default_rng(4)
    x, w, b = _rand(rng, 3, 8), _rand(rng, 8, 5), _rand(rng, 5)
    want = jl.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                    jnp.asarray(x), jnp.float32)
    got = tl.dense({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                   torch.from_numpy(x), torch.float32)
    _close(got, want)


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_full_attention(G, causal):
    rng = np.random.default_rng(5 + G)
    B, S, KVH, D = 2, 12, 2, 16
    q = _rand(rng, B, S, KVH * G, D)
    k, v = _rand(rng, B, S, KVH, D), _rand(rng, B, S, KVH, D)
    want = jl.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, compute_dtype=jnp.float32)
    got = tl.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal,
                            compute_dtype=torch.float32)
    _close(got, want)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_attention(G):
    rng = np.random.default_rng(9 + G)
    B, Smax, KVH, D = 3, 20, 2, 16
    q = _rand(rng, B, 1, KVH * G, D)
    kc, vc = _rand(rng, B, Smax, KVH, D), _rand(rng, B, Smax, KVH, D)
    lengths = np.array([1, 13, 20], np.int32)
    want = jl.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(lengths),
                               compute_dtype=jnp.float32)
    got = tl.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.from_numpy(lengths),
                              compute_dtype=torch.float32)
    _close(got, want)


def test_unembed_fp32_logits():
    rng = np.random.default_rng(13)
    x, w = _rand(rng, 2, 3, 16), _rand(rng, 50, 16)
    want = jl.unembed(jnp.asarray(x), jnp.asarray(w), jnp.float32)
    got = tl.unembed(torch.from_numpy(x), torch.from_numpy(w), torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 50)
    _close(got, want)


def test_unembed_bf16_keeps_fp32_logits():
    """bf16 operands, fp32 logits: at logits of 10-30 the bf16 step is
    0.06-0.125, so a port that rounded its logits to bf16 would miss the
    reference by far more than this tolerance."""
    rng = np.random.default_rng(14)
    d, V = 256, 300
    x, w = _rand(rng, 2, 3, d), _rand(rng, V, d, scale=1.2)
    want = np.asarray(jl.unembed(jnp.asarray(x), jnp.asarray(w),
                                 jnp.bfloat16))
    got = tl.unembed(torch.from_numpy(x), torch.from_numpy(w),
                     torch.bfloat16)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.abs(want).max() > 10.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    rounded = got.to(torch.bfloat16).float().numpy()
    assert np.abs(rounded - want).max() > 1e-2
