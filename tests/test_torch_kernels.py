"""The port's attention kernels against the JAX reference.

On the CPU, ``repro_torch.kernels.ops`` takes the kernels' plain versions
(``repro_torch.kernels.ref``); these tests hold them against the
reference's oracles (``repro.kernels.ref``) and against the Pallas kernels
run as the reference's own tests run them (``interpret=True``), on the
parameter grids of ``tests/test_kernels.py``, at fp32 2e-5 and bf16
2e-2 (prefill) / 3e-2 (decode). The CUDA kernels themselves are held
against the plain versions on the card, in ``tests/test_torch_cuda.py``
(``cuda`` marker) and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro_torch.kernels import chacha20 as cc
from repro_torch.kernels import decode_attention as fd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_step as m2
from repro_torch.kernels import ops

TOLS = {"flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
        "flash_decode": {"float32": 2e-5, "bfloat16": 3e-2}}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same fp32 numpy values as a JAX and a torch tensor of dtype."""
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(a).to(TDT[dtype]))


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _qkv(seed, B, H, KVH, S, D, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, D), (B, KVH, S, D), (B, KVH, S, D))]
    return [_pair(a, dtype) for a in arrs]


# ------------------------------------------------------ flash attention


@pytest.mark.parametrize("B,H,KVH,S,D,dtype", [
    (1, 2, 2, 128, 32, "float32"),
    (2, 4, 2, 256, 64, "float32"),
    (1, 8, 2, 128, 64, "bfloat16"),
    (2, 2, 1, 512, 16, "float32"),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_reference(B, H, KVH, S, D, dtype,
                                                 causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(0, B, H, KVH, S, D, dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == TDT[dtype] and got.shape == (B, H, S, D)
    tol = TOLS["flash_attention"][dtype]
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal), tol)
    _close(got, pallas_attention(jq, jk, jv, causal=causal, block_q=64,
                                 block_k=64), tol)


@pytest.mark.parametrize("S,D,G,causal", [
    (64, 16, 1, True), (128, 32, 2, False), (192, 64, 4, True),
    (64, 64, 4, False), (192, 16, 2, True), (128, 32, 1, True),
])
def test_flash_attention_plain_gqa_grid(S, D, G, causal):
    KVH = 2
    (jq, tq), (jk, tk), (jv, tv) = _qkv(S * D * G, 1, KVH * G, KVH, S, D,
                                        "float32")
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    _close(got, pallas_attention(jq, jk, jv, causal=causal, block_q=64,
                                 block_k=64), 2e-5)


@pytest.mark.parametrize("S", [1, 37, 100])
def test_flash_attention_plain_ragged_strided(S):
    """Any S (no block multiple) and the model's transpose views of
    [B,S,H,D] tensors; the reference oracle takes any S."""
    rng = np.random.default_rng(S)
    B, H, KVH, D = 2, 4, 2, 32
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True)
    want = jref.attention_ref(*(jnp.asarray(a).swapaxes(1, 2)
                                for a in (q, k, v)), causal=True)
    _close(got, want, 2e-5)


# --------------------------------------------------------- flash decode


def _decode_inputs(seed, B, H, KVH, S, D, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    return _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)


@pytest.mark.parametrize("B,H,KVH,S,D,dtype", [
    (2, 4, 2, 256, 64, "float32"),
    (1, 8, 4, 1024, 32, "float32"),
    (3, 2, 2, 512, 64, "bfloat16"),
])
def test_flash_decode_plain_matches_reference(B, H, KVH, S, D, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _decode_inputs(1, B, H, KVH, S, D, dtype)
    lengths = np.asarray(([S // 2, S, 7] + [S] * B)[:B], np.int32)
    got = ops.flash_decode(tq, tk, tv, torch.from_numpy(lengths))
    assert got.dtype == TDT[dtype] and got.shape == (B, H, D)
    tol = TOLS["flash_decode"][dtype]
    jl = jnp.asarray(lengths)
    _close(got, jref.decode_attention_ref(jq, jk, jv, jl), tol)
    _close(got, pallas_decode(jq, jk, jv, jl, block_k=128), tol)


@pytest.mark.parametrize("B,S,D,length", [
    (1, 128, 32, 1), (2, 256, 64, 300), (3, 128, 64, 77), (2, 256, 32, 129),
])
def test_flash_decode_plain_lengths_grid(B, S, D, length):
    length = min(length, S)
    (jq, tq), (jk, tk), (jv, tv) = _decode_inputs(B * S + D + length, B, 4,
                                                  2, S, D, "float32")
    lengths = np.full((B,), length, np.int32)
    got = ops.flash_decode(tq, tk, tv, torch.from_numpy(lengths))
    _close(got, pallas_decode(jq, jk, jv, jnp.asarray(lengths), block_k=64),
           2e-5)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_decode_plain_cache_view_ragged(G):
    """The model cache [B,Smax,KVH,D] as a permute view, ragged lengths,
    GQA group G; S is no block multiple (the reference oracle takes it)."""
    rng = np.random.default_rng(40 + G)
    B, Smax, KVH, D = 4, 75, 2, 32
    q = rng.standard_normal((B, KVH * G, D)).astype(np.float32)
    kc = rng.standard_normal((B, Smax, KVH, D)).astype(np.float32)
    vc = rng.standard_normal((B, Smax, KVH, D)).astype(np.float32)
    lengths = np.array([1, 30, 64, 75], np.int32)
    got = ops.flash_decode(torch.from_numpy(q),
                           torch.from_numpy(kc).permute(0, 2, 1, 3),
                           torch.from_numpy(vc).permute(0, 2, 1, 3),
                           torch.from_numpy(lengths))
    want = jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc).swapaxes(1, 2),
        jnp.asarray(vc).swapaxes(1, 2), jnp.asarray(lengths))
    _close(got, want, 2e-5)


# ------------------------------------------------ head dims 80 and 160


@pytest.mark.parametrize("D,G", [(80, 1), (80, 2), (160, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_at_head_dims_80_and_160(D, G, dtype):
    """Both plain versions at zamba2-2.7b's shared-block head dim (80, G 1)
    and stablelm-12b's (160, G 4), against the reference's oracles and
    the Pallas kernels in interpret mode: causal and full prefill, and
    decode at ragged lengths; scores scaled by 1/sqrt(D)."""
    KVH, S = 2, 96
    (jq, tq), (jk, tk), (jv, tv) = _qkv(D + G, 1, KVH * G, KVH, S, D, dtype)
    tol = TOLS["flash_attention"][dtype]
    for causal in (True, False):
        got = ops.flash_attention(tq, tk, tv, causal=causal)
        assert got.shape == (1, KVH * G, S, D)
        _close(got, jref.attention_ref(jq, jk, jv, causal=causal), tol)
        _close(got, pallas_attention(jq, jk, jv, causal=causal, block_q=32,
                                     block_k=32), tol)
    (jq, tq), (jk, tk), (jv, tv) = _decode_inputs(D * G, 3, KVH * G, KVH,
                                                  S, D, dtype)
    lengths = np.array([1, 50, 96], np.int32)
    got = ops.flash_decode(tq, tk, tv, torch.from_numpy(lengths))
    tol = TOLS["flash_decode"][dtype]
    jl = jnp.asarray(lengths)
    _close(got, jref.decode_attention_ref(jq, jk, jv, jl), tol)
    _close(got, pallas_decode(jq, jk, jv, jl, block_k=32), tol)


@pytest.mark.parametrize("D", [80, 160])
def test_kernel_wrappers_take_head_dims_80_and_160(D):
    """Both CUDA wrappers accept 80 and 160 as head dims: a CPU tensor
    passes the head-dim check and is refused for its device; 96 is still
    outside ``flash_attention``'s domain (``flash_decode`` checks the
    device first)."""
    from repro_torch.kernels import build
    assert D in build.HEAD_DIMS and (D, D) in build.ATTENTION_DIMS
    q = torch.zeros((1, 2, 8, D))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fd.flash_decode(q[:, :, 0], q, q, torch.full((1,), 8))
    q96 = torch.zeros((1, 2, 8, 96))
    with pytest.raises(ValueError, match=r"head dims \(q/k 96, v 96\)"):
        fa.flash_attention(q96, q96, q96)


@pytest.mark.parametrize("B,H,KVH,Sq,Skv,D,dtype", [
    (1, 4, 4, 12, 24, 16, "float32"),       # whisper reduced: tokens x frames
    (2, 8, 2, 33, 100, 64, "float32"),
    (1, 4, 1, 100, 33, 32, "float32"),
    (1, 4, 4, 64, 150, 64, "bfloat16"),
])
def test_flash_attention_plain_cross_matches_reference(B, H, KVH, Sq, Skv, D,
                                                       dtype):
    """The plain version at Sq != Skv, not causal (whisper's
    cross-attention), against the reference model's
    ``chunked_attention(causal=False)`` (its ``[B, S, H, D]`` layout, its
    chunking of the queries and of the keys)."""
    from repro.models.layers import chunked_attention
    rng = np.random.default_rng(Sq * Skv)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.standard_normal(s).astype(
        np.float32), dtype) for s in ((B, H, Sq, D), (B, KVH, Skv, D),
                                      (B, KVH, Skv, D)))
    got = ops.flash_attention(tq, tk, tv, causal=False)
    assert tuple(got.shape) == (B, H, Sq, D)
    want = chunked_attention(*(a.swapaxes(1, 2) for a in (jq, jk, jv)),
                             causal=False, chunk_q=32, chunk_kv=32,
                             compute_dtype=JDT[dtype])
    _close(got, want.swapaxes(1, 2), TOLS["flash_attention"][dtype])


def test_causal_attention_at_unequal_lengths_is_refused():
    """Causal attention is defined for aligned positions only: the CUDA
    wrapper and the dispatcher refuse Sq != Skv with ``causal``, on every
    device; not causal, the dispatcher takes it."""
    q, kv = torch.zeros((1, 2, 8, 16)), torch.zeros((1, 2, 24, 16))
    for fn in (fa.flash_attention, ops.flash_attention):
        with pytest.raises(ValueError, match="causal attention needs Sq == "
                                             "Skv"):
            fn(q, kv, kv, causal=True)
    assert tuple(ops.flash_attention(q, kv, kv, causal=False).shape) == \
        (1, 2, 8, 16)
    with pytest.raises(ValueError, match="do not match q"):
        fa.flash_attention(q, kv, kv[:, :, :5], causal=False)


# ------------------------------------------------------------- dispatch


NO_LAUNCHES = {"flash_attention": 0, "flash_decode": 0, "chacha20": 0,
               "mamba2_step": 0}


def test_cpu_dispatch_launches_no_kernel():
    ops.reset_launch_counts()
    (_, tq), (_, tk), (_, tv) = _qkv(3, 1, 2, 1, 16, 16, "float32")
    ops.flash_attention(tq, tk, tv)
    ops.flash_decode(tq[:, :, 0], tk, tv, torch.tensor([5], dtype=torch.int32))
    ops.chacha20_keystream(torch.zeros(8, dtype=torch.uint32),
                           torch.zeros(3, dtype=torch.uint32), 1, 4)
    zx, conv, h, p = _mamba2_operands()
    ops.mamba2_step(zx, conv, h, p, 1e-5)
    assert ops.launch_counts() == NO_LAUNCHES


def _mamba2_operands(B=2, nh=4, hd=8, N=16, K=4):
    """A Mamba2 step's operands (one group), on the CPU."""
    cc = nh * hd + 2 * N
    p = {"conv_w": torch.randn(K, cc), "conv_b": torch.zeros(cc),
         "dt_bias": torch.zeros(nh), "A_log": torch.zeros(nh),
         "D": torch.ones(nh), "out_norm": torch.ones(nh * hd)}
    return (torch.randn(B, 2 * nh * hd + 2 * N + nh),
            torch.zeros(B, K - 1, cc), torch.zeros(B, nh, hd, N), p)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: a CPU tensor is an error."""
    (_, tq), (_, tk), (_, tv) = _qkv(4, 1, 2, 1, 16, 16, "float32")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention(tq, tk, tv)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fd.flash_decode(tq[:, :, 0], tk, tv,
                        torch.tensor([5], dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cc.keystream(torch.zeros(8, dtype=torch.uint32),
                     torch.zeros(3, dtype=torch.uint32), 1, 4)
    zx, conv, h, p = _mamba2_operands()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        m2.mamba2_step(zx, conv, h, *p.values(), 1e-5)
    assert ops.launch_counts() == NO_LAUNCHES


def test_ablation_markers_match_the_kernel():
    """``python -m repro_torch.kernels.ablate`` finds each part of the bf16
    kernel it takes out by its source text; every variant still applies."""
    from repro_torch.kernels import ablate
    for name, edits in ablate.VARIANTS.items():
        src = ablate.variant_source(edits)
        assert (src == (ablate.build.CSRC / "flash_attention.cu").read_text()
                ) == (not edits), name
