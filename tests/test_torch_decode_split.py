"""The split-KV decode design against the JAX reference, on the CPU.

``csrc/flash_decode.cu`` cuts the cache axis into chunks
(``kernels.decode_attention.plan_splits``), computes a partial softmax
state per chunk and merges them. ``kernels.ref.decode_attention_split_ref``
repeats that arithmetic in plain PyTorch; these tests hold it, at the
planner's splits and at forced small chunks, against the reference's
oracle (``repro.kernels.ref.decode_attention_ref``) and the Pallas
``flash_decode`` run in interpret mode, at fp32 2e-5, with numpy-seeded
inputs: lengths at chunk edges, chunks past the length, GQA groups 1, 4
and 16. A length of 0 gives 0 (the reference averages V instead: the
known, deliberate difference). The kernel itself is held against the
plain versions on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode as pallas_decode
from repro_torch.kernels import decode_attention as fd
from repro_torch.kernels import ref

H100_SMS = 132


def _inputs(seed, B, G, KVH, S, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, KVH * G, D)).astype(np.float32),
            rng.standard_normal((B, KVH, S, D)).astype(np.float32),
            rng.standard_normal((B, KVH, S, D)).astype(np.float32))


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------ the planner


@pytest.mark.parametrize("B,KVH", [(1, 1), (1, 4), (1, 16), (2, 8), (4, 4),
                                   (8, 16), (64, 8), (3, 5)])
@pytest.mark.parametrize("S", [1, 33, 64, 65, 77, 500, 576, 630, 1024, 8192])
def test_plan_splits_invariants(B, KVH, S):
    splits, chunk = fd.plan_splits(B, KVH, S, H100_SMS)
    assert chunk % fd.SPLIT_ALIGN == 0 and chunk > 0
    assert splits * chunk >= S > (splits - 1) * chunk or (S <= chunk
                                                         and splits == 1)
    if splits > 1:
        assert chunk >= fd.MIN_CHUNK
    if S >= fd.MIN_CHUNK * H100_SMS / (B * KVH):
        assert B * KVH * splits >= H100_SMS


def test_plan_splits_serve_shape():
    """qwen1.5-0.5b decode: B1, 16 KV heads, a 576-position cache: 9
    chunks of 64 positions, 144 blocks on 132 SMs; a batch that fills the
    card alone is not cut."""
    assert fd.plan_splits(1, 16, 576, H100_SMS) == (9, 64)
    assert fd.plan_splits(64, 8, 576, H100_SMS) == (1, 576)


# ------------------------------------------ split-and-merge vs reference


@pytest.mark.parametrize("G", [1, 4, 16])
@pytest.mark.parametrize("lengths", [(1, 63, 64, 65), (192, 130, 2, 128)])
def test_split_ref_matches_reference_at_chunk_edges(G, lengths):
    """Chunks of 64 over a 192-position cache: lengths 1, 63, 64, 65 and
    S, so chunks that are full, cut, or wholly past the length."""
    B, KVH, S, D = len(lengths), 2, 192, 32
    q, k, v = _inputs(G * sum(lengths), B, G, KVH, S, D)
    lens = np.asarray(lengths, np.int32)
    got = ref.decode_attention_split_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), chunk=64)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(lens))
    _close(got, jref.decode_attention_ref(*jargs))
    _close(got, pallas_decode(*jargs, block_k=64))


@pytest.mark.parametrize("B,G,KVH,S,D", [
    (1, 1, 16, 576, 64),     # qwen1.5-0.5b decode: 9 chunks of 64
    (4, 12, 4, 576, 128),    # a GQA group of 12: 9 chunks
    (1, 1, 8, 1024, 64),     # calibration's decode timeline: 16 chunks
])
def test_split_ref_matches_reference_at_planned_splits(B, G, KVH, S, D):
    q, k, v = _inputs(S + G, B, G, KVH, S, D)
    lens = np.asarray([S - 63, 1, 300, S][:B], np.int32)
    _, chunk = fd.plan_splits(B, KVH, S, H100_SMS)
    got = ref.decode_attention_split_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), chunk=chunk)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(lens))
    _close(got, jref.decode_attention_ref(*jargs))
    _close(got, pallas_decode(*jargs, block_k=64))


def test_split_ref_length_zero_gives_zero():
    """Every chunk empty: the merge's numerator and denominator are 0 and
    the output is 0; a row with a length beside it is unaffected."""
    q, k, v = _inputs(7, 2, 4, 2, 128, 16)
    lens = np.asarray([0, 100], np.int32)
    got = ref.decode_attention_split_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), chunk=64)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lens))
    _close(got[1], np.asarray(want)[1])


def test_split_ref_matches_plain_version_on_cache_view():
    """The model's cache [B, Smax, KVH, D] as a permute view, S no chunk
    multiple, against the unsplit plain version."""
    rng = np.random.default_rng(11)
    B, Smax, KVH, G, D = 3, 77, 2, 4, 16
    q = torch.from_numpy(rng.standard_normal((B, KVH * G, D))
                         .astype(np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((B, Smax, KVH, D))
                               .astype(np.float32)).permute(0, 2, 1, 3)
              for _ in range(2))
    lens = torch.tensor([77, 64, 13], dtype=torch.int32)
    got = ref.decode_attention_split_ref(q, kc, vc, lens, chunk=32)
    torch.testing.assert_close(got, ref.decode_attention_ref(q, kc, vc, lens),
                               rtol=2e-5, atol=2e-5)
