"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU and the CUDA toolkit (marker ``cuda``); without a GPU
each test skips. This file imports no JAX, so it also runs on a machine
with the card and no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import ops, ref

TOLS = {"flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
        "flash_decode": {"float32": 2e-5, "bfloat16": 3e-2}}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = TDT[dtype]
    for B, H, KVH, S, D in [(2, 8, 2, 100, 64), (1, 4, 4, 33, 128),
                            (2, 4, 1, 64, 16)]:
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda")
                   .to(dt).transpose(1, 2) for h in (H, KVH, KVH))
        for causal in (True, False):
            got = ops.flash_attention(q, k, v, causal=causal)
            want = ref.attention_ref(q, k, v, causal=causal)
            tol = TOLS["flash_attention"][dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
        kc = torch.randn(B, S + 7, KVH, D, generator=gen, device="cuda").to(dt)
        lengths = torch.randint(1, S + 8, (B,), generator=gen, device="cuda",
                                dtype=torch.int32)
        args = (q[:, :, 0], kc.permute(0, 2, 1, 3), kc.permute(0, 2, 1, 3),
                lengths)
        tol = TOLS["flash_decode"][dtype]
        torch.testing.assert_close(ops.flash_decode(*args).float(),
                                   ref.decode_attention_ref(*args).float(),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_chacha20_matches_plain_bit_exact():
    """Bit-exact against the plain version, across the 2^32 counter wrap
    and at block counts that are no multiple of the 256-thread block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    key, nonce = (torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                                generator=gen, device="cuda")
                  .view(torch.uint32) for n in (8, 3))
    for counter0, n_blocks in [(0, 1), (1, 256), (2**32 - 3, 1000),
                               (12345, 4097)]:
        got = ops.chacha20_keystream(key, nonce, counter0, n_blocks)
        want = ref.chacha20_keystream_ref(key, nonce, counter0, n_blocks)
        assert got.shape == (n_blocks, 16) and got.dtype == torch.uint32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4, 16])
def test_cuda_decode_split_edges(dtype, G):
    """Split-KV decode at chunk edges: lengths 1, 63, 64, 65 and S over a
    cache the planner cuts into 64-position chunks, chunks wholly past the
    length (which read nothing), and a length of 0, which gives 0."""
    from repro_torch.kernels import decode_attention as fd
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(G)
    dt, KVH, S, D = TDT[dtype], 2, 576, 64
    splits, chunk = fd.plan_splits(5, KVH, S, fd.sm_count(0))
    assert splits > 1 and chunk == 64
    q = torch.randn(5, KVH * G, D, generator=gen, device="cuda").to(dt)
    kc, vc = (torch.randn(5, S, KVH, D, generator=gen, device="cuda").to(dt)
              .permute(0, 2, 1, 3) for _ in range(2))
    tol = TOLS["flash_decode"][dtype]
    for lens in ([1, 63, 64, 65, S], [0, 128, 0, 129, 2]):
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = ops.flash_decode(q, kc, vc, lengths).float()
        want = ref.decode_attention_ref(q, kc, vc, lengths).float()
        split = ref.decode_attention_split_ref(q, kc, vc, lengths,
                                               chunk=chunk).float()
        for b, n in enumerate(lens):
            if n == 0:
                assert torch.equal(got[b], torch.zeros_like(got[b]))
            else:
                torch.testing.assert_close(got[b], want[b], rtol=tol,
                                           atol=tol)
        torch.testing.assert_close(got, split, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [33, 77, 500, 8192])
@pytest.mark.parametrize("D", [16, 128])
def test_cuda_attention_kernels_gqa12(dtype, S, D):
    """Both kernels at a GQA group of 12 (one KV head, twelve query heads),
    ragged S, the model's transpose and permute views."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(S + D)
    dt, B, KVH, G = TDT[dtype], 1 if S == 8192 else 2, 1, 12
    q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda")
               .to(dt).transpose(1, 2) for h in (KVH * G, KVH, KVH))
    tol = TOLS["flash_attention"][dtype]
    for causal in (True, False):
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, causal=causal).float(),
            ref.attention_ref(q, k, v, causal=causal).float(),
            rtol=tol, atol=tol)
    lengths = torch.tensor([S, max(1, S // 3)][:B], dtype=torch.int32,
                           device="cuda")
    args = (q[:, :, -1], k, v, lengths)
    tol = TOLS["flash_decode"][dtype]
    torch.testing.assert_close(ops.flash_decode(*args).float(),
                               ref.decode_attention_ref(*args).float(),
                               rtol=tol, atol=tol)
