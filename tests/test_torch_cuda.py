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
