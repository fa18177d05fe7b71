"""The port's ChaCha20 against the JAX reference, bit-exact.

On the CPU the ``chacha20_keystream`` custom op runs the kernel's plain
version (``repro_torch.kernels.ref.chacha20_keystream_ref``, int64
arithmetic masked to 32 bits); these tests hold it against the
reference's oracle (``repro.kernels.ref``) and its Pallas kernel run as
the reference's own tests run it (``interpret=True``), on inputs made by
numpy from a seed. The CUDA kernel is held against the plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.chacha20 import keystream as pallas_keystream
from repro_torch.kernels import ops, ref

RFC_KEY = np.frombuffer(bytes(range(32)), dtype="<u4")
RFC_NONCE = np.frombuffer(bytes.fromhex("000000090000004a00000000"),
                          dtype="<u4")
RFC_BLOCK1 = bytes.fromhex(
    "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
    "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")


def _u32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32))


def _np(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.uint32
    return t.view(torch.int32).numpy().view(np.uint32)


def _key_nonce(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**32, size=8, dtype=np.uint32),
            rng.integers(0, 2**32, size=3, dtype=np.uint32))


def test_rfc7539_vector():
    got = ops.chacha20_keystream(_u32(RFC_KEY), _u32(RFC_NONCE), 1, 4)
    assert got.shape == (4, 16) and got.dtype == torch.uint32
    assert _np(got)[0].astype("<u4").tobytes() == RFC_BLOCK1
    want = jref.chacha20_keystream_ref(jnp.asarray(RFC_KEY),
                                       jnp.asarray(RFC_NONCE), 1, 4)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_512_blocks_from_counter_42_match_reference_and_pallas():
    key, nonce = _key_nonce(0)
    got = _np(ref.chacha20_keystream_ref(_u32(key), _u32(nonce), 42, 512))
    jk, jn = jnp.asarray(key), jnp.asarray(nonce)
    np.testing.assert_array_equal(
        got, np.asarray(jref.chacha20_keystream_ref(jk, jn, 42, 512)))
    np.testing.assert_array_equal(
        got, np.asarray(pallas_keystream(jk, jn, 42, n_blocks=512,
                                         tile=128)))


@pytest.mark.parametrize("counter0", [0, 2**31 - 1, 2**32 - 3, 2**32 - 1])
def test_counter_wraps_like_the_reference(counter0):
    key, nonce = _key_nonce(counter0 % 1000)
    got = ops.chacha20_keystream(_u32(key), _u32(nonce), counter0, 32)
    want = jref.chacha20_keystream_ref(jnp.asarray(key), jnp.asarray(nonce),
                                       counter0, 32)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(1, 4))
def test_property_counters_and_block_counts(ctr, tiles):
    key, nonce = _key_nonce(ctr % 97)
    n = 16 * tiles
    got = _np(ops.chacha20_keystream(_u32(key), _u32(nonce), ctr, n))
    want = jref.chacha20_keystream_ref(jnp.asarray(key), jnp.asarray(nonce),
                                       ctr, n)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_encrypt_matches_reference_and_round_trips():
    """An odd block count (37 is prime: the reference searches for a tile
    that divides it and runs its Pallas kernel at tile 37, the port's
    kernel masks its tail); XOR twice is the identity."""
    n_blocks = 37
    key, nonce = _key_nonce(n_blocks)
    data = np.random.default_rng(n_blocks).integers(
        0, 2**32, size=(n_blocks, 16), dtype=np.uint32)
    got = ops.chacha20_encrypt(_u32(data), _u32(key), _u32(nonce), 5)
    want = jops.chacha20_encrypt(jnp.asarray(data), jnp.asarray(key),
                                 jnp.asarray(nonce), 5)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    back = ops.chacha20_encrypt(got, _u32(key), _u32(nonce), 5)
    np.testing.assert_array_equal(_np(back), data)


def test_u32_round_trip_through_int64():
    words = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    wide = ref.u32_to_i64(_u32(words))
    assert wide.tolist() == words.astype(np.int64).tolist()
    np.testing.assert_array_equal(_np(ref.i64_to_u32(wide)), words)
