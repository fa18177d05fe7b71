"""The port's MLA (the MLA half of ``repro_torch.models.attention``) against
the JAX reference (``repro.models.attention``), and the widened plain
attention (q/k head dim apart from v's) against the reference's
``chunked_attention``. Weights from the reference's ``mla_init``, inputs
from numpy, fp32. The absorbed decode is held against the decompressing
one at 2e-4, the reference's own tolerance (tests/test_mla_mtp.py)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import attention as jattn
from repro.models import layers as jl
from repro_torch.configs import get_arch
from repro_torch.kernels import build, library, ops, ref
from repro_torch.models import attention as attn
from repro_torch.models.layers import materialize

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "deepseek-v3-671b"
B, S, SMAX = 2, 12, 32


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jp = jattn.mla_init(jax.random.key(0), jcfg, jnp.float32)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.default_rng(1)
    warm = (rng.standard_normal((B, S, jcfg.d_model)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((B, 1, jcfg.d_model)) * 0.5).astype(np.float32)
    return jcfg, tcfg, jp, tp, warm, x


def _positions(n):
    return np.arange(n)[None].repeat(B, 0)


def _jprefill(jcfg, jp, warm):
    cache = jattn.mla_init_cache(jcfg, B, SMAX, jnp.float32)
    return jattn.mla_prefill(jp, jnp.asarray(warm), jcfg, cache,
                             jnp.asarray(_positions(S)))


def _tprefill(tcfg, tp, warm):
    cache = attn.mla_init_cache(tcfg, B, SMAX, torch.float32, "cpu")
    return attn.mla_prefill(tp, torch.from_numpy(warm), tcfg, cache,
                            torch.from_numpy(_positions(S)))


def test_mla_init_shapes_match_reference(setup):
    jcfg, tcfg, jp, _, _, _ = setup
    got = materialize(attn.mla_init(tcfg), None, torch.float32, "meta")
    flat = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                got, is_leaf=lambda t: isinstance(t, torch.Tensor))}
    want = {"/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    assert flat == want


def test_mla_forward_matches_reference(setup):
    jcfg, tcfg, jp, tp, warm, _ = setup
    want = jattn.mla_forward(jp, jnp.asarray(warm), jcfg,
                             jnp.asarray(_positions(S)))
    got = attn.mla_forward(tp, torch.from_numpy(warm), tcfg,
                           torch.from_numpy(_positions(S)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_prefill_fills_the_latent_cache_as_the_reference(setup):
    jcfg, tcfg, jp, tp, warm, _ = setup
    jy, jcache = _jprefill(jcfg, jp, warm)
    ty, tcache = _tprefill(tcfg, tp, warm)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL)


@pytest.mark.parametrize("form", ["mla_decode", "mla_decode_naive"])
def test_mla_decode_matches_reference(setup, form):
    jcfg, tcfg, jp, tp, warm, x = setup
    _, jcache = _jprefill(jcfg, jp, warm)
    _, tcache = _tprefill(tcfg, tp, warm)
    lengths = np.array([S, S - 3], np.int32)
    jy, jcache = getattr(jattn, form)(jp, jnp.asarray(x), jcfg, jcache,
                                      jnp.asarray(lengths))
    ty, tcache = getattr(attn, form)(tp, torch.from_numpy(x), tcfg, tcache,
                                     torch.from_numpy(lengths))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL)


def test_mla_absorbed_decode_matches_naive(setup):
    """The port's two decode forms against each other, as the reference's
    test_mla_absorbed_decode_matches_naive holds its own."""
    _, tcfg, _, tp, warm, x = setup
    _, cache_a = _tprefill(tcfg, tp, warm)
    _, cache_b = _tprefill(tcfg, tp, warm)
    lengths = torch.full((B,), S, dtype=torch.int32)
    y_abs, _ = attn.mla_decode(tp, torch.from_numpy(x), tcfg, cache_a,
                               lengths)
    y_naive, _ = attn.mla_decode_naive(tp, torch.from_numpy(x), tcfg,
                                       cache_b, lengths)
    np.testing.assert_allclose(y_abs.numpy(), y_naive.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.fixture(scope="module")
def bf16_setup():
    """deepseek-v3's reduced config computing in bf16, its reference MLA
    weights rounded to bf16, a bf16 latent cache of random values and one
    token a sequence. The reference's bf16 einsums (bf16 operands, fp32
    results) do not run on JAX's CPU backend, so the absorbed form is held
    to this file's own oracle of the same formula."""
    import dataclasses
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(),
                               compute_dtype="bfloat16")
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(),
                               compute_dtype="bfloat16")
    jp = jattn.mla_init(jax.random.key(0), jcfg, jnp.float32)
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).to(torch.bfloat16), jp)
    rng = np.random.default_rng(3)
    m = tcfg.mla
    cache = {k: torch.from_numpy(rng.standard_normal((B, SMAX, n)).astype(
        np.float32)).to(torch.bfloat16)
        for k, n in (("c_kv", m.kv_lora_rank), ("k_rope", m.rope_head_dim))}
    x = torch.from_numpy(rng.standard_normal((B, 1, tcfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    return tcfg, tp, cache, x, torch.tensor([20, 9], dtype=torch.int32)


def _absorbed_oracle(p, x, cfg, cache, lengths):
    """The reference's absorbed decode, written out: every einsum takes
    operands rounded to the compute dtype and gives fp32
    (``preferred_element_type=jnp.float32``); the readout is rounded to
    the compute dtype for ``wo``."""
    m, H, bf = cfg.mla, cfg.n_heads, torch.bfloat16
    nb = x.shape[0]

    def e(spec, *ts):
        return torch.einsum(spec, *(t.to(bf).float() for t in ts))

    positions = lengths[:, None]
    q_nope, q_rope = attn._mla_q(p, x, cfg, positions)
    c_kv, k_rope = attn._mla_latent(p, x, cfg, positions)
    ckv, krp = cache["c_kv"].clone(), cache["k_rope"].clone()
    ckv[torch.arange(nb), lengths] = c_kv[:, 0].to(bf)
    krp[torch.arange(nb), lengths] = k_rope[:, 0].to(bf)
    w = p["wkv_b"]["w"].reshape(m.kv_lora_rank, H, -1)
    w_uk, w_uv = w[..., :m.nope_head_dim], w[..., m.nope_head_dim:]
    q_lat = e("bshn,lhn->bshl", q_nope, w_uk)
    s = (e("bshl,btl->bhst", q_lat, ckv) + e("bshr,btr->bhst", q_rope, krp))
    s = s / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    valid = torch.arange(ckv.shape[1])[None, :] < (lengths + 1)[:, None]
    s = torch.where(valid[:, None, None, :], s, -1e30)
    o_lat = e("bhst,btl->bshl", torch.softmax(s, dim=-1), ckv)
    o = e("bshl,lhv->bshv", o_lat, w_uv)
    return o.reshape(nb, 1, -1).to(bf) @ p["wo"]["w"].to(bf)


def _copy(cache):
    return {k: v.clone() for k, v in cache.items()}


def test_bf16_mla_decode_matches_oracle(bf16_setup):
    """In bf16 the absorbed decode keeps the reference's fp32 products of
    bf16 operands. Only the order of fp32 sums may differ from the
    oracle, which can move a bf16 output by one rounding step: at most one
    step and on few elements. Products rounded to bf16 (a bf16
    ``torch.einsum``) move most of the elements."""
    cfg, p, cache, x, lengths = bf16_setup
    got, _ = attn.mla_decode(p, x, cfg, _copy(cache), lengths)
    want = _absorbed_oracle(p, x, cfg, cache, lengths)
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    step = 2.0 ** (torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    assert bool(((g - w).abs() <= step).all())
    assert (g != w).float().mean().item() <= 0.1


def test_bf16_mla_decode_matches_naive(bf16_setup):
    """The absorbed and the decompressing decode in bf16, at the bf16
    tolerance of the kernels' plain versions (2e-2 of the output's
    scale)."""
    cfg, p, cache, x, lengths = bf16_setup
    y_abs, c_abs = attn.mla_decode(p, x, cfg, _copy(cache), lengths)
    y_naive, c_naive = attn.mla_decode_naive(p, x, cfg, _copy(cache),
                                             lengths)
    for k in c_abs:
        assert torch.equal(c_abs[k], c_naive[k])
    a, n = y_abs.float(), y_naive.float()
    assert (a - n).abs().max().item() <= 2e-2 * n.abs().max().item()


def test_mla_cache_is_compressed(setup):
    """The cache holds the latent (kv_lora + rope) a position, not the
    decompressed K and V of every head."""
    _, tcfg, _, _, _, _ = setup
    cache = attn.mla_init_cache(tcfg, 4, 64, torch.float32, "cpu")
    m = tcfg.mla
    total = sum(t.numel() for t in cache.values())
    assert total == 4 * 64 * (m.kv_lora_rank + m.rope_head_dim)
    assert total < 4 * 64 * tcfg.n_heads * (m.nope_head_dim
                                            + m.v_head_dim) / 4
    full = get_arch(ARCH)
    from repro_torch.models import transformer
    c = transformer.lm_init_cache(full, 2, 528, "meta")
    assert {k: tuple(v.shape) for k, v in c.items()} == {
        "c_kv": (61, 2, 528, 512), "k_rope": (61, 2, 528, 64)}


@pytest.mark.parametrize("dqk,dv", [(24, 16), (192, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_widened_plain_attention_matches_chunked_attention(dqk, dv, causal):
    """``flash_attention``'s plain version (what the op runs on CPU
    tensors) at q/k head dim ``dqk`` and v head dim ``dv`` against the
    reference's ``chunked_attention`` (the reference's ``attention_ref``
    takes one head dim only), scores scaled by 1/sqrt(dqk)."""
    rng = np.random.default_rng(dqk + causal)
    Bq, H, KVH, Sq = 2, 4, 2, 40
    q = rng.standard_normal((Bq, Sq, H, dqk)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, KVH, dqk)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, KVH, dv)).astype(np.float32)
    want = jl.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        chunk_q=16, chunk_kv=16, scale=1.0 / math.sqrt(dqk),
        compute_dtype=jnp.float32)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (Bq, H, Sq, dv)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               **TOL)
    np.testing.assert_allclose(
        ref.attention_ref(tq, tk, tv, causal=causal).numpy(), got.numpy(),
        rtol=0, atol=0)


def test_widened_attention_meta_shape_and_flops():
    q = torch.empty((1, 128, 512, 192), device="meta")
    v = torch.empty((1, 128, 512, 128), device="meta")
    assert ops.flash_attention(q, q, v).shape == (1, 128, 512, 128)
    f, _ = library.KERNEL_FLOPS["repro_torch::flash_attention"](q, q, v, True)
    assert f == 2.0 * 128 * 512 * 512 * (192 + 128)


def test_kernel_wrapper_takes_192_for_q_and_k_only():
    """The CUDA wrapper's operand checks: (q/k, v) head dims must be one of
    ``build.ATTENTION_DIMS``, so q/k take 192 with v 128 only; a CPU
    tensor that passes them is refused for its device (the kernel runs on
    CUDA tensors only)."""
    from repro_torch.kernels import flash_attention as fa
    assert (192, 128) in build.ATTENTION_DIMS
    q = torch.zeros((1, 2, 8, 192))
    with pytest.raises(ValueError, match=r"head dims \(q/k 192, v 192\)"):
        fa.flash_attention(q, q, q)
    q48 = torch.zeros((1, 2, 8, 48))
    with pytest.raises(ValueError, match=r"head dims \(q/k 48, v 48\)"):
        fa.flash_attention(q48, q48, q48)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention(q, q, torch.zeros((1, 2, 8, 128)))
