"""The port's RWKV6 (``repro_torch.models.rwkv6``) against the reference
(``repro.models.rwkv6``), function by function at fp32 on the reduced
config, with weights from the reference's own init carried across by the
bridge and inputs made with numpy.

The reference's chunked form overflows at its own ``chunk=128`` for
sequences of about 96 tokens and more (its recentred factors reach
exp(Q * CLAMP_STEP / 2)); the port runs such a chunk over sub-blocks of at
most 32 positions. So the port is held to the reference's chunked form
wherever that is finite (1e-5), and to the reference's own stepwise path
(S = 1 a call, its decode) where it is not (1e-4): the difference test.
Logits parity of the Model API with greedy tokens is the ``rwkv6-ssm``
case of ``tests/test_torch_model.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import rwkv6 as jrwkv
from repro_torch.bridge import flatten, params_from_jax
from repro_torch.configs import get_arch
from repro_torch.models import rwkv6
from repro_torch.models.api import build_model

from test_torch_model import flatten_jax

TOL = dict(rtol=1e-5, atol=1e-5)


def configs(chunk=None, **over):
    """(reference, port) reduced rwkv6-3b configs, ``chunk`` and
    ``over`` applied to both."""
    out = []
    for cfg in (jget_arch("rwkv6-3b").reduced(),
                get_arch("rwkv6-3b").reduced()):
        if chunk is not None:
            over = dict(over, rwkv=dataclasses.replace(cfg.rwkv,
                                                       chunk=chunk))
        out.append(dataclasses.replace(cfg, **over))
    return out


def weights(jcfg, seed=0):
    """(reference params, port params) from the reference's init."""
    jp = jrwkv.rwkv6_lm_init(jax.random.key(seed), jcfg)
    return jp, params_from_jax(flatten_jax(jp), "cpu")


def layer0(jp, tp):
    """Layer 0's params in both packages."""
    return (jax.tree_util.tree_map(lambda a: a[0], jp["layers"]),
            {k: {kk: vv[0] for kk, vv in v.items()} for k, v in
             tp["layers"].items()})


def _np(x):
    return np.asarray(x, np.float32)


def _pair(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a)


def test_decay_matches_reference():
    jcfg, tcfg = configs()
    jp, tp = weights(jcfg)
    jl, tl = layer0(jp, tp)
    xw = np.random.default_rng(0).standard_normal(
        (2, 9, tcfg.d_model)).astype(np.float32) * 3
    jx, tx = _pair(xw)
    want = jrwkv._decay(jl["tm"], jx, jnp.float32)
    got = rwkv6._decay(tl["tm"], tx, torch.float32)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert float(got.min()) >= -rwkv6.CLAMP_STEP and float(got.max()) < 0


def _wkv_inputs(seed, B, S, H, K):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, K)).astype(np.float32)
               for _ in range(3))
    # log-decays in the clamp's range, the fastest channels near -e
    lw = -np.exp(rng.uniform(-6.0, 1.0, (B, S, H, K))).astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    S0 = rng.standard_normal((B, H, K, K)).astype(np.float32)
    return r, k, v, np.maximum(lw, -rwkv6.CLAMP_STEP), u, S0


@pytest.mark.parametrize("S,chunk", [(12, 16), (32, 16), (37, 16),
                                     (48, 48), (64, 128)])
def test_wkv_chunked_matches_reference(S, chunk):
    """The chunked WKV and its final state, where the reference's chunk is
    finite: a chunk that divides S, a prime S (chunk 1), one of 48 and
    one of 64 positions that the port runs as sub-blocks of 24 and 32.
    Held at 1e-5 of each output's largest value: y sums up to S terms of
    r k v (N(0, 1) each, the model's scale) and reaches about 40 here, so
    fp32 rounding alone is about 1e-5 of it (against a float64
    recurrence, at S = 64 the reference is off by 3.9e-5 and the port by
    1.5e-5)."""
    arrs = _wkv_inputs(S, 2, S, 3, 8)
    want_y, want_s = jrwkv._wkv_chunked(*map(jnp.asarray, arrs), chunk)
    got_y, got_s = rwkv6._wkv_chunked(*map(torch.from_numpy, arrs), chunk)
    assert np.isfinite(_np(want_y)).all()
    for got, want in ((got_y, want_y), (got_s, want_s)):
        want = _np(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("Q,block", [(1, 1), (16, 16), (35, 35), (36, 18),
                                     (48, 24), (64, 32), (96, 32),
                                     (128, 32), (37, 1)])
def test_block_len_keeps_safe_chunks_and_splits_the_rest(Q, block):
    """A chunk whose recentred factors stay finite (Q * 5 / 2 < 88) runs
    as it is, op for op as the reference; a larger one runs as blocks of
    the largest divisor of Q that is at most 32."""
    assert rwkv6._block_len(Q) == block
    assert Q % block == 0 and block * rwkv6.CLAMP_STEP / 2 < rwkv6.EXP_SAFE


def test_time_and_channel_mix_match_reference():
    jcfg, tcfg = configs()
    jp, tp = weights(jcfg, seed=1)
    jl, tl = layer0(jp, tp)
    rng = np.random.default_rng(1)
    B, S, d = 2, 20, tcfg.d_model
    H, hs = d // tcfg.rwkv.head_size, tcfg.rwkv.head_size
    x, xp = (rng.standard_normal(s).astype(np.float32)
             for s in ((B, S, d), (B, 1, d)))
    S0 = rng.standard_normal((B, H, hs, hs)).astype(np.float32) * 0.1
    jy, (jlast, jS) = jrwkv.rwkv6_time_mix(jl["tm"], jnp.asarray(x), jcfg,
                                           jnp.asarray(xp), jnp.asarray(S0))
    ty, (tlast, tS) = rwkv6.rwkv6_time_mix(
        tl["tm"], torch.from_numpy(x), tcfg, torch.from_numpy(xp),
        torch.from_numpy(S0))
    for got, want in ((ty, jy), (tlast, jlast), (tS, jS)):
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    jy, jlast = jrwkv.rwkv6_channel_mix(jl["cm"], jnp.asarray(x), jcfg,
                                        jnp.asarray(xp))
    ty, tlast = rwkv6.rwkv6_channel_mix(tl["cm"], torch.from_numpy(x), tcfg,
                                        torch.from_numpy(xp))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(tlast.numpy(), _np(jlast), **TOL)


def test_block_matches_reference_and_holds_the_normed_last_token():
    jcfg, tcfg = configs()
    jp, tp = weights(jcfg, seed=2)
    jl, tl = layer0(jp, tp)
    rng = np.random.default_rng(2)
    B, S, d = 2, 16, tcfg.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    st = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
          for k, v in rwkv6.rwkv6_state_init(tcfg, B, "cpu").items()}
    jx, jst = jrwkv.rwkv6_block(jl, jnp.asarray(x), jcfg,
                                {k: jnp.asarray(v) for k, v in st.items()})
    tx, tst = rwkv6.rwkv6_block(tl, torch.from_numpy(x), tcfg,
                                {k: torch.from_numpy(v)
                                 for k, v in st.items()})
    np.testing.assert_allclose(tx.numpy(), _np(jx), **TOL)
    assert tst.keys() == jst.keys()
    for k in tst:
        assert tst[k].dtype == torch.float32
        np.testing.assert_allclose(tst[k].numpy(), _np(jst[k]), **TOL)


@pytest.mark.parametrize("S", [12, 37])
def test_lm_apply_matches_reference(S):
    """Logits and stacked states, from zero states and then on from them;
    S = 37 is prime, so the chunk of 16 shrinks to 1, as in the
    reference."""
    jcfg, tcfg = configs()
    jp, tp = weights(jcfg, seed=3)
    toks = np.random.default_rng(S).integers(0, tcfg.vocab, (2, 2 * S))
    jl, jst = jrwkv.rwkv6_lm_apply(jp, jnp.asarray(toks[:, :S]), jcfg)
    tl, tst = rwkv6.rwkv6_lm_apply(tp, torch.from_numpy(toks[:, :S]), tcfg)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    for k in tst:
        np.testing.assert_allclose(tst[k].numpy(), _np(jst[k]), **TOL)
    jl, _ = jrwkv.rwkv6_lm_apply(jp, jnp.asarray(toks[:, S:]), jcfg, jst)
    tl, _ = rwkv6.rwkv6_lm_apply(tp, torch.from_numpy(toks[:, S:]), tcfg,
                                 tst)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    if S == 37:
        assert rwkv6.wkv_block_len(S, tcfg.rwkv.chunk) == 1


def _stepwise(apply, params, toks, cfg, wrap):
    """Logits [B,S,V] of ``apply`` fed one token a call, states carried."""
    st, out = None, []
    for t in range(toks.shape[1]):
        logits, st = apply(params, wrap(toks[:, t:t + 1]), cfg, st)
        out.append(_np(logits[:, 0]))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("chunk,S", [(16, 40), (128, 50)])
def test_chunked_matches_stepwise(chunk, S):
    """The port's chunked forward against its own recurrence, one token a
    call, within 1e-4."""
    _, tcfg = configs(chunk=chunk)
    _, tp = weights(configs(chunk=chunk)[0], seed=4)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (2, S))
    got, _ = rwkv6.rwkv6_lm_apply(tp, torch.from_numpy(toks), tcfg)
    want = _stepwise(rwkv6.rwkv6_lm_apply, tp, toks, tcfg, torch.from_numpy)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S", [96, 128])
def test_difference_where_the_reference_overflows(S):
    """At the published ``chunk=128`` and S = 96 and 128 the reference's
    chunked logits are non-finite (one chunk of S positions, recentred
    factors past fp32's range), while its stepwise path is finite. The
    port's chunked logits are finite and within 1e-4 of that stepwise
    path: the port holds the recurrence (ROADMAP.md section 3)."""
    jcfg, tcfg = configs(chunk=128)
    jp, tp = weights(jcfg, seed=5)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (2, S))
    ref_chunked, _ = jrwkv.rwkv6_lm_apply(jp, jnp.asarray(toks), jcfg)
    assert not np.isfinite(_np(ref_chunked)).all()
    # one compiled step, called S times (the reference serves it jitted)
    step = jax.jit(lambda p, t, st: jrwkv.rwkv6_lm_apply(p, t, jcfg, st))
    ref_step = _stepwise(
        lambda p, t, c, st: step(p, t, st if st is not None
                                 else jrwkv.rwkv6_lm_states(c, 2)),
        jp, toks, jcfg, jnp.asarray)
    assert np.isfinite(ref_step).all()
    got, st = rwkv6.rwkv6_lm_apply(tp, torch.from_numpy(toks), tcfg)
    assert bool(torch.isfinite(got).all())
    assert all(bool(torch.isfinite(v).all()) for v in st.values())
    np.testing.assert_allclose(got.numpy(), ref_step, rtol=1e-4, atol=1e-4)


def test_decode_matches_teacher_forcing():
    """The reference's check (``tests/test_arch_smoke.py``), run through
    the port's Model API: prefill(S) then decode(token S) equals the full
    forward at position S, within 5e-4."""
    jcfg, tcfg = configs()
    _, tp = weights(jcfg, seed=6)
    model = build_model(tcfg, "cpu")
    B, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab, (B, S + 1)))
    cache = model.init_cache(tp, {"tokens": toks[:, :S]}, B, 32)
    _, cache = model.prefill(tp, {"tokens": toks[:, :S]}, cache)
    lg_dec, _ = model.decode_step(tp, cache, toks[:, S:S + 1],
                                  torch.full((B,), S, dtype=torch.int32))
    ref, _ = rwkv6.rwkv6_lm_apply(tp, toks, tcfg)
    assert float((lg_dec - ref[:, S]).abs().max()) < 5e-4


def test_init_layout_draws_and_dtypes_match_the_reference():
    """The port's own init has the reference's keys and shapes; ``w0``
    (the decay linspace, the same values) and ``u`` stay fp32 under a bf16
    parameter dtype, the rest takes it; the token-shift mixes start at
    0.5 and the per-head norm at 1."""
    jcfg, tcfg = configs(param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jrwkv.rwkv6_lm_init(jax.random.key(0), jcfg)
    want = {k: (a.shape, str(a.dtype)) for k, a in flatten_jax(jp).items()}
    tp = build_model(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    got = {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for k, t in flatten(tp).items()}
    assert got == want
    assert got["layers/tm/w0"][1] == got["layers/tm/u"][1] == "float32"
    # linspace(-6, 1, d) in both, to fp32's last place
    np.testing.assert_allclose(tp["layers"]["tm"]["w0"].numpy(),
                               np.asarray(jp["layers"]["tm"]["w0"]),
                               rtol=0, atol=1e-6)
    assert bool((tp["layers"]["tm"]["mu"] == 0.5).all())
    assert bool((tp["layers"]["tm"]["ln"] == 1).all())


def test_full_width_on_meta():
    """rwkv6-3b at its published config builds on the meta device: about
    3.07B parameters, H 40 heads of 64, and its states [32, B, ...]."""
    cfg = get_arch("rwkv6-3b")
    model = build_model(cfg, "meta")
    p = model.abstract_params()
    n = sum(t.numel() for t in flatten(p).values())
    assert 3.0e9 < n < 3.15e9
    assert tuple(p["layers"]["tm"]["w0"].shape) == (32, 40, 64)
    st = model.init_cache(p, None, 2, 0)
    assert tuple(st["S"].shape) == (32, 2, 40, 64, 64)
    assert tuple(st["tm_x"].shape) == (32, 2, 1, 2560)
