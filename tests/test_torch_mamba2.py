"""The port's Mamba2 block against the reference's, function by function.

Weights come from the reference's own ``mamba2_init`` on zamba2-2.7b's
reduced config (fp32), carried across by ``repro_torch.bridge``; inputs
are made from a numpy seed. Every function must agree at 1e-5."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import mamba2 as jm
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import mamba2 as tm
from repro_torch.models.layers import materialize

TOL = dict(rtol=1e-5, atol=1e-5)


def configs(**over):
    return (dataclasses.replace(jget_arch("zamba2-2.7b").reduced(), **over),
            dataclasses.replace(get_arch("zamba2-2.7b").reduced(), **over))


def params(jcfg, seed=0):
    jp = jm.mamba2_init(jax.random.key(seed), jcfg, jnp.float32)
    return jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                               "cpu")


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_conv_full_matches_reference():
    jcfg, tcfg = configs()
    jp, tp = params(jcfg)
    _, _, _, conv_ch = tm._dims(tcfg)
    u = np.random.default_rng(0).standard_normal((2, 23, conv_ch),
                                                 dtype=np.float32)
    close(tm._conv_full(tp, torch.from_numpy(u), tcfg),
          jm._conv_full(jp, jnp.asarray(u), jcfg))


def _scan_inputs(S, nh=8, hd=16, G=1, N=16, seed=1):
    rng = np.random.default_rng(seed)
    f = np.float32
    xh = rng.standard_normal((2, S, nh, hd)).astype(f)
    dtv = np.log1p(np.exp(rng.standard_normal((2, S, nh)))).astype(f)
    A = -np.linspace(1.0, 16.0, nh).astype(f)
    Bm = rng.standard_normal((2, S, G, N)).astype(f)
    Cm = rng.standard_normal((2, S, G, N)).astype(f)
    h0 = (0.1 * rng.standard_normal((2, nh, hd, N))).astype(f)
    return xh, dtv, A, Bm, Cm, h0


@pytest.mark.parametrize("S,chunk,Q", [(48, 16, 16), (11, 16, 11),
                                       (17, 16, 1), (45, 16, 15)],
                         ids=["divisible", "below-chunk", "prime-Q1",
                              "shrunk"])
def test_ssd_chunk_scan_matches_reference(S, chunk, Q):
    """S a multiple of the chunk, S below it, a prime S above it (the chunk
    shrinks to 1) and an S the chunk shrinks to divide; two groups of B/C
    heads in the last case."""
    assert tm._chunk_len(S, chunk) == Q
    G = 2 if S == 45 else 1
    arrs = _scan_inputs(S, G=G)
    y, h = tm._ssd_chunk_scan(*map(torch.from_numpy, arrs), chunk)
    jy, jh = jm._ssd_chunk_scan(*map(jnp.asarray, arrs), chunk)
    close(y, jy)
    close(h, jh)
    assert torch.isfinite(y).all()


def test_ssd_chunk_scan_stays_finite_where_the_decay_overflows():
    """Fast decay over a long chunk: above the diagonal exp(seg) is inf,
    which must not reach the output (the mask is applied before the exp,
    never as a 0/1 product)."""
    xh, dtv, A, Bm, Cm, h0 = _scan_inputs(64)
    dtv = np.full_like(dtv, 4.0)            # dt * A down to -64 a step
    y, h = tm._ssd_chunk_scan(*map(torch.from_numpy,
                                   (xh, dtv, A, Bm, Cm, h0)), 64)
    jy, jh = jm._ssd_chunk_scan(*map(jnp.asarray, (xh, dtv, A, Bm, Cm, h0)),
                                64)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    close(y, jy)
    close(h, jh)


@pytest.mark.parametrize("S", [16, 40, 13])
def test_mamba2_forward_matches_reference(S):
    jcfg, tcfg = configs()
    jp, tp = params(jcfg)
    x = np.random.default_rng(S).standard_normal((2, S, tcfg.d_model),
                                                 dtype=np.float32)
    y, h = tm.mamba2_forward(tp, torch.from_numpy(x), tcfg)
    jy, jh = jm.mamba2_forward(jp, jnp.asarray(x), jcfg)
    close(y, jy)
    close(h, jh)


@pytest.mark.parametrize("S", [2, 20])
def test_mamba2_prefill_and_init_state_match_reference(S):
    """The prefill's output and state from a nonzero ``h``, including a
    prompt shorter than the conv window (zero-padded in front)."""
    jcfg, tcfg = configs()
    jp, tp = params(jcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S, tcfg.d_model), dtype=np.float32)
    st = tm.mamba2_init_state(tcfg, 2, "cpu")
    jst = jm.mamba2_init_state(jcfg, 2)
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: v.shape for k, v in jst.items()}
    h = (0.1 * rng.standard_normal(tuple(st["h"].shape))).astype(np.float32)
    conv = rng.standard_normal(tuple(st["conv"].shape)).astype(np.float32)
    y, new = tm.mamba2_prefill(tp, torch.from_numpy(x), tcfg,
                               {"conv": torch.from_numpy(conv),
                                "h": torch.from_numpy(h)})
    jy, jnew = jm.mamba2_prefill(jp, jnp.asarray(x), jcfg,
                                 {"conv": jnp.asarray(conv),
                                  "h": jnp.asarray(h)})
    close(y, jy)
    for k in ("conv", "h"):
        close(new[k], jnew[k])


def test_mamba2_decode_matches_reference():
    jcfg, tcfg = configs()
    jp, tp = params(jcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, tcfg.d_model), dtype=np.float32)
    st = {k: (0.3 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
          for k, v in tm.mamba2_init_state(tcfg, 2, "cpu").items()}
    y, new = tm.mamba2_decode(tp, torch.from_numpy(x), tcfg,
                              {k: torch.from_numpy(v) for k, v in st.items()})
    jy, jnew = jm.mamba2_decode(jp, jnp.asarray(x), jcfg,
                                {k: jnp.asarray(v) for k, v in st.items()})
    close(y, jy)
    for k in ("conv", "h"):
        close(new[k], jnew[k])


@pytest.mark.parametrize("P", [5, 16, 23])
def test_prefill_then_decode_matches_forward(P):
    """Prefill of P tokens, then decode steps token by token, against the
    forward over the whole sequence (in the port and in the reference)."""
    jcfg, tcfg = configs()
    jp, tp = params(jcfg)
    S = P + 6
    x = np.random.default_rng(P).standard_normal((2, S, tcfg.d_model),
                                                 dtype=np.float32)
    xt = torch.from_numpy(x)
    want, h_want = tm.mamba2_forward(tp, xt, tcfg)
    close(want, jm.mamba2_forward(jp, jnp.asarray(x), jcfg)[0])
    y, st = tm.mamba2_prefill(tp, xt[:, :P], tcfg,
                              tm.mamba2_init_state(tcfg, 2, "cpu"))
    outs = [y]
    for t in range(P, S):
        y, st = tm.mamba2_decode(tp, xt[:, t:t + 1], tcfg, st)
        outs.append(y)
    close(torch.cat(outs, dim=1), want.numpy())
    close(st["h"], h_want.numpy())


def test_init_spec_matches_the_reference_layout_and_draws():
    """``mamba2_init``'s spec gives the reference's keys, shapes and dtypes
    (dt_bias, A_log and D in fp32 under a bf16 tree), A_log the
    reference's log(linspace(1, 16)) and dt_bias the softplus inverse of a
    dt in [1e-3, 1e-1]."""
    jcfg, tcfg = configs(param_dtype="bfloat16")
    want = jm.mamba2_init(jax.random.key(0), jcfg, jnp.bfloat16)
    got = materialize(tm.mamba2_init(tcfg), torch.Generator().manual_seed(0),
                      torch.bfloat16, "cpu")
    assert list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype), k
    np.testing.assert_allclose(got["A_log"].numpy(), np.asarray(want["A_log"]),
                               rtol=1e-6)
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert torch.equal(got["D"], torch.ones_like(got["D"]))
    assert float(got["conv_w"].float().std()) == pytest.approx(0.2, rel=0.2)
    assert float(got["out_proj"].float().std()) == pytest.approx(
        1 / math.sqrt(got["out_proj"].shape[0]), rel=0.2)


def test_stacked_init_draws_every_layer_and_keeps_leaf_dtypes():
    """With ``layers`` = L each leaf is [L, ...], a leaf's own dtype kept;
    the linspace is the same in every layer, the uniform draw is not."""
    _, tcfg = configs()
    got = materialize(tm.mamba2_init(tcfg), torch.Generator().manual_seed(0),
                      torch.bfloat16, "cpu", layers=3)
    assert got["in_proj"].dtype == torch.bfloat16
    assert got["A_log"].dtype == got["dt_bias"].dtype == torch.float32
    assert torch.equal(got["A_log"][0], got["A_log"][2])
    assert not torch.equal(got["dt_bias"][0], got["dt_bias"][1])
    meta = materialize(tm.mamba2_init(tcfg), None, torch.bfloat16, "meta",
                       layers=3)
    assert meta["dt_bias"].dtype == torch.float32
    assert meta["in_proj"].device.type == "meta"


# ------------------------------------------- the decode step as one op
#
# ``mamba2_decode`` runs the step between its projections as one op,
# ``kernels.ops.mamba2_step``: the hand-written kernel on the card, its
# plain version (``kernels.ref.mamba2_step_ref``) here. ``_step_before`` is
# the op sequence ``mamba2_decode`` ran before, from the input
# projection's output zx [B,1,proj] to the output projection's input.

SSM_SHAPES = {"registry": dict(nh=8, hd=16, N=16, K=4),
              "published": dict(nh=80, hd=64, N=64, K=4)}


def _step_before(p, zx, state, nh, hd, N, G, eps):
    from repro_torch.models.layers import rmsnorm
    F = torch.nn.functional
    Bsz, d_in, gn = zx.shape[0], nh * hd, G * N
    gz, xc, Bc, Cc, dtr = torch.split(zx, [d_in, d_in, gn, gn, nh], dim=-1)
    u = torch.cat([xc, Bc, Cc], dim=-1)[:, 0, :]
    window = torch.cat([state["conv"], u[:, None, :].float()], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"].float()) \
        + p["conv_b"].float()
    xc1, Bc1, Cc1 = torch.split(F.silu(conv_out), [d_in, gn, gn], dim=-1)
    xh = xc1.reshape(Bsz, nh, hd)
    rep = nh // G
    Bm = Bc1.reshape(Bsz, G, N).repeat_interleave(rep, 1)
    Cm = Cc1.reshape(Bsz, G, N).repeat_interleave(rep, 1)
    dtv = F.softplus(dtr[:, 0].float() + p["dt_bias"])
    dec = torch.exp(dtv * -torch.exp(p["A_log"]))
    h = dec[:, :, None, None] * state["h"] + \
        (xh * dtv[..., None])[..., :, None] @ Bm[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", Cm, h) + p["D"][None, :, None] * xh
    y = y.reshape(Bsz, 1, d_in) * F.silu(gz.float())
    y = rmsnorm(y.to(zx.dtype), p["out_norm"], eps)
    return y, {"conv": window[:, 1:, :], "h": h}


def _step_operands(Bsz, nh, hd, N, G, K, seed=0, dtype=torch.float32,
                   wdtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    d_in = nh * hd
    cc = d_in + 2 * G * N

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (scale * torch.randn(*shape, generator=g)).to(dt)

    p = {"conv_w": rnd(K, cc, scale=0.2, dt=wdtype),
         "conv_b": rnd(cc, dt=wdtype), "dt_bias": rnd(nh, scale=0.5) - 2,
         "A_log": torch.log(torch.linspace(1.0, 16.0, nh)),
         "D": rnd(nh), "out_norm": rnd(cc - 2 * G * N, dt=wdtype) + 1}
    zx = rnd(Bsz, 1, 2 * d_in + 2 * G * N + nh, dt=dtype)
    state = {"conv": rnd(Bsz, K - 1, cc, scale=0.5),
             "h": rnd(Bsz, nh, hd, N, scale=0.3)}
    return p, zx, state


@pytest.mark.parametrize("shape", ["registry", "published"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("Bsz", [1, 3])
def test_mamba2_step_plain_version_equals_the_ops_it_replaced(Bsz, G,
                                                              shape):
    """The op's plain version, at fp32, against the sequence of ops the
    decode step ran before (within 1e-6): the output, and the window and
    state it writes in place."""
    d = SSM_SHAPES[shape]
    p, zx, state = _step_operands(Bsz, G=G, **d)
    want, new = _step_before(p, zx, state, d["nh"], d["hd"], d["N"], G,
                             1e-5)
    conv, h = state["conv"].clone(), state["h"].clone()
    got = ops.mamba2_step(zx[:, 0], conv, h, p, 1e-5)
    assert got.shape == (Bsz, d["nh"] * d["hd"])
    tol = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, want[:, 0], **tol)
    torch.testing.assert_close(conv, new["conv"], **tol)
    torch.testing.assert_close(h, new["h"], **tol)


@pytest.mark.parametrize("inplace", [True, False])
def test_sixteen_decode_steps_equal_the_ops_they_replaced(inplace):
    """16 steps of ``mamba2_decode`` with the state carried, at the
    registry's reduced block, against the projections around the former
    op sequence: the same outputs and final state (1e-6). In place the
    new state is the given state's own tensors; otherwise the given state
    is left as it was."""
    _, tcfg = configs()
    tp = materialize(tm.mamba2_init(tcfg), torch.Generator().manual_seed(1),
                     torch.float32, "cpu")
    s, d_in, nh, _ = tm._dims(tcfg)
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.standard_normal((16, 2, 1, tcfg.d_model),
                                              dtype=np.float32))
    st = tm.mamba2_init_state(tcfg, 2, "cpu")
    st = {k: 0.3 * torch.randn(v.shape, generator=torch.Generator()
                               .manual_seed(2)) for k, v in st.items()}
    want_st = {k: v.clone() for k, v in st.items()}
    for x in xs:
        before = {k: v.clone() for k, v in st.items()}
        y, new = tm.mamba2_decode(tp, x, tcfg, st, inplace=inplace)
        zx = x @ tp["in_proj"]
        yw, want_st = _step_before(tp, zx, want_st, nh, s.head_dim,
                                   s.d_state, s.n_groups, s.norm_eps)
        torch.testing.assert_close(y, yw @ tp["out_proj"], rtol=1e-6,
                                   atol=1e-6)
        for k in ("conv", "h"):
            assert (new[k] is st[k]) == inplace
            if not inplace:
                assert torch.equal(st[k], before[k])
        st = new
    for k in ("conv", "h"):
        torch.testing.assert_close(st[k], want_st[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_step_costs_what_its_plain_ops_cost(dtype, wdtype):
    """The op's registered flops (``library.KERNEL_FLOPS``) equal the cost
    model's count of its plain version's op sequence: the products as
    tensor-core flops, and the total with every elementwise op and cast;
    the flop counter's formula counts the products alone."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis import differential  # noqa: F401 (formula)
    from repro_torch.analysis.regions import fn_cost
    from repro_torch.kernels import library, ref
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for Bsz, G, d in ((1, 1, SSM_SHAPES["published"]),
                      (3, 2, SSM_SHAPES["registry"])):
        p, zx, state = _step_operands(Bsz, G=G, dtype=dts[dtype],
                                      wdtype=dts[wdtype], **d)
        args = (zx[:, 0], state["conv"], state["h"], p["conv_w"],
                p["conv_b"], p["dt_bias"], p["A_log"], p["D"],
                p["out_norm"], 1e-5)
        plain = fn_cost(ref.mamba2_step_ref, *args)
        op = fn_cost(library.mamba2_step, *args)
        assert (op.mxu_flops, op.flops) == (plain.mxu_flops, plain.flops)
        with FlopCounterMode(display=False) as fc:
            library.mamba2_step(*args)
        assert fc.get_total_flops() == plain.mxu_flops
