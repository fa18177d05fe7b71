"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper)
against the reference (``repro.models.encdec``), function by function at
fp32 on the reduced config (1e-4), with weights from the reference's own
init carried across by the bridge and frames and tokens made with numpy.
Also the reference's decode-against-teacher-forcing check (5e-4), the two
behaviours of the reference the port holds (``prefill`` returns the cache
unfilled; ``input_specs`` adds ``frames``) and the attention calls the
path makes. Logits parity of the Model API with greedy tokens is the
``whisper-encdec`` case of ``tests/test_torch_model.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import encdec as jencdec
from repro.models.api import build_model as jbuild_model
from repro_torch.bridge import flatten, params_from_jax
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import encdec
from repro_torch.models.api import build_model

from test_torch_model import flatten_jax

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-large-v3"


@pytest.fixture(scope="module")
def setup():
    """Reduced configs, both models, reference params and bridged ones,
    frames [2, 24, d] and tokens [2, 13]."""
    jcfg, tcfg = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jmodel = jbuild_model(jcfg)
    jp = jmodel.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    frames = (rng.standard_normal((2, jcfg.enc_dec.n_frames, jcfg.d_model))
              * 0.1).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (2, 13))
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, jp=jp,
                tmodel=build_model(tcfg, "cpu"),
                tp=params_from_jax(flatten_jax(jp), "cpu"),
                frames=frames, toks=toks)


def _np(x):
    return np.asarray(x, np.float32)


def test_encode_matches_reference(setup):
    s = setup
    want = jencdec.encode(s["jp"], jnp.asarray(s["frames"]), s["jcfg"])
    got = encdec.encode(s["tp"], torch.from_numpy(s["frames"]), s["tcfg"])
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_cross_attention_matches_reference(setup):
    """``_cross_fwd`` of decoder layer 1 over the encoder's k/v: Sq = 13
    tokens against Skv = 24 frames, not causal."""
    s = setup
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 13, s["tcfg"].d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 24, s["tcfg"].d_model)).astype(np.float32)
    jl = jax.tree_util.tree_map(lambda a: a[1], s["jp"]["dec_layers"])
    tl = {k: {kk: vv[1] for kk, vv in v.items()}
          for k, v in s["tp"]["dec_layers"]["cross"].items()}
    jkv = jencdec._enc_kv(jl["cross"], jnp.asarray(enc), s["jcfg"])
    tkv = encdec._enc_kv(tl, torch.from_numpy(enc), s["tcfg"])
    for got, want in zip(tkv, jkv):
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    want = jencdec._cross_fwd(jl["cross"], jnp.asarray(x), jkv, s["jcfg"])
    got = encdec._cross_fwd(tl, torch.from_numpy(x), tkv, s["tcfg"])
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_decode_forward_matches_reference(setup):
    s = setup
    enc = jencdec.encode(s["jp"], jnp.asarray(s["frames"]), s["jcfg"])
    want = jencdec.decode_forward(s["jp"], jnp.asarray(s["toks"]), enc,
                                  s["jcfg"])
    got = encdec.decode_forward(s["tp"], torch.from_numpy(s["toks"]),
                                torch.tensor(_np(enc)), s["tcfg"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_init_cache_matches_reference(setup):
    """The encoder's cross-K/V of every layer, and zeroed self-KV caches of
    ``max_seq`` positions."""
    s = setup
    batch = {"tokens": s["toks"][:, :12], "frames": s["frames"]}
    want = s["jmodel"].init_cache(
        s["jp"], {k: jnp.asarray(v) for k, v in batch.items()}, 2, 32)
    got = s["tmodel"].init_cache(
        s["tp"], {k: torch.from_numpy(v) for k, v in batch.items()}, 2, 32)
    for part, keys in (("cross", ("xk", "xv")), ("self", ("k", "v"))):
        for k in keys:
            assert tuple(got[part][k].shape) == want[part][k].shape
            np.testing.assert_allclose(got[part][k].numpy(),
                                       _np(want[part][k]), **TOL)
    assert not got["self"]["k"].any()


def test_decode_steps_match_reference(setup):
    """The self-KV filled step by step from length 0 (as the reference's
    test drives it), then 3 greedy steps: every step's logits within 1e-4
    of the reference's and the same greedy tokens."""
    s = setup
    jb = {"tokens": jnp.asarray(s["toks"][:, :12]),
          "frames": jnp.asarray(s["frames"])}
    tb = {"tokens": torch.from_numpy(s["toks"][:, :12]),
          "frames": torch.from_numpy(s["frames"])}
    jc = s["jmodel"].init_cache(s["jp"], jb, 2, 32)
    tc = s["tmodel"].init_cache(s["tp"], tb, 2, 32)
    jlen, tlen = jnp.zeros((2,), jnp.int32), torch.zeros(2, dtype=torch.int32)
    jtok, ttok = jnp.asarray(s["toks"][:, :1]), torch.from_numpy(
        s["toks"][:, :1])
    for t in range(15):
        jl, jc = s["jmodel"].decode_step(s["jp"], jc, jtok, jlen)
        tl, tc = s["tmodel"].decode_step(s["tp"], tc, ttok, tlen)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
        jlen, tlen = jlen + 1, tlen + 1
        if t + 1 < 12:
            jtok = jnp.asarray(s["toks"][:, t + 1:t + 2])
            ttok = torch.from_numpy(s["toks"][:, t + 1:t + 2])
        else:
            jtok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
            ttok = tl.argmax(-1)[:, None]
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tc["self"]["k"].numpy(),
                               _np(jc["self"]["k"]), **TOL)


def test_decode_matches_teacher_forcing(setup):
    """The reference's check (``tests/test_arch_smoke.py::
    test_whisper_decode_matches_teacher_forcing``) through the port: the
    prefix fed through decode steps, the last step's logits within 5e-4 of
    the teacher-forced decoder's at that position."""
    s = setup
    cfg, model, p = s["tcfg"], s["tmodel"], s["tp"]
    B, S = 2, 12
    toks, frames = torch.from_numpy(s["toks"]), torch.from_numpy(
        s["frames"])
    cache = model.init_cache(p, {"tokens": toks[:, :S], "frames": frames},
                             B, 32)
    lengths = torch.zeros((B,), dtype=torch.int32)
    for t in range(S + 1):
        lg, cache = model.decode_step(p, cache, toks[:, t:t + 1], lengths)
        lengths = lengths + 1
    ref = encdec.decode_forward(p, toks, encdec.encode(p, frames, cfg), cfg)
    assert float((lg - ref[:, S]).abs().max()) < 5e-4


def test_prefill_returns_the_cache_unfilled(setup):
    """As in the reference (its ``api.py``): prefill runs the encoder again
    and the teacher-forced decoder and returns the last position's logits
    with the cache as it came, the self-KV still zero."""
    s = setup
    batch = {"tokens": torch.from_numpy(s["toks"][:, :12]),
             "frames": torch.from_numpy(s["frames"])}
    cache = s["tmodel"].init_cache(s["tp"], batch, 2, 32)
    before = {k: v.clone() for k, v in cache["cross"].items()}
    logits, out = s["tmodel"].prefill(s["tp"], batch, cache)
    assert out is cache and not out["self"]["k"].any() \
        and not out["self"]["v"].any()
    assert all(torch.equal(out["cross"][k], before[k]) for k in before)
    want, _ = s["jmodel"].prefill(
        s["jp"], {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
        s["jmodel"].init_cache(s["jp"], {k: jnp.asarray(v.numpy())
                                         for k, v in batch.items()}, 2, 32))
    np.testing.assert_allclose(logits.numpy(), _np(want), **TOL)


def test_input_specs_add_frames():
    """``input_specs`` gives ``frames`` [B, 1500, d] in the compute dtype
    beside the tokens, for prefill and decode, as the reference's does."""
    model = build_model(get_arch(ARCH), "meta")
    for kind, tok_shape in (("prefill", (1, 64)), ("decode", (1, 1))):
        shape = type("S", (), dict(seq_len=64, global_batch=1, kind=kind))
        spec = model.input_specs(shape)
        assert tuple(spec["tokens"].shape) == tok_shape
        assert tuple(spec["frames"].shape) == (1, 1500, 1280)
        assert spec["frames"].dtype == torch.bfloat16
        assert spec["frames"].device.type == "meta"


def test_the_path_calls_the_attention_kernels(setup, monkeypatch):
    """One ``flash_attention`` call an encoder layer (Sq = Skv = frames,
    not causal), a decoder layer's self-attention (causal) and its
    cross-attention (Sq = tokens, Skv = frames, not causal); decode's
    cross-attention is ``flash_decode`` over all frames."""
    s = setup
    seen = []
    fa, fd = ops.flash_attention, ops.flash_decode

    # whisper's attention takes the kernels' own 1/sqrt(D) (no scale)
    def rec_fa(q, k, v, *, causal=True, scale=None):
        assert scale is None
        seen.append(("fa", q.shape[2], k.shape[2], causal))
        return fa(q, k, v, causal=causal)

    def rec_fd(q, k, v, lengths, scale=None):
        assert scale is None
        seen.append(("fd", k.shape[2], tuple(lengths.tolist())))
        return fd(q, k, v, lengths)

    monkeypatch.setattr(ops, "flash_attention", rec_fa)
    monkeypatch.setattr(ops, "flash_decode", rec_fd)
    L, T = s["tcfg"].n_layers, s["tcfg"].enc_dec.n_frames
    batch = {"tokens": torch.from_numpy(s["toks"][:, :12]),
             "frames": torch.from_numpy(s["frames"])}
    cache = s["tmodel"].init_cache(s["tp"], batch, 2, 16)
    s["tmodel"].prefill(s["tp"], batch, cache)
    assert seen == [("fa", T, T, False)] * L * 2 + [
        ("fa", 12, 12, True), ("fa", 12, T, False)] * L
    seen.clear()
    s["tmodel"].decode_step(s["tp"], cache, batch["tokens"][:, :1],
                            torch.zeros(2, dtype=torch.int32))
    assert seen == [("fd", 16, (1, 1)), ("fd", T, (T, T))] * L


def test_full_width_on_meta():
    """whisper-large-v3 at its published config builds on the meta device
    (about 1.54B parameters, 32 + 32 layers) and traces init_cache,
    prefill and a decode step there."""
    cfg = get_arch(ARCH)
    model = build_model(cfg, "meta")
    p = model.abstract_params()
    n = sum(t.numel() for t in flatten(p).values())
    assert 1.5e9 < n < 1.6e9
    shape = type("S", (), dict(seq_len=64, global_batch=1, kind="prefill"))
    batch = model.input_specs(shape)
    cache = model.init_cache(p, batch, 1, 80)
    assert tuple(cache["cross"]["xk"].shape) == (32, 1, 1500, 20, 64)
    logits, _ = model.prefill(p, batch, cache)
    assert tuple(logits.shape) == (1, cfg.vocab)
    logits, _ = model.decode_step(p, cache, batch["tokens"][:, :1],
                                  torch.zeros(1, dtype=torch.int32,
                                              device="meta"))
    assert tuple(logits.shape) == (1, cfg.vocab)

