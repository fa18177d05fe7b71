"""Each family's training loss and its gradients against the reference's.

Weights come from the reference's ``init`` through
``repro_torch.bridge``; tokens, targets and frames from a numpy seed. The
port's loss (``Model.loss``, and the family function under remat "none"
and "full") and the gradient of every parameter leaf are held to
``jax.value_and_grad`` of the reference's ``model.loss`` at the reduced
configs in fp32: the loss at 1e-4, each leaf's gradient at 1e-4 of that
leaf's largest gradient. Families: dense qwen, moe grok (GQA) and deepseek
(MLA) with the load-balance and z aux losses, hybrid zamba2, ssm rwkv6,
audio whisper; and deepseek's MTP head. Remat "full" and "dots" give the
grads of "none"."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro_torch.bridge import flatten, params_from_jax
from repro_torch.models import encdec, hybrid, rwkv6, transformer
from repro_torch.models.api import _plain_ce
from test_torch_model import flatten_jax, frames_for, reference_and_port

ARCHS = ["qwen1.5-0.5b", "grok-1-314b", "deepseek-v3-671b", "zamba2-2.7b",
         "rwkv6-3b", "whisper-large-v3"]
B, S = 2, 32


def batches(cfg, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    tg = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg)}
    tb = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tg)}
    fr = frames_for(cfg, B)
    if fr is not None:
        jb["frames"], tb["frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    return jb, tb


def family_loss(cfg, params, batch, remat):
    """The port's family loss under ``remat``, as ``Model.loss`` builds
    it (which fixes remat "full")."""
    if cfg.family == "hybrid":
        return _plain_ce(hybrid.hybrid_forward(params, batch["tokens"], cfg,
                                               remat=remat),
                         batch["targets"])
    if cfg.family == "ssm":
        logits, _ = rwkv6.rwkv6_lm_apply(params, batch["tokens"], cfg,
                                         remat=remat)
        return _plain_ce(logits, batch["targets"])
    if cfg.family == "audio":
        return encdec.encdec_loss(params, batch["frames"], batch["tokens"],
                                  batch["targets"], cfg, remat=remat)
    return transformer.lm_loss(params, batch["tokens"], batch["targets"],
                               cfg, remat=remat)


def port_value_and_grad(fn, params):
    leaves = flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, metrics = fn(params)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), metrics, dict(zip(leaves, grads))


def assert_grads_close(got: dict, want: dict, rel=1e-4):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, f"{k}: {err:.3g} vs scale {scale:.3g}"


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    jm, jp, tm, tp = reference_and_port(request.param)
    jb, tb = batches(tm.cfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    return {"tm": tm, "tp": tp, "tb": tb, "loss": float(jl),
            "metrics": {k: float(v) for k, v in jmet.items()},
            "grads": flatten_jax(jg)}


def test_model_loss_matches_reference(case):
    loss, metrics, grads = port_value_and_grad(
        lambda p: case["tm"].loss(p, case["tb"]), case["tp"])
    assert abs(float(loss) - case["loss"]) <= 1e-4
    assert set(metrics) == set(case["metrics"])
    for k, v in case["metrics"].items():
        got = float(metrics[k].detach())
        assert abs(got - v) <= 1e-4 * max(1.0, abs(v)), k
    assert_grads_close(grads, case["grads"])
    assert all(float(g.abs().max()) > 0 for g in grads.values())


@pytest.mark.parametrize("remat", ["none", "full"])
def test_family_loss_under_remat_matches_reference(case, remat):
    cfg = case["tm"].cfg
    loss, _, grads = port_value_and_grad(
        lambda p: family_loss(cfg, p, case["tb"], remat), case["tp"])
    assert abs(float(loss) - case["loss"]) <= 1e-4
    assert_grads_close(grads, case["grads"])


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v3-671b"])
def test_remat_gives_the_grads_of_none(arch):
    _, _, tm, tp = reference_and_port(arch)
    _, tb = batches(tm.cfg, seed=6)
    out = {r: port_value_and_grad(
        lambda p: family_loss(tm.cfg, p, tb, r), tp) for r in
        ("none", "full", "dots")}
    for r in ("full", "dots"):
        assert float(out[r][0]) == pytest.approx(float(out["none"][0]),
                                                 abs=1e-6)
        for k, g in out["none"][2].items():
            torch.testing.assert_close(out[r][2][k], g, rtol=1e-6,
                                       atol=1e-7)


def test_lm_loss_needs_a_chunk_that_divides_the_sequence():
    _, _, tm, tp = reference_and_port("qwen1.5-0.5b")
    toks = torch.zeros((1, 24), dtype=torch.long)
    with pytest.raises(ValueError, match="does not divide"):
        transformer.lm_loss(tp, toks, toks, tm.cfg, loss_chunk=16)


def test_chunked_ce_matches_one_chunk():
    """CE over chunks of 8 equals one chunk of the whole sequence, and
    ``lm_forward``'s logits give the same mean CE."""
    _, _, tm, tp = reference_and_port("qwen1.5-0.5b")
    _, tb = batches(tm.cfg)
    a, _ = transformer.lm_loss(tp, tb["tokens"], tb["targets"], tm.cfg,
                               loss_chunk=8)
    b, _ = transformer.lm_loss(tp, tb["tokens"], tb["targets"], tm.cfg,
                               loss_chunk=S)
    c, _ = _plain_ce(transformer.lm_forward(tp, tb["tokens"], tm.cfg),
                     tb["targets"])
    assert float(a) == pytest.approx(float(b), abs=1e-6)
    assert float(a) == pytest.approx(float(c), abs=1e-6)


def test_mtp_loss_and_grads_match_reference():
    jm, jp, tm, tp = reference_and_port("deepseek-v3-671b")
    cfg = tm.cfg
    jmtp = jtransformer.mtp_init(jax.random.key(1), cfg)
    tmtp = params_from_jax(flatten_jax(jmtp), "cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, 16))
    toks = toks.astype(np.int32)
    t2 = np.roll(toks, -2, axis=1)

    def jloss(p, m):
        return jtransformer.mtp_loss(p, m, jnp.asarray(toks), jnp.asarray(t2),
                                     jm.cfg)

    jl, (jgp, jgm) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jmtp)
    both = {"p": tp, "m": tmtp}
    loss, _, grads = port_value_and_grad(
        lambda b: (transformer.mtp_loss(b["p"], b["m"],
                                        torch.from_numpy(toks),
                                        torch.from_numpy(t2), cfg), {}),
        both)
    assert abs(float(loss) - float(jl)) <= 1e-4
    want = {**{f"p/{k}": v for k, v in flatten_jax(jgp).items()},
            **{f"m/{k}": v for k, v in flatten_jax(jgm).items()}}
    assert_grads_close(grads, want)
    shapes = {k: tuple(v.shape) for k, v in flatten(tmtp).items()}
    assert shapes == {k: tuple(np.shape(v))
                      for k, v in flatten_jax(jmtp).items()}
    mtp = transformer.mtp_init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in flatten(mtp).items()} == shapes
