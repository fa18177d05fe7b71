"""The port's LM (dense, MoE with GQA or MLA), the hybrid (Mamba2 with a
shared attention block), RWKV6 and the whisper encoder-decoder against the
JAX reference model.

Weights come from the reference's own ``init`` and are carried across by
``repro_torch.bridge.params_from_jax``; prefill logits and 4 greedy decode
steps must agree at 1e-4 in fp32, with equal greedy tokens. The
encoder-decoder's inputs add seeded frames (``frames_for``), and its
prefill returns the cache unfilled in both packages, so its decode steps
attend over a zero self-KV prefix in both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models.api import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.models import hybrid as jhybrid
from repro.models import rwkv6 as jrwkv6
from repro.models import transformer as jtransformer
from repro_torch.bridge import flatten, params_from_jax
from repro_torch.configs import get_arch
from repro_torch.configs import arch_ids
from repro_torch.models import encdec, hybrid, rwkv6, transformer
from repro_torch.models.api import build_model

TOL = dict(rtol=1e-4, atol=1e-4)


def flatten_jax(tree) -> dict:
    """The reference's param pytree as a ``/``-joined dict of numpy."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def reference_and_port(arch: str, **overrides):
    """(reference model, its params, port model, bridged params) of the
    reduced config of ``arch`` with ``overrides`` applied to both."""
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), **overrides)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), **overrides)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tmodel = build_model(tcfg, "cpu")
    return (jmodel, jparams, tmodel,
            params_from_jax(flatten_jax(jparams), "cpu"))


def frames_for(cfg, B: int):
    """The audio family's seeded frames [B, n_frames, d] (numpy), else
    None."""
    if cfg.enc_dec is None:
        return None
    return (np.random.default_rng(11).standard_normal(
        (B, cfg.enc_dec.n_frames, cfg.d_model)) * 0.1).astype(np.float32)


def reference_greedy(jmodel, jparams, prompts: np.ndarray, steps: int):
    """Prefill + ``steps`` greedy decode steps of the reference: the
    logits of every step [steps+1, B, V] and the tokens [B, steps+1]."""
    B, P = prompts.shape
    toks = jnp.asarray(prompts, jnp.int32)
    batch = {"tokens": toks}
    frames = frames_for(jmodel.cfg, B)
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)
    cache = jmodel.init_cache(jparams, batch, B, P + steps)
    logits, cache = jmodel.prefill(jparams, batch, cache)
    out, tok = [logits], jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks_out = [tok]
    lengths = jnp.full((B,), P, jnp.int32)
    for _ in range(steps):
        logits, cache = jmodel.decode_step(jparams, cache, tok, lengths)
        out.append(logits)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks_out.append(tok)
        lengths = lengths + 1
    return (np.stack([np.asarray(o) for o in out]),
            np.concatenate([np.asarray(t) for t in toks_out], axis=1))


def port_greedy(tmodel, tparams, prompts: np.ndarray, steps: int):
    B, P = prompts.shape
    toks = torch.from_numpy(prompts).long()
    batch = {"tokens": toks}
    frames = frames_for(tmodel.cfg, B)
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames)
    cache = tmodel.init_cache(tparams, batch, B, P + steps)
    logits, cache = tmodel.prefill(tparams, batch, cache)
    out, tok = [logits], logits.argmax(-1)[:, None]
    toks_out = [tok]
    lengths = torch.full((B,), P, dtype=torch.int32)
    for _ in range(steps):
        logits, cache = tmodel.decode_step(tparams, cache, tok, lengths)
        out.append(logits)
        tok = logits.argmax(-1)[:, None]
        toks_out.append(tok)
        lengths = lengths + 1
    return (torch.stack(out).numpy(), torch.cat(toks_out, dim=1).numpy())


CASES = {
    "qwen-bias-tied": ("qwen1.5-0.5b", {}),
    "chameleon-qknorm-untied": ("chameleon-34b", {}),
    "qwen-gqa-g2": ("qwen1.5-0.5b", {"kv_heads": 2}),
    "grok-moe-gqa": ("grok-1-314b", {}),
    "deepseek-moe-mla": ("deepseek-v3-671b", {}),
    "zamba2-hybrid": ("zamba2-2.7b", {}),
    "stablelm-layernorm-gqa": ("stablelm-12b", {}),
    "starcoder2-bias-gelu": ("starcoder2-15b", {}),
    "codeqwen-bias-theta": ("codeqwen1.5-7b", {}),
    "rwkv6-ssm": ("rwkv6-3b", {}),
    "whisper-encdec": ("whisper-large-v3", {}),
}


def full_forwards(cfg):
    """(reference, port) full-sequence forwards of ``cfg``'s family, each
    (params, tokens, cfg) -> logits [B,S,V]."""
    if cfg.family == "hybrid":
        return (lambda p, t, c: jhybrid.hybrid_forward(p, t, c)[0],
                hybrid.hybrid_forward)
    if cfg.family == "ssm":
        return (lambda p, t, c: jrwkv6.rwkv6_lm_apply(p, t, c)[0],
                lambda p, t, c: rwkv6.rwkv6_lm_apply(p, t, c)[0])
    if cfg.family == "audio":
        fr = frames_for(cfg, 2)
        return (lambda p, t, c: jencdec.decode_forward(
                    p, t, jencdec.encode(p, jnp.asarray(fr), c), c),
                lambda p, t, c: encdec.decode_forward(
                    p, t, encdec.encode(p, torch.from_numpy(fr), c), c))
    return (lambda p, t, c: jtransformer.lm_forward(p, t, c)[0],
            transformer.lm_forward)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_greedy_decode_match_reference(case):
    arch, over = CASES[case]
    jmodel, jparams, tmodel, tparams = reference_and_port(arch, **over)
    prompts = np.random.default_rng(7).integers(
        0, tmodel.cfg.vocab, size=(2, 12))
    want_logits, want_toks = reference_greedy(jmodel, jparams, prompts, 4)
    got_logits, got_toks = port_greedy(tmodel, tparams, prompts, 4)
    assert got_logits.dtype == np.float32
    np.testing.assert_allclose(got_logits, want_logits, **TOL)
    np.testing.assert_array_equal(got_toks, want_toks)


@pytest.mark.parametrize("case", list(CASES))
def test_full_forward_matches_reference(case):
    """lm_forward (hybrid_forward for the hybrid, rwkv6_lm_apply for
    RWKV6, encode and decode_forward for the encoder-decoder) against the
    reference's forward."""
    arch, over = CASES[case]
    jmodel, jparams, tmodel, tparams = reference_and_port(arch, **over)
    toks = np.random.default_rng(8).integers(0, tmodel.cfg.vocab, (2, 40))
    jforward, forward = full_forwards(tmodel.cfg)
    want = jforward(jparams, jnp.asarray(toks, jnp.int32), jmodel.cfg)
    got = forward(tparams, torch.from_numpy(toks).long(), tmodel.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "chameleon-34b",
                                  "starcoder2-15b", "grok-1-314b",
                                  "deepseek-v3-671b", "zamba2-2.7b",
                                  "rwkv6-3b", "whisper-large-v3"])
def test_bridge_is_one_to_one(arch):
    """Every reference key lands in the port under the same name and
    shape, and the port's own init has exactly the same keys."""
    jcfg = jget_arch(arch).reduced()
    flat = flatten_jax(jbuild_model(jcfg).init(jax.random.key(1)))
    bridged = flatten(params_from_jax(flat, "cpu"))
    assert bridged.keys() == flat.keys()
    for key, arr in flat.items():
        assert tuple(bridged[key].shape) == arr.shape, key
        np.testing.assert_array_equal(bridged[key].numpy(), arr)
    own = build_model(get_arch(arch).reduced(), "cpu").init(
        torch.Generator().manual_seed(0))
    own_flat = flatten(own)
    assert own_flat.keys() == flat.keys()
    assert {k: tuple(v.shape) for k, v in own_flat.items()} == \
        {k: a.shape for k, a in flat.items()}


def test_bf16_bridge_keeps_values():
    flat = {"w": np.asarray(jnp.asarray([[1.5, -2.25]], jnp.bfloat16))}
    t = params_from_jax(flat, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == [[1.5, -2.25]]


@pytest.mark.parametrize("arch", arch_ids())
def test_build_model_builds_every_arch(arch):
    """``build_model`` builds all ten archs, of all six families, at their
    published configs on the meta device: parameters with the reference's
    count, inputs (with ``frames`` for the audio family) and a cache."""
    cfg = get_arch(arch)
    model = build_model(cfg, "meta")
    assert model.family == cfg.family == jget_arch(arch).family
    p = model.abstract_params()
    n = sum(t.numel() for t in flatten(p).values())
    assert n > 0 and all(t.device.type == "meta"
                         for t in flatten(p).values())
    shape = type("S", (), dict(seq_len=16, global_batch=1, kind="prefill"))
    batch = model.input_specs(shape)
    assert ("frames" in batch) == (cfg.family == "audio")
    assert model.init_cache(p, batch, 1, 32)
