"""The port's hybrid (zamba2: Mamba2 backbone + weight-tied shared
attention block) against the reference, and against itself run step by
step.

Logits parity with the reference at 1e-4 with greedy tokens equal is a
``CASES`` entry of ``tests/test_torch_model.py`` (``zamba2-hybrid``). Here:
the reference's decode-vs-teacher-forcing check
(``tests/test_arch_smoke.py::test_decode_matches_teacher_forcing``, 5e-4)
through the port, chunked against stepwise, the state layout, and the
full-width build on the meta device."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import hybrid as jhybrid
from repro.models.api import build_model as jbuild_model
from repro_torch.bridge import flatten, params_from_jax
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import hybrid
from repro_torch.models.api import build_model

from test_torch_model import flatten_jax


def port(arch="zamba2-2.7b", seed=0, **over):
    """(port model, params bridged from the reference's init) of the
    reduced config, fp32."""
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), **over)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    jparams = jbuild_model(jcfg).init(jax.random.key(seed))
    return (build_model(tcfg, "cpu"),
            params_from_jax(flatten_jax(jparams), "cpu"))


def shapes(tree) -> dict:
    """The ``ShapeDtypeStruct``s of an abstract pytree, by ``/``-joined
    key."""
    return {"/".join(str(k.key) for k in path): leaf for path, leaf
            in jax.tree_util.tree_leaves_with_path(tree)}


def prefill(model, params, toks, max_seq):
    cache = model.init_cache(params, {"tokens": toks}, toks.shape[0],
                             max_seq)
    return model.prefill(params, {"tokens": toks}, cache)


def test_decode_matches_teacher_forcing():
    """The reference's check, run through the port: prefill(S) then
    decode(token S) equals the full forward at position S, within 5e-4."""
    model, params = port()
    cfg = model.cfg
    B, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S + 1)))
    _, cache = prefill(model, params, toks[:, :S], 32)
    lg_dec, _ = model.decode_step(params, cache, toks[:, S:S + 1],
                                  torch.full((B,), S, dtype=torch.int32))
    ref = hybrid.hybrid_forward(params, toks, cfg)
    assert float((lg_dec - ref[:, S]).abs().max()) < 5e-4


@pytest.mark.parametrize("chunk", [16, 5, 1])
def test_chunked_forward_matches_stepwise_decode(chunk):
    """The chunked scan (at the config's chunk, one that shrinks, and
    Q = 1) against the recurrence: one prefill of the first token, then a
    decode step a token; every position's logits within 5e-4 of the
    forward's."""
    model, params = port(ssm=dataclasses.replace(
        get_arch("zamba2-2.7b").reduced().ssm, chunk=chunk))
    cfg = model.cfg
    B, S = 2, 23
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S)))
    full = hybrid.hybrid_forward(params, toks, cfg)
    lg, cache = prefill(model, params, toks[:, :1], S)
    steps = [lg]
    for t in range(1, S):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1],
                                      torch.full((B,), t, dtype=torch.int32))
        steps.append(lg)
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=5e-4,
                               atol=5e-4)


def test_prefill_fills_the_states_like_the_reference():
    """After a prefill the port's state tree, written in place, equals the
    reference's returned one: every layer's conv window and SSD state, and
    every shared-block application's KV cache."""
    jcfg = jget_arch("zamba2-2.7b").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model, params = port()
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 12))
    jc = jmodel.init_cache(jparams, {"tokens": toks}, 2, 20)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, jc)
    _, cache = prefill(model, params, torch.from_numpy(toks), 20)
    want = flatten_jax(jc)
    got = {f"{a}/{b}": t for a, sub in cache.items() for b, t in sub.items()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_shared_block_runs_the_attention_kernels_once_a_group():
    """Each application of the shared block is one ``flash_attention`` call
    in prefill and one ``flash_decode`` call a decode step: groups x the
    custom ops' CPU registrations, no CUDA launch."""
    model, params = port()
    cfg = model.cfg
    ng = cfg.n_layers // cfg.hybrid.shared_attn_every
    calls = {"flash_attention": 0, "flash_decode": 0}
    saved = ops.flash_attention, ops.flash_decode

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    ops.flash_attention = counted("flash_attention", saved[0])
    ops.flash_decode = counted("flash_decode", saved[1])
    try:
        toks = torch.zeros((1, 8), dtype=torch.long)
        lg, cache = prefill(model, params, toks, 10)
        model.decode_step(params, cache, lg.argmax(-1)[:, None],
                          torch.full((1,), 8, dtype=torch.int32))
    finally:
        ops.flash_attention, ops.flash_decode = saved
    assert calls == {"flash_attention": ng, "flash_decode": ng}
    assert ops.launch_counts()["flash_attention"] == 0


def test_full_width_on_meta():
    """zamba2-2.7b at its published config on the meta device: the
    reference's parameter and state shapes, fp32 SSD parameters under
    bf16 weights, head dim 80, and a prefill and decode step traced."""
    jcfg = jget_arch("zamba2-2.7b")
    cfg = get_arch("zamba2-2.7b")
    assert cfg.resolved_head_dim == 80
    model = build_model(cfg, "meta")
    params = model.abstract_params()
    flat = shapes(jax.eval_shape(
        lambda: jbuild_model(jcfg).init(jax.random.key(0))))
    got = flatten(params)
    assert got.keys() == flat.keys()
    for k, w in flat.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
    assert got["layers/m/A_log"].dtype == torch.float32
    assert got["layers/m/in_proj"].dtype == torch.bfloat16
    cache = model.init_cache(params, None, 1, 2048 + 128)
    jstates = jax.eval_shape(lambda: jhybrid.hybrid_states(jcfg, 1, 2176))
    for k, w in shapes(jstates).items():
        a, b = k.split("/")
        assert tuple(cache[a][b].shape) == w.shape, k
    from repro_torch.analysis.calibrate import _CalibShape
    pre = model.input_specs(_CalibShape(64, "prefill"))
    dec = model.input_specs(_CalibShape(64, "decode"))
    small = model.init_cache(params, pre, 1, 80)
    logits, small = model.prefill(params, pre, small)
    assert logits.shape == (1, cfg.vocab) and logits.device.type == "meta"
    logits, _ = model.decode_step(params, small, dec["tokens"],
                                  dec["lengths"])
    assert logits.shape == (1, cfg.vocab)


def test_bf16_reduced_serving_stays_finite():
    """The reduced config in bf16 (weights and compute), as it would be
    served: prefill and decode logits finite and fp32, states fp32."""
    model, params = port(param_dtype="bfloat16", compute_dtype="bfloat16")
    assert params["layers"]["m"]["in_proj"].dtype == torch.bfloat16
    assert params["layers"]["m"]["A_log"].dtype == torch.float32
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, model.cfg.vocab, (2, 19)))
    lg, cache = prefill(model, params, toks, 24)
    lg2, cache = model.decode_step(params, cache, lg.argmax(-1)[:, None],
                                   torch.full((2,), 19, dtype=torch.int32))
    assert lg.dtype == lg2.dtype == torch.float32
    assert torch.isfinite(lg).all() and torch.isfinite(lg2).all()
    assert cache["mamba"]["h"].dtype == torch.float32
    assert cache["kv"]["k"].dtype == torch.bfloat16
