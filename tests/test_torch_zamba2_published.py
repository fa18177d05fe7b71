"""The published Zamba2 block of the port's hybrid (``HybridConfig.
layer_ids`` given) at a tiny size on the CPU, in fp32: the port's prefill
and cached decode against the benchmark's plain reference
(``portbench/reference/zamba2_hybrid.py``), the reference against
``transformers``' ``Zamba2ForCausalLM``, the counts against
``FlopCounterMode``, the kernels' score scale on their plain versions, and
the hybrid's spans.

The tiny model keeps the published relations: two alternating shared
blocks over four hybrid layers, heads of 2 d / H, scores scaled by
(head_dim / 2)^-1/2, an MLP adapter a hybrid layer, tied embeddings.
"""
import math
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import weights  # noqa: E402
from portbench.counts import zamba2_hybrid as counts  # noqa: E402
from portbench.harness import arch_config  # noqa: E402
from portbench.reference import zamba2_hybrid as ref  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.analysis import differential  # noqa: E402,F401
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

LAYER_IDS = [1, 3, 5, 8]
CHUNK = 16
# fp32 on both sides: they differ only in the order of their sums (the
# port's chunked scan and cached decode against the quadratic SSD and the
# full recomputation), each a few ulps; dropping e from the block's input
# or scaling the scores by D^-1/2 moves the logits by over 1e-2
TOL = 1e-4


def tiny_model() -> dict:
    d, H = 64, 4
    return {"name": "zamba2-tiny", "family": "hybrid", "n_layers": 10,
            "d_model": d, "n_heads": H, "kv_heads": H, "head_dim": 2 * d // H,
            "d_ff": 128, "vocab": 256, "act": "gelu_exact", "glu": True,
            "norm": "rmsnorm", "attention": "gqa", "tie_embeddings": True,
            "ssm": {"d_state": 16, "expand": 2, "head_dim": 16,
                    "conv_kernel": 4, "n_groups": 1, "chunk": CHUNK,
                    "norm_eps": 1e-5},
            "hybrid": {"shared_attn_every": 5, "layer_ids": LAYER_IDS,
                       "n_blocks": 2, "adapter_rank": 8},
            "param_dtype": "float32", "compute_dtype": "float32"}


def make_weights(m, seed=0, draws=None):
    gen = torch.Generator().manual_seed(seed)
    return weights.make(draws or ref.param_draws(m), m["param_dtype"], gen,
                        "cpu"), gen


def served(S: int, steps: int, seed: int = 0):
    """(model dict, weights, prompt, the port's logits of its prefill and
    ``steps`` decode steps through the cache, its greedy tokens)."""
    m = tiny_model()
    model = build_model(arch_config(m), "cpu")
    p, gen = make_weights(m, seed)
    weights.check_layout(p, model.abstract_params())
    prompt = torch.randint(0, m["vocab"], (1, S), generator=gen)
    cache = model.init_cache(p, {"tokens": prompt}, 1, S + steps + 1)
    lg, cache = model.prefill(p, {"tokens": prompt}, cache)
    out, toks = [lg[0]], [int(lg.argmax(-1))]
    for i in range(steps):
        lg, cache = model.decode_step(
            p, cache, torch.tensor([[toks[-1]]]),
            torch.full((1,), S + i, dtype=torch.int32))
        out.append(lg[0])
        toks.append(int(lg.argmax(-1)))
    return m, p, prompt[0], torch.stack(out), toks


def gap(a, b) -> float:
    """Largest difference, as a share of max(1, the largest |logit|)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def reference_of(m, p, prompt, toks):
    S = len(prompt)
    seq = torch.cat([prompt, torch.tensor(toks[:-1])])
    rows = torch.arange(S - 1, S - 1 + len(toks))
    return ref.logits(p, m, [seq], [rows])[0]


# S 40: the chunk rule scans 4 chunks of 10 (16 does not divide 40); S 37:
# 37 chunks of one (prime); S 12: one chunk shorter than CHUNK
@pytest.mark.parametrize("S", [40, 37, 12])
def test_prefill_and_decode_match_the_reference(S):
    m, p, prompt, port, toks = served(S, steps=6)
    want = reference_of(m, p, prompt, toks)
    assert gap(port, want) <= TOL
    assert want.argmax(-1).tolist() == toks


def test_the_forward_matches_the_reference():
    m = tiny_model()
    p, gen = make_weights(m, 1)
    seq = torch.randint(0, m["vocab"], (40,), generator=gen)
    from repro_torch.models.hybrid import hybrid_forward
    got = hybrid_forward(p, seq[None], arch_config(m))[0]
    want = ref.logits(p, m, [seq], [torch.arange(40)])[0]
    assert gap(got, want) <= TOL


def test_dropping_the_embedding_from_the_block_input_fails(monkeypatch):
    m, p, prompt, port, toks = served(40, steps=6)
    monkeypatch.setattr(ref, "block_input", lambda x, e: torch.cat(
        [x, torch.zeros_like(e)], dim=-1))
    assert gap(port, reference_of(m, p, prompt, toks)) > TOL


def test_the_head_dim_score_scale_fails(monkeypatch):
    m, p, prompt, port, toks = served(40, steps=6)
    monkeypatch.setattr(ref, "score_scale", lambda hd: hd ** -0.5)
    assert gap(port, reference_of(m, p, prompt, toks)) > TOL


# --------------------------------------------------------- transformers


def _hf_model(m, p, time_step_min):
    from transformers import Zamba2Config, Zamba2ForCausalLM
    h, L = m["hybrid"], m["n_layers"]
    types = ["hybrid" if i in h["layer_ids"] else "mamba" for i in range(L)]
    s = m["ssm"]
    cfg = Zamba2Config(
        vocab_size=m["vocab"], hidden_size=m["d_model"], num_hidden_layers=L,
        layers_block_type=types, mamba_d_state=s["d_state"],
        mamba_d_conv=s["conv_kernel"], mamba_expand=s["expand"],
        mamba_ngroups=s["n_groups"],
        n_mamba_heads=s["expand"] * m["d_model"] // s["head_dim"],
        chunk_size=s["chunk"], intermediate_size=m["d_ff"],
        hidden_act="gelu", num_attention_heads=m["n_heads"],
        num_key_value_heads=m["kv_heads"], num_mem_blocks=h["n_blocks"],
        use_shared_attention_adapter=False, adapter_rank=h["adapter_rank"],
        use_mem_rope=False, rms_norm_eps=1e-5, tie_word_embeddings=True,
        time_step_min=time_step_min, attn_implementation="eager")
    model = Zamba2ForCausalLM(cfg).eval()

    def t(w):
        return w.T.contiguous()

    sd = {"model.embed_tokens.weight": p["embed"],
          "lm_head.weight": p["embed"],
          "model.final_layernorm.weight": p["final_norm"]["scale"]}
    blk, apps, k = p["blocks"], p["apps"], 0
    for i in range(L):
        pre = f"model.layers.{i}." + (
            "mamba_decoder." if types[i] == "hybrid" else "")
        lm = {n: v[i] for n, v in p["layers"]["m"].items()}
        sd.update({
            pre + "input_layernorm.weight": p["layers"]["norm"]["scale"][i],
            pre + "mamba.in_proj.weight": t(lm["in_proj"]),
            pre + "mamba.conv1d.weight": t(lm["conv_w"])[:, None, :],
            pre + "mamba.conv1d.bias": lm["conv_b"],
            pre + "mamba.dt_bias": lm["dt_bias"],
            pre + "mamba.A_log": lm["A_log"], pre + "mamba.D": lm["D"],
            pre + "mamba.norm.weight": lm["out_norm"],
            pre + "mamba.out_proj.weight": t(lm["out_proj"])})
        if types[i] != "hybrid":
            continue
        b, st = k % h["n_blocks"], f"model.layers.{i}.shared_transformer."
        for n, hn in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                      ("wo", "o_proj")):
            sd[st + f"self_attn.{hn}.weight"] = t(blk["attn"][n]["w"][b])
        ad = st + f"feed_forward.gate_up_proj_adapter_list.{k}."
        sd.update({
            st + "feed_forward.gate_up_proj.weight":
                t(blk["mlp"]["gate_up"]["w"][b]),
            st + "feed_forward.down_proj.weight":
                t(blk["mlp"]["down"]["w"][b]),
            ad + "0.weight": t(apps["adapter_a"]["w"][k]),
            ad + "1.weight": t(apps["adapter_b"]["w"][k]),
            st + "input_layernorm.weight": blk["norm1"]["scale"][b],
            st + "pre_ff_layernorm.weight": blk["norm2"]["scale"][b],
            f"model.layers.{i}.linear.weight": t(apps["linear"]["w"][k])})
        k += 1
    # a shared block's modules appear under every layer that applies it:
    # each leaf is loaded through one of its names
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected
    loaded = {id(v) for n, v in model.state_dict(keep_vars=True).items()
              if n in sd}
    assert all(id(v) in loaded for n, v in
               model.state_dict(keep_vars=True).items() if n in missing)
    return model


def _hf_logits(model, ids, first: int):
    """Every position's logits: a prefill of the first ``first`` tokens,
    then one token at a time through the model's cache."""
    with torch.no_grad():
        out = model(ids[:, :first], use_cache=True)
        got, cache = [out.logits[0]], out.past_key_values
        for t in range(first, ids.shape[1]):
            out = model(ids[:, t:t + 1], past_key_values=cache,
                        use_cache=True, cache_position=torch.tensor([t]))
            got.append(out.logits[0])
            cache = out.past_key_values
    return torch.cat(got)


def test_the_reference_matches_transformers():
    """``Zamba2ForCausalLM``'s plain PyTorch path, the weights copied
    across, over 40 positions (three chunks of 16, the last partial). Its
    chunked prefill sums the chunks' decay over the wrong axis
    (``modeling_zamba2.py``: ``.sum(dim=2)`` where ``modeling_mamba2.py``
    sums over the source chunk), so it is right within one chunk only:
    it prefills one chunk and runs the others one token at a time through
    its cache, its recurrent step. dt_bias draws dt over [0.05, 0.2], and
    the same model with its clamp at 1e-30 gives the same logits: its
    clamp at ``time_step_min`` (1e-3) does not bind."""
    pytest.importorskip("transformers")
    m = tiny_model()
    draws = ref.param_draws(m)
    shape = draws["layers/m/dt_bias"][0]
    draws["layers/m/dt_bias"] = (shape, "float32", (
        "dt_bias", math.log(0.05), math.log(0.2)))
    p, gen = make_weights(m, 2, draws)
    ids = torch.randint(0, m["vocab"], (1, 40), generator=gen)
    hf = _hf_logits(_hf_model(m, p, 1e-3), ids, CHUNK)
    assert torch.equal(hf, _hf_logits(_hf_model(m, p, 1e-30), ids, CHUNK))
    want = ref.logits(p, m, [ids[0]], [torch.arange(40)])[0]
    # fp32 on both sides, the sums in other orders
    assert gap(hf, want) <= 1e-5


# ---------------------------------------------------------------- counts


def test_counts_agree_with_the_flop_counter():
    """The counts against ``FlopCounterMode`` over the port's own calls,
    exact (margin 1e-9) once the known differences are put back. The
    kernels' custom ops count through the flop formulas that
    ``analysis.differential`` registers (imported above, so that the
    count does not depend on what else the process imported): over all
    S x S pairs in prefill, where the counts take the causal half, and
    over the whole cache in decode, where they take the positions
    attended. The program's Mamba2 prefill projects its input twice (once
    for the conv window, once in the forward), and the decode step's conv
    is a product of K the counter sees and the counts leave out."""
    m = tiny_model()
    model = build_model(arch_config(m), "cpu")
    p, gen = make_weights(m)
    S, max_seq = 40, 42
    toks = torch.randint(0, m["vocab"], (1, S), generator=gen)
    cache = model.init_cache(p, {"tokens": toks}, 1, max_seq)
    with FlopCounterMode(display=False) as fc:
        lg, cache = model.prefill(p, {"tokens": toks}, cache)
    H, hd, n_att = m["n_heads"], m["head_dim"], counts.attention_calls(m)
    d_in, nh, _, N, G, conv_ch, K = counts._ssm(m)
    in_proj = 2.0 * m["d_model"] * (2 * d_in + 2 * G * N + nh)
    want = counts.prefill_flops(m, S, causal_half=False) \
        + m["n_layers"] * S * in_proj
    assert fc.get_total_flops() == pytest.approx(want, rel=1e-9)
    assert counts.prefill_flops(m, S) < counts.prefill_flops(
        m, S, causal_half=False)
    with FlopCounterMode(display=False) as fc:
        model.decode_step(p, cache, lg.argmax(-1)[:, None],
                          torch.full((1,), S, dtype=torch.int32))
    whole_cache = n_att * 4.0 * H * (max_seq - (S + 1)) * hd
    conv = m["n_layers"] * 2.0 * K * conv_ch
    assert fc.get_total_flops() == pytest.approx(
        counts.decode_flops(m, S + 1) + whole_cache + conv, rel=1e-9)


def test_weight_bytes_are_every_weight_and_state_bytes_the_cache():
    m = dict(tiny_model(), param_dtype="bfloat16", compute_dtype="bfloat16")
    p, _ = make_weights(m)
    assert counts.weight_bytes(m) == weights.nbytes(p)
    model = build_model(arch_config(m), "cpu")
    L_pos = 30
    cache = model.init_cache(p, {}, 1, L_pos)
    state = sum(t.numel() * t.element_size()
                for t in cache["mamba"].values())
    kv = sum(t.numel() * t.element_size() for t in cache["kv"].values())
    assert counts.request_bytes(m, L_pos) == 2 * m["d_model"] + 2 * state + kv


def test_the_chunk_rule_is_the_programs():
    from repro_torch.models.mamba2 import _chunk_len
    for S in (1, 12, 37, 40, 256, 512, 509, 704):
        assert counts.chunk_len(S, 256) == _chunk_len(S, 256)


# ------------------------------------------------- the kernels' scale


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_scale_forward_and_backward(causal):
    """A scale s equals the default 1/sqrt(D) on q times s sqrt(D), in the
    forward and in the registered backward (fp64, against autograd of the
    plain version's own ops through ``gradcheck``)."""
    g = torch.Generator().manual_seed(3)
    D, s = 16, 0.3
    q = torch.randn(2, 4, 9, D, generator=g, dtype=torch.float64)
    k = torch.randn(2, 2, 9, D, generator=g, dtype=torch.float64)
    v = torch.randn(2, 2, 9, D, generator=g, dtype=torch.float64)
    got = ops.flash_attention(q, k, v, causal=causal, scale=s)
    want = kref.attention_ref(q * (s * math.sqrt(D)), k, v, causal=causal)
    assert torch.allclose(got, want, atol=1e-12)
    assert not torch.allclose(got, ops.flash_attention(q, k, v,
                                                       causal=causal))
    args = tuple(t.clone().requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.flash_attention(a, b, c, causal=causal,
                                            scale=s), args)


def test_flash_decode_scale():
    g = torch.Generator().manual_seed(4)
    D, s = 16, 0.2
    q = torch.randn(3, 4, D, generator=g)
    k = torch.randn(3, 2, 20, D, generator=g)
    v = torch.randn(3, 2, 20, D, generator=g)
    lengths = torch.tensor([5, 20, 1])
    want_o, want_lse = kref.decode_attention_lse_ref(
        q * (s * math.sqrt(D)), k, v, lengths)
    assert torch.allclose(ops.flash_decode(q, k, v, lengths, scale=s),
                          want_o, atol=1e-6)
    o, lse = ops.flash_decode_lse(q, k, v, lengths, scale=s)
    assert torch.allclose(o, want_o, atol=1e-6)
    assert torch.allclose(lse, want_lse, atol=1e-5)
    with pytest.raises(ValueError):
        from repro_torch.kernels import build
        build.scale_arg(0.0)


# ------------------------------------------------- the decode graphs


def test_the_published_block_takes_the_graph_path():
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    on_card = build_model(arch_config(tiny_model()), "cuda")  # nothing made
    assert on_card.graph_decode and serve.graph_decode(on_card)
    assert not serve.graph_decode(build_model(arch_config(tiny_model()),
                                              "cpu"))
    assert not build_model(get_arch("zamba2-2.7b").reduced(),
                           "cuda").graph_decode


def test_a_prefill_ignores_what_a_former_request_left_in_the_cache():
    """A cache that served one request, prefilled with the next one's
    prompt, holds what a fresh cache holds: the same logits, Mamba2
    states and decode step."""
    m = tiny_model()
    model = build_model(arch_config(m), "cpu")
    p, gen = make_weights(m)
    a, b = (torch.randint(0, m["vocab"], (1, 40), generator=gen)
            for _ in range(2))
    used = model.init_cache(p, {"tokens": a}, 1, 48)
    lg, used = model.prefill(p, {"tokens": a}, used)
    for i in range(3):
        lg, used = model.decode_step(p, used, lg.argmax(-1)[:, None],
                                     torch.full((1,), 40 + i,
                                                dtype=torch.int32))
    assert float(used["mamba"]["h"].abs().max()) > 0
    fresh = model.init_cache(p, {"tokens": b}, 1, 48)
    want, fresh = model.prefill(p, {"tokens": b}, fresh)
    got, used = model.prefill(p, {"tokens": b}, used)
    assert torch.equal(got, want)
    for k in ("conv", "h"):
        assert torch.equal(used["mamba"][k], fresh["mamba"][k])
    tok, n = want.argmax(-1)[:, None], torch.full((1,), 40,
                                                 dtype=torch.int32)
    assert torch.equal(model.decode_step(p, used, tok, n)[0],
                       model.decode_step(p, fresh, tok, n)[0])


class FixedClock:
    """Stands in for the ``time`` module ``launch.serve`` reads: each
    reading advances 5 ms, so every run sees one schedule and draws each
    request's prompt in the same order."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 5e-3
        return self.now


class StandIn:
    """A captured graph's stand-in on the CPU: each replay runs the step."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        self.step()


def _served_by_engine(model, p, graphs: bool, monkeypatch, max_new=6):
    """Eight requests of two prompt lengths through ``RealModelExecutor``
    under ``Engine``, on the slot path or the eager loop: the executor."""
    from repro_torch.launch import serve
    from repro_torch.sched import SpecializedPolicy, Topology
    from repro_torch.sched.engine import Engine, Request, ServeConfig
    P = 40
    monkeypatch.setattr(serve, "time", FixedClock())
    ex = serve.RealModelExecutor(model, p, model.cfg.vocab, P, P + max_new)
    assert (ex.slots is not None) == graphs
    eng = Engine(Topology.serving(n_devices=2, prefill_devices=1),
                 SpecializedPolicy(),
                 cfg=ServeConfig(prefill_chunk=P, decode_batch_max=2),
                 executor=ex)
    m = eng.run([Request(rid=i, arrive_ms=3.0 * i,
                         prompt_len=(P, 29)[i % 2], max_new=max_new)
                 for i in range(8)])
    assert m.completed == 8
    return ex


def test_reused_slots_serve_the_tokens_of_a_fresh_cache(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(serve, "graph_decode", lambda m: m.graph_decode)
    monkeypatch.setattr(serve.SlotPool, "capture",
                        lambda pool, step: StandIn(step))
    m = tiny_model()
    model = build_model(arch_config(m), "cpu")
    p, _ = make_weights(m)
    ex = _served_by_engine(model, p, True, monkeypatch)
    assert 1 < len(ex.slots.slots) < 8
    for rid, prompt in ex.prompts.items():
        toks = torch.as_tensor(prompt[None], dtype=torch.long)
        cache = model.init_cache(p, {"tokens": toks}, 1, 46)
        lg, cache = model.prefill(p, {"tokens": toks}, cache)
        want = [int(lg.argmax(-1))]
        for i in range(5):
            lg, cache = model.decode_step(
                p, cache, torch.tensor([[want[-1]]]),
                torch.full((1,), len(prompt) + i, dtype=torch.int32))
            want.append(int(lg.argmax(-1)))
        assert ex.generated(rid) == want


@pytest.mark.cuda
def test_cuda_graph_tokens_equal_the_eager_loops(monkeypatch):
    """On the card, fp32: each request's decode step the replay of its
    slot's CUDA graph, slots reused, against the eager loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.launch import serve
    torch.backends.cuda.matmul.allow_tf32 = False
    m = tiny_model()
    model = build_model(arch_config(m), "cuda")
    p = weights.make(ref.param_draws(m), m["param_dtype"],
                     torch.Generator(device="cuda").manual_seed(0), "cuda")
    serve.warm_up(model, p, 40, 46)
    got = {}
    for graphs in (True, False):
        monkeypatch.setattr(serve, "graph_decode",
                            lambda mo, g=graphs: g and mo.graph_decode)
        ex = _served_by_engine(model, p, graphs, monkeypatch)
        got[graphs] = {rid: ex.generated(rid) for rid in ex.done}
        if graphs:
            assert 1 < len(ex.slots.slots) < 8
            assert all(s.graph is not None for s in ex.slots.slots)
    assert got[True] == got[False] and len(got[True]) == 8


# ----------------------------------------------------------------- spans


def test_a_traced_prefill_and_decode_record_the_hybrids_spans():
    m = tiny_model()
    model = build_model(arch_config(m), "cpu")
    p, gen = make_weights(m)
    S = 40
    toks = torch.randint(0, m["vocab"], (1, S), generator=gen)
    cache = model.init_cache(p, {"tokens": toks}, 1, S + 2)
    obs.take()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.call("executor.prefill", rid=0, pool="prefill"):
            lg, cache = model.prefill(p, {"tokens": toks}, cache)
        with obs.call("executor.decode", rids=[0], pool="decode"):
            model.decode_step(p, cache, lg.argmax(-1)[:, None],
                              torch.full((1,), S, dtype=torch.int32))
    rec = obs.take()
    L, n_apps = m["n_layers"], len(LAYER_IDS)
    for phase in ("prefill", "decode"):
        mamba = [s.attrs for s in rec.spans if s.name == "model.mamba"
                 and s.attrs["phase"] == phase]
        assert [a["layer"] for a in mamba] == list(range(L))
        shared = [s.attrs for s in rec.spans if s.name == "model.shared"
                  and s.attrs["phase"] == phase]
        assert [(a["application"], a["block"]) for a in shared] == [
            (k, k % 2) for k in range(n_apps)]
    scans = [s for s in rec.spans if s.name == "mamba2.ssd_scan"]
    assert len(scans) == L
    assert all(s.attrs == {"chunks": 4, "chunk_len": 10} for s in scans)
    parents = {s.id: s.name for s in rec.spans}
    assert all(parents[s.parent] == "model.mamba" for s in scans)


def test_the_published_fields_need_layer_ids():
    from repro_torch.configs.base import HybridConfig
    with pytest.raises(ValueError):
        HybridConfig(n_blocks=2)
    assert HybridConfig(layer_ids=[1, 2]).layer_ids == (1, 2)
    assert not HybridConfig().published
