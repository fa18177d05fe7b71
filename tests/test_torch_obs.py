"""The port's span and counter recorder (``repro_torch.obs``) on the CPU:
nothing recorded without a profiler; under one, the executor's, the
decoder layers' and the ``flash_decode`` call's spans nest, count what the
engine counts and sit on the profiler's clock; the kernel launch counters
and the profiler ranges of the train step and the collectives behave as
they did. Also ``RealModelExecutor`` serving each request's own prompt
length."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.dist import collectives
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import RealModelExecutor
from repro_torch.launch.train import main as train_main
from repro_torch.models.api import build_model
from repro_torch.sched import SpecializedPolicy, Topology
from repro_torch.sched.engine import Engine, Request, ServeConfig

P, N = 16, 6


@pytest.fixture(scope="module")
def served():
    """The reduced model of each family that runs ``_serve_layers``."""
    out = {}

    def get(arch):
        if arch not in out:
            cfg = get_arch(arch).reduced()
            model = build_model(cfg, "cpu")
            out[arch] = model, model.init(torch.Generator().manual_seed(0))
        return out[arch]
    return get


def serve(model, params, reqs, max_seq=P + N, batch=4):
    """``reqs`` through ``RealModelExecutor`` under ``Engine`` and
    ``SpecializedPolicy`` on the serving topology: (metrics, executor)."""
    ex = RealModelExecutor(model, params, model.cfg.vocab, P, max_seq)
    eng = Engine(Topology.serving(n_devices=2, prefill_devices=1),
                 SpecializedPolicy(),
                 cfg=ServeConfig(prefill_chunk=P, decode_batch_max=batch),
                 executor=ex)
    return eng.run(reqs), ex


class FixedClock:
    """Stands in for the ``time`` module ``launch.serve`` reads: each
    reading advances 5 ms, so every executor call is charged 5 ms of engine
    time however busy the host is, and the engine's schedule (its steals
    included) does not depend on the host's load."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 5e-3
        return self.now


def requests(n=8, gap_ms=2.0, prompt=(P,)):
    return [Request(rid=i, arrive_ms=i * gap_ms,
                    prompt_len=prompt[i % len(prompt)], max_new=N)
            for i in range(n)]


def profiled(fn):
    """(fn's result, the profile, the recorder's records) of ``fn()`` run
    under a profiler of the host's activity."""
    obs.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, obs.take()


def test_nothing_is_recorded_without_a_profiler(served):
    model, params = served("qwen1.5-0.5b")
    obs.take()
    m, _ = serve(model, params, requests())
    assert m.completed == 8
    rec = obs.take()
    assert rec.spans == [] and rec.offset_ns is None and rec.dropped == 0
    assert not obs.RECORDER.on


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "chameleon-34b",
                                  "grok-1-314b"])
def test_spans_nest_and_count_what_the_engine_counts(served, arch,
                                                     monkeypatch):
    monkeypatch.setattr(serve_mod, "time", FixedClock())
    model, params = served(arch)
    L = model.cfg.n_layers
    (m, _), _, rec = profiled(lambda: serve(model, params, requests()))
    assert m.completed == 8 and rec.spans and rec.dropped == 0
    by_id = {s.id: s for s in rec.spans}
    kids = {}
    for s in rec.spans:
        kids.setdefault(s.parent, []).append(s)
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    calls = [s for s in rec.spans if s.name.startswith("executor.")
             and s.name not in ("executor.sync", "executor.step")]
    assert all(s.parent is None for s in calls)
    for c in calls:
        mine = kids.get(c.id, [])
        phase = c.name.split(".")[1]
        n_req = len(c.attrs["rids"]) if phase == "decode" else 1
        # a decode call's layers run inside each request's executor.step
        steps = [s for s in mine if s.name == "executor.step"]
        assert [s.attrs["rid"] for s in steps] == (
            c.attrs["rids"] if phase == "decode" else [])
        assert all(s.attrs["mode"] == "eager" for s in steps)
        mine = mine + [k for s in steps for k in kids.get(s.id, [])]
        for name in ("model.attn", "model.ffn"):
            layers = sorted(s.attrs["layer"] for s in mine if s.name == name
                            and s.attrs["phase"] == phase)
            assert layers == sorted(list(range(L)) * n_req), (c, name)
        assert [s.name for s in mine if s.name == "executor.sync"] == \
            ["executor.sync"]
        assert c.attrs["pool"] in ("prefill", "decode")
    # executor.decode > executor.step > model.attn > kernels.flash_decode
    fd = [s for s in rec.spans if s.name == "kernels.flash_decode"]
    assert fd and all(by_id[s.parent].name == "model.attn" and
                      by_id[by_id[s.parent].parent].name == "executor.step"
                      and by_id[by_id[by_id[s.parent].parent].parent].name
                      == "executor.decode" for s in fd)
    prefills = [c for c in calls if c.name == "executor.prefill"]
    assert sorted(c.attrs["rid"] for c in prefills) == list(range(8))
    stolen = [c for c in calls if c.name == "executor.decode"
              and c.attrs["pool"] == "prefill"]
    assert m.steals > 0 and len(stolen) == m.steals


def test_spans_sit_on_the_profilers_clock(served):
    """Each span, moved by the recorder's offset, starts and ends within
    0.1 ms of the profiler's range of it, and holds the aten ops that the
    profile puts inside each ``model.attn`` range."""
    model, params = served("qwen1.5-0.5b")
    _, prof, rec = profiled(lambda: serve(model, params, requests(n=2)))
    events = list(prof.profiler.kineto_results.events())
    off = rec.offset_ns
    names = {s.name for s in rec.spans}
    assert {"executor.prefill", "executor.decode", "executor.sync",
            "model.attn", "model.ffn", "kernels.flash_decode"} <= names
    for name in names:
        ranges = sorted((e.start_ns(), e.end_ns()) for e in events
                        if e.name() == name)
        spans = sorted((s.start_ns + off, s.end_ns + off)
                       for s in rec.spans if s.name == name)
        assert len(ranges) == len(spans), name
        for (a, b), (c, d) in zip(ranges, spans):
            assert abs(a - c) <= 100_000 and abs(b - d) <= 100_000, name
    ops_ = [(e.start_ns(), e.end_ns()) for e in events
            if e.name().startswith("aten::")]
    attn = sorted((s.start_ns + off, s.end_ns + off) for s in rec.spans
                  if s.name == "model.attn")
    ranges = sorted((e.start_ns(), e.end_ns()) for e in events
                    if e.name() == "model.attn")
    for (a, b), (c, d) in zip(ranges, attn):
        inside = [(x, y) for x, y in ops_ if a <= x and y <= b]
        assert inside
        held = sum(c <= x and y <= d for x, y in inside)
        assert held >= 0.99 * len(inside)


def test_launch_counters_are_the_recorders():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"flash_attention": 0, "flash_decode": 0,
                                   "chacha20": 0, "mamba2_step": 0}
    for name, mod in ops.KERNEL_MODULES.items():
        assert mod.LAUNCHES == f"kernels.{name}.launches"
    assert not obs.RECORDER.on        # counters count with no profiler
    obs.count("kernels.flash_decode.launches")
    obs.count("kernels.flash_decode.launches", 2)
    obs.count("kernels.chacha20.launches")
    assert ops.launch_counts() == {"flash_attention": 0, "flash_decode": 3,
                                   "chacha20": 1, "mamba2_step": 0}
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
    obs.count("kernels.flash_attention.launches")
    assert obs.take().counters == {"kernels.flash_attention.launches": 1}
    assert set(ops.launch_counts().values()) == {0}


def test_the_five_profiler_ranges_still_appear():
    argv = ["--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--profile-step", "1"]
    names = [e.name for e in train_main(argv).profile.events()]
    for part in ("forward", "backward", "optimizer",
                 "flash_attention backward"):
        assert part in names, part
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with collectives._call():
            assert collectives.in_call()
    assert not collectives.in_call()
    assert "collectives" in [e.name for e in prof.events()]
    obs.take()


def test_spans_record_inside_a_call_under_a_profiler():
    obs.take()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("outside"):
            pass
        with obs.call("outer", k=1):
            with obs.call("inner"):
                with obs.span("leaf"):
                    pass
            assert obs.RECORDER.on
        assert not obs.RECORDER.on
    with obs.call("after"):
        with obs.span("leaf"):
            pass
    spans = {s.name: s for s in obs.take().spans}
    assert set(spans) == {"outer", "inner", "leaf"}
    assert spans["leaf"].parent == spans["inner"].id
    assert spans["inner"].parent == spans["outer"].id
    assert spans["outer"].parent is None and spans["outer"].attrs == {"k": 1}


def test_no_span_records_while_paused_and_counters_still_count():
    obs.take()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.call("outer"):
            with obs.paused():
                assert not obs.RECORDER.on
                with obs.span("hidden"):
                    obs.count("n")
            assert obs.RECORDER.on
            with obs.span("leaf"):
                obs.count("n")
    rec = obs.take()
    assert sorted(s.name for s in rec.spans) == ["leaf", "outer"]
    assert rec.counters == {"n": 2}


def test_the_recorder_keeps_the_newest_spans():
    rec = obs.Recorder(capacity=3)
    for i in range(5):
        rec.add(obs.Span(f"s{i}", i, i + 1, i, None, {}))
    out = rec.take()
    assert [s.name for s in out.spans] == ["s2", "s3", "s4"]
    assert out.dropped == 2 and out.offset_ns is not None
    assert rec.take().spans == []


def greedy(model, params, prompt, max_seq, n):
    toks = torch.as_tensor(prompt[None], dtype=torch.long)
    cache = model.init_cache(params, {"tokens": toks}, 1, max_seq)
    logits, cache = model.prefill(params, {"tokens": toks}, cache)
    tok, out = logits.argmax(-1)[:, None], []
    length = torch.full((1,), len(prompt), dtype=torch.int32)
    for _ in range(n):
        out.append(int(tok))
        logits, cache = model.decode_step(params, cache, tok, length)
        tok, length = logits.argmax(-1)[:, None], length + 1
    return out


def test_each_request_is_served_at_its_own_prompt_length(served):
    model, params = served("qwen1.5-0.5b")
    m, ex = serve(model, params, requests(prompt=(P, 11)))
    assert m.completed == 8
    rng = np.random.default_rng(0)           # the executor's seed
    for rid, prompt in ex.prompts.items():   # in the order of the draws
        assert len(prompt) == (P, 11)[rid % 2]
        np.testing.assert_array_equal(
            prompt, rng.integers(0, model.cfg.vocab, size=(1, len(prompt)))[0])
        assert ex.generated(rid) == greedy(model, params, prompt, P + N, N)


def test_a_request_longer_than_the_cache_is_refused(served):
    model, params = served("qwen1.5-0.5b")
    ex = RealModelExecutor(model, params, model.cfg.vocab, P, P + N)
    req = Request(rid=0, arrive_ms=0.0, prompt_len=P + 1, max_new=N)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        ex.prefill(req, P + 1, "prefill", 1)
    assert not ex.state and not ex.prompts
