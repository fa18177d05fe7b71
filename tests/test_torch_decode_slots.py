"""The executor's cache slots (``launch.serve.SlotPool``) on the CPU.

The pool's bookkeeping on its own, which families take the graph path
(``Model.graph_decode``, and ``serve.graph_decode`` only on a CUDA device
off a mesh), and ``RealModelExecutor`` on its slot path with the CUDA
graph stood in for by a replay that runs the step eagerly: the tokens
equal a fresh cache's greedy ones, a reused slot's stale positions change
nothing, slots come back on finish and on ``prune``, ``state[rid]`` stays
``(cache, tok, length)``, and the counters and ``executor.step`` spans
count captures and replays; and ``SlotPool`` capturing and replaying with
its device current, no span recorded while capturing, with ``torch.cuda``
stood in for. The graph itself runs only on the card
(``tests/test_torch_decode_graph.py``)."""
import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.dist.context import DistContext
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.api import build_model
from repro_torch.sched import SpecializedPolicy, Topology
from repro_torch.sched.engine import Engine, Request, ServeConfig

P, N = 16, 6
FD = "kernels.flash_decode.launches"

GRAPH_FAMILIES = {"qwen1.5-0.5b": True, "stablelm-12b": True,
                  "chameleon-34b": True, "grok-1-314b": False,
                  "deepseek-v3-671b": False, "zamba2-2.7b": False,
                  "rwkv6-3b": False, "whisper-large-v3": False}


class StandIn:
    """A captured graph's stand-in on the CPU: capturing runs nothing but
    counts what the kernel wrappers count while a step is captured (one
    ``flash_decode`` issued a layer); each replay runs the step and issues
    nothing."""

    def __init__(self, step, layers: int):
        self.step = step
        obs.count(FD, layers)

    def replay(self):
        self.step()


@pytest.fixture(scope="module")
def dense():
    cfg = get_arch("qwen1.5-0.5b").reduced()
    model = build_model(cfg, "cpu")
    return model, model.init(torch.Generator().manual_seed(0))


@pytest.fixture
def slotted(monkeypatch, dense):
    """Executors built in this test take the slot path, on the CPU."""
    layers = dense[0].cfg.n_layers
    monkeypatch.setattr(serve, "graph_decode", lambda m: m.graph_decode)
    monkeypatch.setattr(serve.SlotPool, "capture",
                        lambda pool, step: StandIn(step, layers))


class FixedClock:
    """Stands in for the ``time`` module ``launch.serve`` reads: each
    reading advances 5 ms, so the engine's schedule does not depend on the
    host's load."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 5e-3
        return self.now


def executor(model, params, max_seq=P + N):
    return serve.RealModelExecutor(model, params, model.cfg.vocab, P,
                                   max_seq)


def run(ex, reqs, batch=4):
    """``reqs`` through ``ex`` under ``Engine``: (metrics, the most
    requests that held state at once)."""
    peak = [0]
    prefill = ex.prefill

    def counted(req, *a):
        out = prefill(req, *a)
        peak[0] = max(peak[0], len(ex.state))
        return out
    ex.prefill = counted
    eng = Engine(Topology.serving(n_devices=2, prefill_devices=1),
                 SpecializedPolicy(),
                 cfg=ServeConfig(prefill_chunk=P, decode_batch_max=batch),
                 executor=ex)
    return eng.run(reqs), peak[0]


def greedy(model, params, prompt, max_seq, n):
    """Request ``prompt``'s n greedy tokens on a cache of its own."""
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


def test_the_lowest_free_slot_is_taken_first():
    made = []
    pool = serve.SlotPool(lambda: made.append(len(made)) or len(made),
                          torch.device("cpu"))
    assert [pool.take() for _ in range(3)] == [0, 1, 2]
    pool.give(2)
    pool.give(0)
    pool.give(1)
    assert [pool.take() for _ in range(4)] == [0, 1, 2, 3]
    assert len(pool.slots) == len(made) == 4
    pool.give(3)
    assert pool.take() == 3 and len(pool.slots) == 4


@pytest.mark.parametrize("arch", sorted(GRAPH_FAMILIES))
def test_the_graph_path_is_a_property_of_the_family(arch):
    cfg = get_arch(arch).reduced()
    on_card = build_model(cfg, "cuda")          # built, nothing allocated
    assert on_card.graph_decode == GRAPH_FAMILIES[arch]
    assert serve.graph_decode(on_card) == GRAPH_FAMILIES[arch]
    assert not serve.graph_decode(build_model(cfg, "cpu"))
    assert not serve.graph_decode(dataclasses.replace(
        on_card, dist=DistContext(active=True)))


def test_the_eager_loop_is_kept_off_the_card(dense):
    model, params = dense
    ex = executor(model, params)
    assert ex.slots is None and ex.slot_of == {}
    reqs = [Request(rid=i, arrive_ms=2.0 * i, prompt_len=P, max_new=N)
            for i in range(3)]
    obs.take()
    with profile(activities=[ProfilerActivity.CPU]):
        m, _ = run(ex, reqs)
    rec = obs.take()
    steps = [s for s in rec.spans if s.name == "executor.step"]
    assert m.completed == 3 and len(steps) == 3 * (N - 1)
    assert {(s.attrs["slot"], s.attrs["mode"]) for s in steps} == {
        (None, "eager")}
    assert serve.CAPTURES not in rec.counters
    assert serve.REPLAYS not in rec.counters


def test_slots_serve_the_tokens_of_a_fresh_cache(dense, slotted,
                                                 monkeypatch):
    monkeypatch.setattr(serve, "time", FixedClock())
    model, params = dense
    L = model.cfg.n_layers
    ex = executor(model, params)
    reqs = [Request(rid=i, arrive_ms=3.0 * i, prompt_len=(P, 11)[i % 2],
                    max_new=N) for i in range(8)]
    ops.reset_launch_counts()
    obs.take()
    with profile(activities=[ProfilerActivity.CPU]):
        m, peak = run(ex, reqs)
    rec = obs.take()
    assert m.completed == 8
    for rid, prompt in ex.prompts.items():
        assert ex.generated(rid) == greedy(model, params, prompt, P + N, N)
    # as many slots as requests were live at once, every one back
    n = len(ex.slots.slots)
    assert 1 < n == peak < 8
    assert sorted(ex.slots.free) == list(range(n))
    assert ex.state == {} and ex.slot_of == {}
    # one capture a slot, a replay every step; the launch counters count
    # what the host issued: a step's kernels once a slot, at its capture
    steps = [s for s in rec.spans if s.name == "executor.step"]
    modes = [s.attrs["mode"] for s in steps]
    assert len(steps) == 8 * (N - 1)
    assert modes.count("capture") == n and modes.count("eager") == 0
    assert {s.attrs["slot"] for s in steps} == set(range(n))
    assert rec.counters[serve.CAPTURES] == n
    assert rec.counters[serve.REPLAYS] == len(steps)
    assert rec.counters[FD] == L * n
    by_id = {s.id: s for s in rec.spans}
    assert all(by_id[s.parent].name == "executor.decode" for s in steps)


def test_a_reused_slot_ignores_its_stale_positions(dense, slotted):
    """A long request fills slot 0 to P + 2N - 1; a short-prompt request
    after it reuses the slot and decodes as on a fresh cache."""
    model, params = dense
    max_seq = P + 2 * N
    ex = executor(model, params, max_seq)
    reqs = [Request(rid=0, arrive_ms=0.0, prompt_len=P, max_new=2 * N),
            Request(rid=1, arrive_ms=1e6, prompt_len=5, max_new=N)]
    m, peak = run(ex, reqs)
    assert m.completed == 2 and peak == 1 and len(ex.slots.slots) == 1
    for rid, n in ((0, 2 * N), (1, N)):
        assert ex.generated(rid) == greedy(model, params, ex.prompts[rid],
                                           max_seq, n)
    assert ex.slots.slots[0].graph is not None


def test_prune_and_finish_give_slots_back(dense, slotted):
    model, params = dense
    ex = executor(model, params)
    a = Request(rid=0, arrive_ms=0.0, prompt_len=P, max_new=2)
    b = Request(rid=1, arrive_ms=0.0, prompt_len=11, max_new=N)
    ex.prefill(a, P, "prefill", 1)
    ex.prefill(b, 11, "prefill", 1)
    assert ex.slot_of == {0: 0, 1: 1}
    for rid, length in ((0, P), (1, 11)):
        cache, tok, n = ex.state[rid]
        slot = ex.slots.slots[ex.slot_of[rid]]
        assert cache is slot.cache and tok is slot.tok and n is slot.length
        assert int(n[0]) == length and int(tok) == ex.generated(rid)[0]
    # a retried attempt: the old one's slot goes back once a prefill runs
    a.attempts += 1
    ex.prefill(Request(rid=2, arrive_ms=0.0, prompt_len=P, max_new=N), P,
               "prefill", 1)
    assert ex.slot_of == {1: 1, 2: 0} and set(ex.state) == {1, 2}
    ex.prefill(a, P, "prefill", 1)
    assert ex.slot_of == {0: 2, 1: 1, 2: 0} and len(ex.slots.slots) == 3
    # b decodes one step, then finishes: its slot comes back
    ex.decode([b], "decode", 1)
    assert int(ex.state[1][2][0]) == 12
    b.generated = N - 1
    ex.decode([b], "decode", 1)
    assert 1 not in ex.state and ex.done[1] == 0
    assert ex.slots.free == [1] and ex.slot_of == {0: 2, 2: 0}
    assert ex.generated(1) == greedy(model, params, ex.prompts[1], P + N, 3)



def test_the_pool_captures_on_a_stream_of_its_card_and_records_no_span(
        monkeypatch):
    """The slots of a shard on ``cuda:1`` while ``cuda:0`` is current: the
    capture runs with ``cuda:1`` current, on a stream made there once for
    every capture of the pool, and records no span (the wrappers'
    counters still count)."""
    card, current, seen = torch.device("cuda", 1), ["cuda:0"], []

    @contextlib.contextmanager
    def device(d):
        was, current[0] = current[0], d
        try:
            yield
        finally:
            current[0] = was

    @contextlib.contextmanager
    def graph(g, pool, stream):
        seen.append(("graph", current[0], pool, stream))
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda d: ("stream", d))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    pool = serve.SlotPool(lambda: None, card)

    def step():
        with obs.span("model.attn", layer=0, phase="decode"):
            obs.count(FD)
        seen.append(("step", current[0]))

    obs.take()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.call("executor.decode", rids=[0], pool="decode"):
            pool.capture(step)
            pool.capture(step)
            with obs.span("executor.sync"):
                pass
    rec = obs.take()
    assert seen == 2 * [("graph", card, "pool", ("stream", card)),
                        ("step", card)]
    assert current == ["cuda:0"]
    assert sorted(s.name for s in rec.spans) == ["executor.decode",
                                                 "executor.sync"]
    assert rec.counters == {FD: 2}
