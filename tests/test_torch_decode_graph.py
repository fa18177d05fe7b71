"""The executor's decode graphs on the card: a reduced dense GQA decoder
served through ``RealModelExecutor`` under ``Engine``, each request's
decode step the replay of its cache slot's CUDA graph, against the same
executor on the eager loop: the same tokens, and the same kernels
executed on the card, counted in a profile of the card's activity. With
two cards or more, the same on a model that sits on a card other than the
current one, as a cluster's shards do.

Needs an NVIDIA GPU and the CUDA toolkit (marker ``cuda``); without a GPU
each test skips. This file imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_decode_graph.py
"""
import collections
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.api import build_model
from repro_torch.sched import SpecializedPolicy, Topology
from repro_torch.sched.engine import Engine, Request, ServeConfig

P, N = 40, 12
# the device functions of each kernel, as the profile names them
FUNCTIONS = {"flash_attention": ("flash_attention_kernel",
                                 "flash_attention_tc_kernel"),
             "flash_decode": ("flash_decode_kernel",)}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _dense(device):
    """The reduced stablelm-12b with 2 KV heads for its 4 query heads (a
    GQA group of 2), fp32, on ``device``."""
    cfg = dataclasses.replace(get_arch("stablelm-12b").reduced(), kv_heads=2)
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    serve.warm_up(model, params, P, P + 2 * N)
    return model, params


@pytest.fixture(scope="module")
def dense():
    _needs_card()
    return _dense("cuda")


def function(name: str) -> str:
    """``void ns::f<T, 4>(float*)`` -> ``f``."""
    name = name.strip().replace("(anonymous namespace)::", "")
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.removeprefix("void ").rsplit("::", 1)[-1].strip()


def executed(fn):
    """``fn()`` and the executions of each kernel on the cards meanwhile,
    counted by function name in a profile of the cards' activity."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    seen = collections.Counter(
        function(e.name()) for e in prof.profiler.kineto_results.events()
        if str(e.device_type()).endswith("CUDA"))
    return out, {k: sum(seen[f] for f in fs) for k, fs in FUNCTIONS.items()}


class FixedClock:
    """Stands in for the ``time`` module ``launch.serve`` reads: each
    reading advances 5 ms, so both paths see one schedule and draw each
    request's prompt in the same order."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 5e-3
        return self.now


def serve_reqs(model, params, reqs, graphs: bool, monkeypatch,
               max_seq=P + 2 * N):
    """The requests ``reqs()`` makes through an executor under
    ``Engine``, on the graph path or the eager loop: (metrics, executor,
    kernels executed on the card, launches the host issued, records)."""
    monkeypatch.setattr(serve, "graph_decode",
                        lambda m: graphs and m.graph_decode)
    monkeypatch.setattr(serve, "time", FixedClock())
    ex = serve.RealModelExecutor(model, params, model.cfg.vocab, P, max_seq)
    assert (ex.slots is not None) == graphs
    eng = Engine(Topology.serving(n_devices=2, prefill_devices=1),
                 SpecializedPolicy(),
                 cfg=ServeConfig(prefill_chunk=P, decode_batch_max=4),
                 executor=ex)
    ops.reset_launch_counts()
    obs.take()
    m, runs = executed(lambda: eng.run(reqs()))
    return m, ex, runs, ops.launch_counts(), obs.take()


def tokens(ex):
    return {rid: ex.generated(rid) for rid in ex.done}


@pytest.mark.cuda
def test_cuda_graph_tokens_and_launches_equal_the_eager_loops(dense,
                                                              monkeypatch):
    model, params = dense
    assert model.graph_decode and serve.graph_decode(model)

    def reqs():
        return [Request(rid=i, arrive_ms=5.0 * i, prompt_len=(P, 29)[i % 2],
                        max_new=N) for i in range(8)]
    m, ex, runs, issued, rec = serve_reqs(model, params, reqs, True,
                                          monkeypatch)
    m0, ex0, runs0, issued0, _ = serve_reqs(model, params, reqs, False,
                                            monkeypatch)
    L = model.cfg.n_layers
    assert m.completed == m0.completed == 8
    assert tokens(ex) == tokens(ex0) and len(tokens(ex)) == 8
    # the same kernels ran on the card; the host issued a slot's once
    assert runs == runs0 and runs["flash_decode"] == 8 * (N - 1) * L
    n = len(ex.slots.slots)
    assert issued0["flash_decode"] == 8 * (N - 1) * L
    assert issued["flash_decode"] == n * L
    assert rec.counters[serve.CAPTURES] == n
    assert rec.counters[serve.REPLAYS] == 8 * (N - 1)
    # a capture records no layer span: the decode steps run none
    steps = [s.attrs["mode"] for s in rec.spans if s.name == "executor.step"]
    assert len(steps) == 8 * (N - 1) and steps.count("capture") == n
    assert not [s for s in rec.spans if s.name in ("model.attn", "model.ffn")
                and s.attrs["phase"] == "decode"]
    assert sorted(ex.slots.free) == list(range(n)) and not ex.state


@pytest.mark.cuda
def test_cuda_graph_a_reused_slot_ignores_its_stale_positions(dense,
                                                              monkeypatch):
    """A long request fills slot 0 to P + 2N - 1; a shorter prompt after
    it replays slot 0's graph over the stale positions."""
    model, params = dense

    def reqs():
        return [Request(rid=0, arrive_ms=0.0, prompt_len=P, max_new=2 * N),
                Request(rid=1, arrive_ms=1e7, prompt_len=17, max_new=N),
                Request(rid=2, arrive_ms=2e7, prompt_len=P - 1, max_new=N)]
    m, ex, runs, *_ = serve_reqs(model, params, reqs, True, monkeypatch)
    m0, ex0, runs0, *_ = serve_reqs(model, params, reqs, False, monkeypatch)
    assert m.completed == 3 and len(ex.slots.slots) == 1
    assert tokens(ex) == tokens(ex0) and runs == runs0


@pytest.mark.cuda
def test_cuda_graph_a_retried_attempt_frees_its_slot(dense, monkeypatch):
    model, params = dense
    monkeypatch.setattr(serve, "graph_decode", lambda m: m.graph_decode)
    ex = serve.RealModelExecutor(model, params, model.cfg.vocab, P,
                                 P + 2 * N)
    a = Request(rid=0, arrive_ms=0.0, prompt_len=P, max_new=N)
    ex.prefill(a, P, "prefill", 1)
    ex.decode([a], "decode", 1)
    a.attempts += 1                    # retried elsewhere
    b = Request(rid=1, arrive_ms=0.0, prompt_len=P, max_new=N)
    ex.prefill(b, P, "prefill", 1)     # prunes a's attempt 0
    assert ex.slot_of == {1: 0} and set(ex.state) == {1}
    ex.decode([b], "decode", 1)        # slot 0's graph, b's cache
    ex.prefill(a, P, "prefill", 1)
    assert ex.slot_of == {0: 1, 1: 0} and len(ex.slots.slots) == 2
    ex.decode([a, b], "decode", 1)
    assert [int(ex.state[r][2][0]) for r in (0, 1)] == [P + 1, P + 2]


@pytest.mark.cuda
def test_cuda_graph_on_a_card_other_than_the_current_one(monkeypatch):
    """A shard's model on ``cuda:1`` while ``cuda:0`` is current: its
    graphs capture and replay on ``cuda:1``, so every token equals the
    eager loop's there."""
    _needs_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    assert torch.cuda.current_device() == 0
    model, params = _dense("cuda:1")

    def reqs():
        return [Request(rid=i, arrive_ms=5.0 * i, prompt_len=(P, 29)[i % 2],
                        max_new=N) for i in range(4)]
    m, ex, runs, *_ = serve_reqs(model, params, reqs, True, monkeypatch)
    m0, ex0, runs0, *_ = serve_reqs(model, params, reqs, False, monkeypatch)
    assert ex.slots.device == torch.device("cuda:1")
    assert m.completed == m0.completed == 4
    assert tokens(ex) == tokens(ex0) and runs == runs0
    assert runs["flash_decode"] == 4 * (N - 1) * model.cfg.n_layers
    assert torch.cuda.current_device() == 0
