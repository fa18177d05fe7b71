"""One run of one cell: set-up, the measured window, the metrics and the
check of the served tokens against the plain reference.

Everything that belongs to one item is found by name under the
checkout's ``portbench/``: the cell's mix ``workloads/<cell>.json``, its
configuration (the file ``BENCHMARK.json`` names) with the reference and
counts modules that file names (``reference/<name>.py``,
``counts/<name>.py``), and each metric's reader ``metrics/<metric>.py``.

The window drives the port's serving entry as ``launch/serve.py``'s
``run_engine`` builds it: ``RealModelExecutor`` under ``Engine`` with
``SpecializedPolicy`` on ``Topology.serving(2, 1)``, ``ServeConfig(
prefill_chunk=<prompt>, decode_batch_max=<cell>, freq=engine_freq_config
(arch))``. The harness pushes the engine's events onto a heap of its own
(the engine's event sink) and handles them until ``seconds`` of wall time
have passed. Arrivals are an open loop in engine time; the engine's clock
advances by the card's measured call durations, as if its two pools were
two devices. So latencies are engine time and throughput is wall time.

A mix may give ``ramp_s``: the engine first serves its traffic for that
many wall seconds, unmeasured and counted as set-up, so that the window
opens on queues at their steady level. The window's metrics then read the
requests that arrive after it opens, the tokens and calls made in it, and
the judge the requests it finished.
"""
from __future__ import annotations

import gc
import heapq
import importlib.util
import itertools
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench import traffic, weights
from portbench.trace import Tracer

ROOT = Path(__file__).resolve().parents[1]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` of a checkout and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def mix(self, cell: str) -> dict:
        return json.loads((self.root / "portbench" / "workloads"
                           / f"{cell}.json").read_text())

    def module(self, kind: str, name: str):
        return load_module(self.root / "portbench" / kind / f"{name}.py",
                           f"portbench_{kind}_{name}".replace(".", "_"))

    def metrics(self, cell: str, traced: bool) -> list:
        """The metric entries a run of ``cell`` reports: its end-to-end
        metrics untraced, its per-layer metrics traced."""
        e2e = [m["name"] for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return [m for m in self.spec["end_to_end"] if m["name"] in e2e]
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


# ------------------------------------------------------------ the window


@dataclass
class Call:
    kind: str                 # "prefill" | "decode"
    t0_ns: int                # perf_counter_ns around the executor call
    t1_ns: int
    ms: float                 # what the executor measured and returned
    lengths: tuple            # positions each request attends


class PromptFeed:
    """Stands in for the executor's ``rng``: its ``integers`` gives the
    prompt the benchmark made for the request being prefilled, from the
    seed and the request's id."""

    def __init__(self, words: list):
        self.words = list(words)
        self.rid = None

    def prompt(self, rid: int, vocab: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(self.words + [rid])
        return rng.integers(0, vocab, size=n)

    def integers(self, low, high, size):
        """The executor's only draw: ``integers(0, vocab, (1, prompt))``."""
        return self.prompt(self.rid, high, size[-1]).reshape(size)


class Probe:
    """The engine's executor: forwards every call to the port's
    ``RealModelExecutor`` and records its span (spans are the benchmark's
    own, around the calls into the executor)."""

    def __init__(self, ex, feed: PromptFeed, prompt: int):
        self.ex, self.feed, self.P = ex, feed, prompt
        self.calls: list[Call] = []
        self.prefill_ms: dict[int, float] = {}

    def prefill(self, req, chunk, pool, ndev):
        self.feed.rid = req.rid
        t0 = time.perf_counter_ns()
        ms = self.ex.prefill(req, chunk, pool, ndev)
        if ms > 0:
            self.calls.append(Call("prefill", t0, time.perf_counter_ns(),
                                   ms, (self.P,)))
            self.prefill_ms[req.rid] = ms
        return ms

    def decode(self, batch, pool, ndev):
        lengths = tuple(self.P + r.generated for r in batch)
        t0 = time.perf_counter_ns()
        ms = self.ex.decode(batch, pool, ndev)
        self.calls.append(Call("decode", t0, time.perf_counter_ns(), ms,
                               lengths))
        return ms


@dataclass
class Run:
    """What a metric reader reads."""
    cell: str
    mix: dict
    model: dict               # the configuration's model dict
    counts: object            # the configuration's counts module
    prompt: int
    setup_s: float
    wall_s: float             # the window's wall seconds
    t_now: float              # engine ms at the cut
    requests: list            # engine Requests that arrived in the window
    itl_ms: list              # every closed gap between tokens (engine)
    calls: list
    prefill_ms: dict
    tokens: int               # output tokens produced in the window
    t_open: float = 0.0       # engine ms when the window opened
    ramp_s: float = 0.0       # wall seconds served before it opened
    memory_peak_bytes: int = 0
    served: dict = field(default_factory=dict)  # finished rid -> tokens
    feed: PromptFeed | None = None
    trace: object = None      # trace.Summary of a traced run


def drive(eng, reqs: list, seconds: float, tracer: Tracer, on_event=None,
          ramp_s: float = 0.0, on_open=None):
    """Handle the engine's events for ``ramp_s`` wall seconds, call
    ``on_open()``, then handle them until ``seconds`` more have passed
    (``on_event(engine, t, reqs)`` after each). Returns (the window's wall
    seconds, engine ms at its opening, engine ms of its last event, the
    engine's metrics)."""
    heap, seq = [], itertools.count()
    t_now = 0.0

    def push(_eng, t, kind, payload):
        heapq.heappush(heap, (t, next(seq), kind, payload))

    def serve(limit: float) -> float:
        nonlocal t_now
        t0 = time.perf_counter()
        while heap and time.perf_counter() - t0 < limit:
            t_now, _, kind, payload = heapq.heappop(heap)
            eng.handle(t_now, kind, payload)
            if on_event is not None:
                on_event(eng, t_now, reqs)
        return time.perf_counter() - t0

    eng.begin_run(reqs, push=push)
    if ramp_s > 0:
        serve(ramp_s)
    t_open = t_now
    if on_open is not None:
        on_open()
    tracer.start()
    wall = serve(seconds)
    tracer.stop()
    return wall, t_open, t_now, eng.finish()


def arch_config(model: dict):
    """The port's ``ArchConfig`` of a configuration file's model dict, its
    nested groups (a state-space or hybrid layout) included, so that a
    configuration of another family is added as files alone."""
    from repro_torch.configs.base import ArchConfig, HybridConfig, SSMConfig
    kw = dict(model)
    if "ssm" in kw:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    if "hybrid" in kw:
        kw["hybrid"] = HybridConfig(**kw["hybrid"])
    return ArchConfig(**kw)


def seed_words(seed: int, stream: int) -> list:
    """Independent 32-bit words for one use of the run's seed."""
    return np.random.SeedSequence([int(seed) & (2 ** 64 - 1),
                                   stream]).generate_state(4).tolist()


class Serving:
    """The port's serving stack for one cell, built once; ``window`` runs
    a measured window on it (the knee sweep and the limit readings run
    several on one set-up)."""

    def __init__(self, bench: Bench, cell: str, device, log=sys.stderr):
        from repro_torch.launch.serve import engine_freq_config, heavy_tags
        from repro_torch.models.api import build_model
        self.bench, self.cell, self.device, self.log = bench, cell, \
            torch.device(device), log
        self.entry = bench.cell(cell)
        self.mix = bench.mix(cell)
        self.conf = bench.config(self.entry["config"])
        self.m = self.conf["model"]
        self.ref = bench.module("reference", self.conf["reference"])
        self.counts = bench.module("counts", self.conf["counts"])
        self.cfg = arch_config(self.m)
        self.P = int(self.mix["prompt"])
        self.model = build_model(self.cfg, self.device)
        self.params = None
        tags, src = heavy_tags(self.cfg.name, self.cfg, self.P,
                               self.P + 1)
        self.freq = engine_freq_config(self.cfg.name)
        print(f"[portbench] {cell}: heavy tags ({src}) {tags}; engine "
              f"frequency levels {self.freq.freqs_ghz}", file=log)

    def make_weights(self, seed: int) -> float:
        """The run's weights from ``seed``, on the device (seconds)."""
        self.params = None
        gc.collect()
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.device).manual_seed(
            seed_words(seed, 1)[0])
        self.params = weights.make(self.ref.param_draws(self.m),
                                   self.m["param_dtype"], gen, self.device)
        weights.check_layout(self.params, self.model.abstract_params())
        sync(self.device)
        return time.perf_counter() - t0

    def warm_up(self) -> float:
        from repro_torch.launch.serve import warm_up
        return warm_up(self.model, self.params, self.P,
                       self.max_seq(self.mix))

    def max_seq(self, mix: dict) -> int:
        return self.P + _max_output(mix["output"])

    def window(self, seed: int, seconds: float, traced: bool = False,
               mix: dict | None = None, setup_s: float = 0.0,
               on_event=None) -> Run:
        from repro_torch.launch.serve import RealModelExecutor
        from repro_torch.sched import SpecializedPolicy, Topology
        from repro_torch.sched.engine import Engine, Request, ServeConfig
        mix = mix or self.mix
        sched = traffic.requests(mix, seed)
        reqs = [Request(rid=i, arrive_ms=t, prompt_len=self.P, max_new=n)
                for i, (t, n) in enumerate(sched)]
        ex = RealModelExecutor(self.model, self.params, self.cfg.vocab,
                               self.P, self.max_seq(mix))
        feed = PromptFeed(seed_words(seed, 2))
        ex.rng = feed
        probe = Probe(ex, feed, self.P)
        eng = Engine(Topology.serving(n_devices=2, prefill_devices=1),
                     SpecializedPolicy(),
                     cfg=ServeConfig(prefill_chunk=self.P,
                                     decode_batch_max=int(
                                         mix["decode_batch_max"]),
                                     freq=self.freq),
                     executor=probe)
        tracer = Tracer(traced)
        ramp_s = float(mix.get("ramp_s", 0.0))
        at_open = {}

        def on_open():
            at_open.update(tokens=sum(r.generated for r in reqs),
                           calls=len(probe.calls), itl=len(eng.m.itl_ms))

        wall, t_open, t_now, m = drive(eng, reqs, seconds, tracer, on_event,
                                       ramp_s, on_open)
        arrived = [r for r in reqs if r.arrive_ms <= t_now
                   and (r.arrive_ms > t_open or not ramp_s)]
        calls = probe.calls[at_open["calls"]:]
        run = Run(cell=self.cell, mix=mix, model=self.m, counts=self.counts,
                  prompt=self.P, setup_s=setup_s, wall_s=wall, t_now=t_now,
                  requests=arrived, itl_ms=m.itl_ms[at_open["itl"]:],
                  calls=calls, prefill_ms=probe.prefill_ms,
                  tokens=sum(r.generated for r in reqs) - at_open["tokens"],
                  t_open=t_open, ramp_s=ramp_s)
        if traced:
            run.trace = tracer.summary(wall, [(c.kind, c.t0_ns, c.t1_ns)
                                              for c in calls])
        if self.device.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(
                self.device)
        run.served = {r.rid: ex.generated(r.rid) for r in reqs
                      if r.done_ms is not None and r.done_ms > t_open}
        run.feed = feed
        del ex, probe, eng
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return run


def _max_output(spec: dict) -> int:
    kind = spec["kind"]
    if kind == "fixed":
        return int(spec["n"])
    if kind == "uniform":
        return int(spec["hi"]) - 1
    return int(spec["hi"])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def report(bench: Bench, run: Run, traced: bool) -> dict:
    """The cell's metrics from their readers: name -> {value, unit}; a
    reader that finds nothing to read gives None and is left out."""
    out = {}
    for m in bench.metrics(run.cell, traced):
        mod = bench.module("metrics", m["name"])
        v = mod.read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
