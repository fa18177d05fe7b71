"""Serving entry point of the port: a real model behind the specialization engine.

Runs real prefill and decode steps of a decoder-only LM (dense, MoE,
the Mamba2 hybrid or RWKV6; not the encoder-decoder, whose cache needs
audio frames: ``check_servable``), on the card by default, driven by the
event-driven engine (``repro_torch.sched.engine``): the scheduler code
of the reference, with service times *measured* from
the real calls instead of modelled. The heavy-phase tags and the engine's
frequency levels come from the calibration artifact
(``repro_torch/analysis/derived.json``); ``SpecializedPolicy`` confines the
heavy phase (prefill, the AVX analogue) to the prefill pool of a two-pool
``Topology``. Prefill attention runs in the ``flash_attention`` kernel and
decode attention in ``flash_decode``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --requests 8 --prompt 512 --max-new 64 --batch 4

serves the published configuration on ``--device cuda`` (the default; it
raises when no GPU is present). ``--reduced --device cpu`` serves the
reference's CPU-sized config on the CPU, with the kernels' plain versions.
``--mode loop`` keeps the plain batched loop (no scheduler) for
comparison. ``--mode cluster`` runs ``--shards`` engine shards behind the
frequency-aware router (``repro_torch.sched.cluster``), each with its own
executor; shard i runs on ``cuda:(i % device_count)``, so on one card
every shard shares it, and the model's weights exist once per device.
``--fault-plan`` injects a registered fault plan (crash, brownout,
straggler, flaky, storm; ``repro_torch.sched.faults``) and the cluster
oracle (``repro_torch.sched.replay.ClusterOracle``) audits the run.
``--workload`` replays a registered scenario or a JSON trace
(``repro_torch.sched.workload``) in engine or cluster mode:

  PYTHONPATH=src python -m repro_torch.launch.serve --mode cluster \\
      --shards 2 --fault-plan crash --requests 24 --rate 0.4 \\
      --prompt 512 --max-new 8 --batch 4

Heavy tags come from the reference's calibration artifact
(``analysis/derived.json``), and from a fresh ``tag_heavy`` over the
model's region timelines for an arch that artifact lacks; the port's own
calibration (``python -m repro_torch.analysis.calibrate``) writes
``derived_cuda.json`` beside it and serving does not read that yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.analysis import derived
from repro_torch.configs import get_arch
from repro_torch.models.api import build_model
from repro_torch.sched import (ClusterConfig, ClusterEngine,
                               ClusterTopology, SpecializedPolicy, Topology)
from repro_torch.sched.engine import Engine, Request, ServeConfig
from repro_torch.sched.freq import ENGINE_FREQ_MS
from repro_torch.sched.workload import load_trace

ENTRYPOINTS = ("prefill", "decode_step")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RealModelExecutor:
    """Engine executor that runs real prefill/decode steps.

    The engine calls ``prefill``/``decode`` when its schedule says so; we
    execute the actual computation and return the measured wall-clock
    duration in ms (on CUDA, between two ``torch.cuda.synchronize()``),
    which becomes the simulated service time. Per-request KV caches live
    here, keyed by request id — the handoff the engine charges between
    pools corresponds to moving one of these caches. Each request's
    prompt (``Request.prompt_len`` tokens drawn from ``rng``; with its
    ``max_new`` it must fit ``max_seq``) and greedy tokens are kept in
    ``prompts`` and ``tokens``, and ``done`` maps a request to the attempt
    whose last token this executor produced. ``prompt_len`` is the length
    the caller sized and warmed up for.

    Each call is a span of ``repro_torch.obs``: ``executor.prefill`` (the
    request's ``rid`` and the ``pool``) or ``executor.decode`` (``rids``,
    ``pool``), with its closing synchronisation as the child
    ``executor.sync``; on pool ``prefill`` a decode call is a stolen round.

    A retried request (drained off a crashed shard, or its response
    dropped) starts over with ``attempts`` one higher and its progress
    reset. Its state here is keyed by attempt, so a new attempt that comes
    back to this executor is prefilled anew from a fresh prompt instead of
    decoding on from the old attempt's cache, which would run past
    ``max_seq``. The earlier attempt's state is dropped, here and on the
    executors in ``peers`` (the shards of one cluster share that list),
    as soon as a later attempt starts anywhere, and by ``prune``.
    """

    def __init__(self, model, params, vocab: int, prompt_len: int,
                 max_seq: int, seed: int = 0, peers: list | None = None):
        self.model = model
        self.params = params
        self.vocab = vocab
        self.prompt_len = prompt_len
        self.max_seq = max_seq
        self.device = model.device
        self.rng = np.random.default_rng(seed)
        self.state = {}          # rid -> (cache, last_tok, length)
        self.attempt = {}        # rid -> the attempt ``state`` belongs to
        self.prompts = {}        # rid -> [prompt_len] int64 numpy
        self.tokens = {}         # rid -> list of [1, 1] token tensors
        self.done = {}           # rid -> attempt finished here
        self.live = {}           # rid -> the Request ``state`` belongs to
        self.peers = peers if peers is not None else []
        self.peers.append(self)

    def generated(self, rid: int) -> list:
        """The greedy tokens request ``rid`` produced, as ints."""
        return [int(t) for t in self.tokens[rid]]

    def prune(self) -> None:
        """Drop the state of requests that have gone on to a later
        attempt (retried, or shed or expired on the way): their caches
        would otherwise stay until the request came back here."""
        for rid in [rid for rid, req in self.live.items()
                    if req.attempts != self.attempt[rid]]:
            del self.state[rid], self.live[rid]

    def prefill(self, req: Request, chunk: int, pool: str,
                ndev: int) -> float:
        # prefill is not chunked: the whole prompt runs (and is charged)
        # on the first chunk call; later chunk calls for the same request
        # are free — total charged time stays the real cost
        if req.rid in self.state and \
                self.attempt[req.rid] == req.attempts:
            return 0.0
        P = req.prompt_len
        if P + req.max_new > self.max_seq:
            raise ValueError(f"request {req.rid}: prompt {P} + max_new "
                             f"{req.max_new} exceeds max_seq {self.max_seq}")
        with obs.call("executor.prefill", rid=req.rid, pool=pool):
            for ex in self.peers:
                ex.prune()
            self.attempt[req.rid] = req.attempts
            self.live[req.rid] = req
            prompt = self.rng.integers(0, self.vocab, size=(1, P))
            self.prompts[req.rid] = prompt[0]
            toks = torch.as_tensor(prompt, dtype=torch.long,
                                   device=self.device)
            cache = self.model.init_cache(self.params, {"tokens": toks}, 1,
                                          self.max_seq)
            _sync(self.device)
            t0 = time.perf_counter()
            logits, cache = self.model.prefill(self.params,
                                               {"tokens": toks}, cache)
            tok = logits.argmax(-1)[:, None]
            with obs.span("executor.sync"):
                _sync(self.device)
            dur_ms = (time.perf_counter() - t0) * 1e3
            self.tokens[req.rid] = [tok]
            self.state[req.rid] = (cache, tok, torch.full(
                (1,), P, dtype=torch.int32, device=self.device))
        return dur_ms

    def decode(self, batch, pool: str, ndev: int) -> float:
        with obs.call("executor.decode", rids=[r.rid for r in batch],
                      pool=pool):
            _sync(self.device)
            t0 = time.perf_counter()
            for req in batch:
                cache, tok, length = self.state[req.rid]
                logits, cache = self.model.decode_step(self.params, cache,
                                                       tok, length)
                tok = logits.argmax(-1)[:, None]
                self.tokens[req.rid].append(tok)
                if req.generated + 1 >= req.max_new:
                    # request finishes with this token: drop its KV cache
                    # so executor memory scales with concurrency, not
                    # total served
                    del self.state[req.rid], self.live[req.rid]
                    self.done[req.rid] = req.attempts
                else:
                    self.state[req.rid] = (cache, tok, length + 1)
            with obs.span("executor.sync"):
                _sync(self.device)
            ms = (time.perf_counter() - t0) * 1e3
        return ms


def heavy_tags(arch: str, cfg, prompt: int, max_seq: int, batch: int = 1):
    """Heavy-phase tags and where they came from: the calibrated tags of
    ``derived.json`` for this arch, else a fresh ``tag_heavy`` over the
    region timelines of the model ``cfg`` describes (a ``batch`` x
    ``prompt`` prefill into a ``max_seq`` cache and one decode step,
    traced on the meta device), as the reference's
    ``identify_heavy_phase`` does."""
    committed = derived.workloads().get(arch)
    if committed:
        return ([t for t in committed["tags"] if t in ENTRYPOINTS],
                "derived.json")
    from repro_torch.analysis.calibrate import config_timelines
    from repro_torch.analysis.regions import tag_heavy
    tls = config_timelines(cfg, prompt, batch=batch, max_seq=max_seq)
    return (tag_heavy([tls[name] for name in ENTRYPOINTS]),
            "fresh tag_heavy")


def engine_freq_config(arch: str):
    """The engine's ms-base frequency domain, with the license levels
    the calibration derived for this arch (falls back to the hand-tuned
    ``ENGINE_FREQ_MS`` levels for uncalibrated archs)."""
    if arch in derived.workloads():
        return dataclasses.replace(
            ENGINE_FREQ_MS,
            freqs_ghz=tuple(derived.freq_levels_ghz(arch)))
    return ENGINE_FREQ_MS


def _print_identification(tags, src) -> str:
    print("[serve] region timelines: see python -m "
          "repro_torch.analysis.calibrate; tags come from the calibration "
          "artifact")
    print(f"[serve] analyzer-derived heavy tags ({src}): {tags}")
    return tags[0] if tags else ENTRYPOINTS[0]


def warm_up(model, params, prompt: int, max_seq: int) -> float:
    """One prefill and one decode step on a throwaway cache, so that the
    kernels' build and first launches land in no measured request.
    Returns the seconds it took."""
    t0 = time.perf_counter()
    toks = torch.zeros((1, prompt), dtype=torch.long, device=model.device)
    cache = model.init_cache(params, {"tokens": toks}, 1, max_seq)
    logits, cache = model.prefill(params, {"tokens": toks}, cache)
    model.decode_step(params, cache, logits.argmax(-1)[:, None],
                      torch.full((1,), prompt, dtype=torch.int32,
                                 device=model.device))
    _sync(model.device)
    return time.perf_counter() - t0


def requests(args):
    """The requests to serve: fixed-interval arrivals at ``--rate``, or
    the first ``--requests`` of a ``--workload`` (a registered scenario
    name or a JSON trace path). A trace supplies arrival times, tenants
    and per-tenant deadline windows; its token counts are clamped to
    ``--prompt`` and ``--max-new`` (the executor runs whole prompts of
    one length)."""
    P, N = args.prompt, args.max_new
    if not args.workload:
        interval_ms = 1000.0 / args.rate
        return [Request(rid=i, arrive_ms=i * interval_ms, prompt_len=P,
                        max_new=N) for i in range(args.requests)]
    trace = load_trace(args.workload, seed=args.seed)
    reqs = [Request(rid=r.rid, arrive_ms=r.arrive_ms, prompt_len=P,
                    max_new=N, tenant=r.tenant,
                    deadline_window_ms=r.deadline_window_ms)
            for r in trace.requests[:args.requests]]
    print(f"[serve] workload {args.workload!r}: {len(reqs)} requests "
          f"replayed (of {len(trace.requests)} in the trace)")
    return reqs


def run_engine(args, cfg, model, params):
    """Real-model serving through the Policy/Topology engine. Returns the
    engine's metrics and the executor (which holds every request's
    tokens)."""
    P, N = args.prompt, args.max_new
    max_seq = P + N
    tags, src = heavy_tags(args.arch, cfg, P, max_seq, args.batch)
    heavy = _print_identification(tags, src)
    print(f"[serve] tagging {heavy!r} as the heavy (AVX-analogue) phase;"
          " SpecializedPolicy confines it to the prefill pool")
    print(f"[serve] warm-up: {warm_up(model, params, P, max_seq):.2f}s\n")

    topo = Topology.serving(n_devices=2, prefill_devices=1)
    policy = SpecializedPolicy()
    ex = RealModelExecutor(model, params, cfg.vocab, P, max_seq,
                           seed=args.seed)
    reqs = requests(args)
    eng = Engine(topo, policy,
                 cfg=ServeConfig(prefill_chunk=P,
                                 decode_batch_max=args.batch,
                                 freq=engine_freq_config(args.arch)),
                 executor=ex)
    t0 = time.perf_counter()
    m = eng.run(reqs)               # no horizon: run to completion
    wall = time.perf_counter() - t0
    s = m.summary()
    total_tokens = m.completed * N
    print(f"[serve] {m.completed}/{len(reqs)} requests, "
          f"{total_tokens} tokens in {wall:.1f}s wall")
    print(f"[serve] ttft_p50={s['ttft_p50_ms']:.1f}ms "
          f"ttft_p99={s['ttft_p99_ms']:.1f}ms "
          f"itl_p50={s['itl_p50_ms']:.1f}ms "
          f"itl_p99={s['itl_p99_ms']:.1f}ms")
    busy = ", ".join(
        "{}: heavy={:.0f}ms light={:.0f}ms".format(k, v["heavy"], v["light"])
        for k, v in m.pool_busy.items())
    print(f"[serve] handoffs={s['handoffs']} steals={s['steals']} "
          f"pool_busy={{{busy}}}")
    freq = ", ".join(
        "{}: f={:.2f}GHz reduced={:.0f}ms transitions={} E={:.0f}".format(
            k, f["avg_freq_ghz"], f["reduced"], f["transitions"],
            f["energy_proxy"])
        for k, f in m.pool_freq.items())
    print(f"[serve] frequency domains: {{{freq}}}")
    return m, ex


def shard_devices(n_shards: int, device) -> list:
    """The device of each shard: shard i runs on ``cuda:(i %
    device_count)`` when ``device`` is ``cuda`` without an index, so on
    one card every shard shares ``cuda:0``; any other device (``cpu``,
    ``cuda:1``) serves every shard."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        n = torch.cuda.device_count()
        return [torch.device("cuda", i % n) for i in range(n_shards)]
    return [device] * n_shards


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def run_cluster(args, cfg, model, params):
    """Real-model cluster serving: N shards, each a two-pool engine with
    its own executor (its own caches, prompts and tokens), behind the
    SLO-aware router, with the cluster oracle attached. The model and its
    weights exist once per device and are shared by the shards on it.
    Returns the cluster's metrics, the executors by shard name and the
    oracle."""
    from repro_torch.sched.replay import ClusterOracle

    P, N = args.prompt, args.max_new
    max_seq = P + N
    tags, src = heavy_tags(args.arch, cfg, P, max_seq, args.batch)
    heavy = _print_identification(tags, src)
    print(f"[serve] tagging {heavy!r} as the heavy phase; "
          f"{args.shards}-shard cluster under {args.cluster_policy!r}")

    cluster = ClusterTopology.homogeneous(args.shards, 2, 1)
    home = model.device
    if home.type == "cuda" and home.index is None:
        home = torch.device("cuda", torch.cuda.current_device())
    on_device = {home: (model, params)}
    executors, peers = {}, []
    for spec, dev in zip(cluster.shards, shard_devices(args.shards,
                                                       model.device)):
        if dev not in on_device:
            on_device[dev] = (build_model(cfg, dev),
                              _to_device(params, dev))
        shard_model, shard_params = on_device[dev]
        executors[spec.name] = RealModelExecutor(
            shard_model, shard_params, cfg.vocab, P, max_seq,
            seed=args.seed, peers=peers)
        print(f"[serve] {spec.name}: {spec.topology.n_units} pools units, "
              f"device {dev}")
    for dev, (m_, p_) in on_device.items():
        print(f"[serve] warm-up on {dev}: "
              f"{warm_up(m_, p_, P, max_seq):.2f}s")
    print()

    reqs = requests(args)
    ccfg = ClusterConfig(serve=ServeConfig(
        prefill_chunk=P, decode_batch_max=args.batch,
        freq=engine_freq_config(args.arch)))
    eng = ClusterEngine(cluster, args.cluster_policy, cfg=ccfg,
                        executors=executors)
    oracle = ClusterOracle(ccfg.serve.deadline_window_ms)
    plan = None
    if args.fault_plan:
        from repro_torch.sched.faults import resolve_fault_plan
        plan = resolve_fault_plan(args.fault_plan)
        print(f"[serve] fault plan {plan.name!r} "
              f"(hash {plan.plan_hash})")
    t0 = time.perf_counter()
    if plan is None:
        m = eng.run(reqs, oracle=oracle)  # no horizon: run to completion
    else:
        # fault injection needs a finite horizon: faults stop with the
        # arrival window, the drain tail lets recovery/retries settle
        last_arrive = max(r.arrive_ms for r in reqs) if reqs else 0.0
        m = eng.run(reqs, last_arrive + 60_000.0, oracle=oracle,
                    fault_plan=plan, fault_horizon_ms=last_arrive)
    wall = time.perf_counter() - t0
    for ex in executors.values():
        ex.prune()
    s = m.summary()
    print(f"[serve] {s['completed']}/{len(reqs)} requests in "
          f"{wall:.1f}s wall")
    print(f"[serve] ttft_p50={s['ttft_p50_ms']:.1f}ms "
          f"ttft_p99={s['ttft_p99_ms']:.1f}ms "
          f"itl_p50={s['itl_p50_ms']:.1f}ms "
          f"itl_p99={s['itl_p99_ms']:.1f}ms "
          f"holds={s['router_holds']}")
    if plan is not None:
        print(f"[serve] faults: injected={s['faults_injected']} "
              f"recoveries={s['shard_recoveries']} "
              f"drained={s['drained']} retries={s['retries']} "
              f"dropped={s['dropped']} shed={s['shed_total']} "
              f"expired={s['expired_total']}")
    for name, sh in m.shard_summaries().items():
        print(f"[serve]   {name}: routed={sh['routed']} "
              f"done={sh['completed']} f={sh['avg_freq_ghz']:.2f}GHz "
              f"residency={sh['license_residency']:.2f} "
              f"E={sh['energy_proxy']:.0f}")
    print(f"[serve] oracle violations={oracle.n_violations}")
    return m, executors, oracle


def run_loop(args, cfg, model, params):
    """Plain batched loop (no scheduler), kept for comparison. Returns
    the prompts and greedy tokens of every batch."""
    B, P, N = args.batch, args.prompt, args.max_new
    max_seq = P + N
    tags, src = heavy_tags(args.arch, cfg, P, max_seq, B)
    heavy = _print_identification(tags, src)
    print(f"[serve] tagging {heavy!r} as the heavy phase")
    print(f"[serve] warm-up: {warm_up(model, params, P, max_seq):.2f}s\n")

    dev = model.device
    rng = np.random.default_rng(args.seed)
    n_batches = (args.requests + B - 1) // B
    batches = []
    t0 = time.perf_counter()
    for bi in range(n_batches):
        prompts = rng.integers(0, cfg.vocab, size=(B, P))
        toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
        cache = model.init_cache(params, {"tokens": toks}, B, max_seq)
        _sync(dev)
        tp0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": toks}, cache)
        tok = logits.argmax(-1)[:, None]
        _sync(dev)
        ttft = time.perf_counter() - tp0
        lengths = torch.full((B,), P, dtype=torch.int32, device=dev)
        out = [tok]
        itl = []
        for _ in range(N - 1):
            td0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, tok, lengths)
            tok = logits.argmax(-1)[:, None]
            _sync(dev)
            itl.append(time.perf_counter() - td0)
            out.append(tok)
            lengths = lengths + 1
        batches.append((prompts, torch.cat(out, dim=1).cpu().numpy()))
        itl_p50 = f"{np.median(itl) * 1e3:.1f}ms" if itl else "n/a"
        itl_max = f"{max(itl) * 1e3:.1f}ms" if itl else "n/a"
        print(f"[serve] batch {bi}: ttft={ttft * 1e3:.1f}ms "
              f"itl_p50={itl_p50} itl_max={itl_max}")
    wall = time.perf_counter() - t0
    served = n_batches * B
    print(f"[serve] {served}/{served} requests, {served * N} tokens in "
          f"{wall:.1f}s ({served * N / wall:.0f} tok/s)")
    return batches


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--mode", choices=("engine", "loop", "cluster"),
                    default="engine")
    ap.add_argument("--shards", type=int, default=2,
                    help="cluster mode: number of engine shards")
    ap.add_argument("--cluster-policy", default="cluster-adaptive",
                    help="cluster mode: registered cluster policy "
                         "(cluster-rr, cluster-queue, cluster-freq, "
                         "cluster-adaptive)")
    ap.add_argument("--fault-plan", default=None,
                    help="cluster mode: registered fault plan to "
                         "inject (crash, brownout, straggler, flaky, "
                         "storm, ... — see repro_torch.sched.faults)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="request arrival rate (req/s of engine time)")
    ap.add_argument("--workload", default=None,
                    help="arrival pattern: a registered scenario name "
                         "(steady, bursty, diurnal, heavy_tail, "
                         "multi_tenant) or a path to a JSON trace; "
                         "default: fixed-interval arrivals at --rate")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights and the prompts")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu "
                         "only when asked for)")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reference's CPU-sized config instead "
                         "of the published one")
    return ap


def check_servable(cfg) -> None:
    """Raise for an arch the executor cannot serve: the encoder-decoder's
    cache is built from audio frames, and the executor hands a model
    tokens only, as the reference's does (``src/repro/launch/serve.py:75``
    passes ``{"tokens": ...}``), so whisper runs through its Model API
    (``repro_torch.models.api.build_model``) instead."""
    if cfg.enc_dec is not None:
        raise ValueError(
            f"{cfg.name} (family {cfg.family!r}) cannot be served: its "
            "init_cache and prefill need batch['frames'] (the audio "
            "frontend's output), and the serving executor passes only "
            "tokens, as the reference's does; run it through "
            "repro_torch.models.api.build_model with frames")


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.reduced() if args.reduced else arch
    check_servable(cfg)
    model = build_model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen)
    print(f"[serve] {cfg.name} ({'reduced' if args.reduced else 'published'}"
          f" config): {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.kv_heads} heads x {cfg.resolved_head_dim}, "
          f"vocab {cfg.vocab}, {cfg.param_count() / 1e9:.3f}B params in "
          f"{cfg.param_dtype} on {device}")
    if args.mode == "engine":
        return run_engine(args, cfg, model, params)
    if args.mode == "cluster":
        return run_cluster(args, cfg, model, params)
    return run_loop(args, cfg, model, params)


if __name__ == "__main__":
    main()
