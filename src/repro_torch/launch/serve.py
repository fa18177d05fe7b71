"""Serving entry point of the port: a real model behind the specialization engine.

Runs real prefill and decode steps of a decoder-only LM, on the card by
default, driven by the event-driven engine (``repro_torch.sched.engine``):
the scheduler code of the reference, with service times *measured* from
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
comparison. The reference's ``--mode cluster`` and ``--workload`` come
with a later slice of the port. Heavy tags come from the reference's
calibration artifact (``analysis/derived.json``); the port's own
calibration (``python -m repro_torch.analysis.calibrate``) writes
``derived_cuda.json`` beside it and serving does not read that yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis import derived
from repro_torch.configs import get_arch
from repro_torch.models.api import build_model
from repro_torch.sched import SpecializedPolicy, Topology
from repro_torch.sched.engine import Engine, Request, ServeConfig
from repro_torch.sched.freq import ENGINE_FREQ_MS

DEFAULT_HEAVY = ["prefill"]
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
    prompt and greedy tokens are kept in ``prompts`` and ``tokens``.
    """

    def __init__(self, model, params, vocab: int, prompt_len: int,
                 max_seq: int, seed: int = 0):
        self.model = model
        self.params = params
        self.vocab = vocab
        self.prompt_len = prompt_len
        self.max_seq = max_seq
        self.device = model.device
        self.rng = np.random.default_rng(seed)
        self.state = {}          # rid -> (cache, last_tok, length)
        self.prompts = {}        # rid -> [prompt_len] int64 numpy
        self.tokens = {}         # rid -> list of [1, 1] token tensors

    def generated(self, rid: int) -> list:
        """The greedy tokens request ``rid`` produced, as ints."""
        return [int(t) for t in self.tokens[rid]]

    def prefill(self, req: Request, chunk: int, pool: str,
                ndev: int) -> float:
        # prefill is not chunked: the whole prompt runs (and is charged)
        # on the first chunk call; later chunk calls for the same request
        # are free — total charged time stays the real cost
        if req.rid in self.state:
            return 0.0
        prompt = self.rng.integers(0, self.vocab, size=(1, self.prompt_len))
        self.prompts[req.rid] = prompt[0]
        toks = torch.as_tensor(prompt, dtype=torch.long, device=self.device)
        cache = self.model.init_cache(self.params, {"tokens": toks}, 1,
                                      self.max_seq)
        _sync(self.device)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(self.params, {"tokens": toks},
                                           cache)
        tok = logits.argmax(-1)[:, None]
        _sync(self.device)
        dur_ms = (time.perf_counter() - t0) * 1e3
        self.tokens[req.rid] = [tok]
        self.state[req.rid] = (cache, tok, torch.full(
            (1,), self.prompt_len, dtype=torch.int32, device=self.device))
        return dur_ms

    def decode(self, batch, pool: str, ndev: int) -> float:
        _sync(self.device)
        t0 = time.perf_counter()
        for req in batch:
            cache, tok, length = self.state[req.rid]
            logits, cache = self.model.decode_step(self.params, cache, tok,
                                                   length)
            tok = logits.argmax(-1)[:, None]
            self.tokens[req.rid].append(tok)
            if req.generated + 1 >= req.max_new:
                # request finishes with this token: drop its KV cache so
                # executor memory scales with concurrency, not total served
                self.state.pop(req.rid)
            else:
                self.state[req.rid] = (cache, tok, length + 1)
        _sync(self.device)
        return (time.perf_counter() - t0) * 1e3


def heavy_tags(arch: str):
    """Heavy-phase tags and where they came from: the calibrated tags of
    ``derived.json`` for this arch, else the default ``["prefill"]``."""
    committed = derived.workloads().get(arch)
    if committed:
        return ([t for t in committed["tags"] if t in ENTRYPOINTS],
                "derived.json")
    return list(DEFAULT_HEAVY), (f"{arch!r} not in derived.json: "
                                 f"default {DEFAULT_HEAVY}")


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
    return tags[0] if tags else DEFAULT_HEAVY[0]


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


def run_engine(args, cfg, model, params):
    """Real-model serving through the Policy/Topology engine. Returns the
    engine's metrics and the executor (which holds every request's
    tokens)."""
    P, N = args.prompt, args.max_new
    max_seq = P + N
    tags, src = heavy_tags(args.arch)
    heavy = _print_identification(tags, src)
    print(f"[serve] tagging {heavy!r} as the heavy (AVX-analogue) phase;"
          " SpecializedPolicy confines it to the prefill pool")
    print(f"[serve] warm-up: {warm_up(model, params, P, max_seq):.2f}s\n")

    topo = Topology.serving(n_devices=2, prefill_devices=1)
    policy = SpecializedPolicy()
    ex = RealModelExecutor(model, params, cfg.vocab, P, max_seq,
                           seed=args.seed)
    interval_ms = 1000.0 / args.rate
    reqs = [Request(rid=i, arrive_ms=i * interval_ms, prompt_len=P,
                    max_new=N) for i in range(args.requests)]
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


def run_loop(args, cfg, model, params):
    """Plain batched loop (no scheduler), kept for comparison. Returns
    the prompts and greedy tokens of every batch."""
    B, P, N = args.batch, args.prompt, args.max_new
    max_seq = P + N
    tags, src = heavy_tags(args.arch)
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
    ap.add_argument("--mode", choices=("engine", "loop"), default="engine")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="request arrival rate (req/s of engine time)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights and the prompts")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu "
                         "only when asked for)")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reference's CPU-sized config instead "
                         "of the published one")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.reduced() if args.reduced else arch
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
    return run_loop(args, cfg, model, params)


if __name__ == "__main__":
    main()
