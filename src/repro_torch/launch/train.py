"""End-to-end training driver, the port of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 200 --batch 8 --seq 256 --reduced --device cpu \\
      --ckpt-dir build/ckpt

Trains on ``--device cuda`` (the default; it raises when no GPU is present)
or on ``--device cpu`` when asked. Features exercised: the model factory
(every family's ``Model.loss``), the train step with gradient
accumulation, the deterministic resumable data pipeline, async atomic
checkpoints, SIGTERM clean exit, the watchdog, restart/resume. The step
ends in ``torch.cuda.synchronize()`` on the card, so ``ms/step`` is the
step's own time; there it also prints tokens/s. Two flags are the port's
own: ``--dtype`` trains the config in another parameter and compute dtype
(``float32`` beside the published ``bfloat16``, to hold one curve against
the other), and ``--profile-step N`` runs step N under ``torch.profiler``
and returns the profile. The sharded step comes with distribution
(ROADMAP).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import signal
import sys
import time
from dataclasses import dataclass, field

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, DataState, Pipeline
from repro_torch.models.api import build_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import (Watchdog, elastic_restore,
                                       install_preemption_handler)
from repro_torch.train.loop import init_train_state, make_train_step
from repro_torch.train.optimizer import OptConfig


@dataclass
class TrainResult:
    """What a run gives back: the loss of every step it took, each
    step's milliseconds, the final state, the step it started from and
    the profile of ``--profile-step`` (None without it)."""
    losses: list = field(default_factory=list)
    step_ms: list = field(default_factory=list)
    state: dict = None
    start_step: int = 0
    profile: object = None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-order", type=int, default=2,
                    help="synthetic-data dependency distance (1 = easiest)")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="override layer count (0 = config value)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--dtype", default="",
                    help="parameter and compute dtype (default: the "
                         "config's)")
    ap.add_argument("--profile-step", type=int, default=-1,
                    help="run this step under torch.profiler (-1: none)")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiled(on: bool, device: torch.device):
    if not on:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def main(argv=None) -> TrainResult:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if args.dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.dtype,
                                  compute_dtype=args.dtype)
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{cfg.n_layers} layers, {cfg.param_dtype}, device {device}")
    model = build_model(cfg, device)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                        total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, grad_accum=args.grad_accum)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed,
                      synthetic_order=args.data_order)
    pipe = Pipeline(dcfg)
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(args.seed), opt_cfg)
    out = TrainResult(state=state)
    cur_step = [0]

    ckpt, prev_handler = None, None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=2)
        if ckpt.latest_step() is not None:
            state, meta = elastic_restore(ckpt, state, device)
            out.start_step = meta["step"]
            pipe.state = DataState.from_dict(meta.get("data", {}))
            print(f"[train] resumed from step {out.start_step}")

        def on_preempt():
            ckpt.async_save = False
            ckpt.save(cur_step[0], state, {"data": pipe.state.to_dict()})
            print("[train] SIGTERM: checkpointed, exiting")
            sys.exit(0)
        prev_handler = install_preemption_handler(on_preempt)

    wd = Watchdog()
    tokens = args.batch * args.seq
    try:
        for step in range(out.start_step, args.steps):
            cur_step[0] = step
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in pipe.next_batch().items()}
            if cfg.family == "audio":
                batch["frames"] = torch.zeros(
                    (args.batch, cfg.enc_dec.n_frames, cfg.d_model),
                    dtype=torch.float32, device=device)
            _sync(device)
            with _profiled(step == args.profile_step, device) as prof:
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                _sync(device)
                dt_ = time.perf_counter() - t0
            out.profile = prof or out.profile
            trip = wd.observe(dt_)
            if trip:
                print(f"[watchdog] {trip} at step {step} ({dt_:.1f}s)")
            out.losses.append(loss)
            out.step_ms.append(dt_ * 1e3)
            if step % args.log_every == 0 or step == args.steps - 1:
                rate = (f", {tokens / dt_:.0f} tokens/s"
                        if device.type == "cuda" else "")
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({dt_*1e3:.0f} ms/step{rate})", flush=True)
            if ckpt and step > 0 and step % args.ckpt_every == 0:
                ckpt.save(step, state, {"data": pipe.state.to_dict()})
        if ckpt:
            ckpt.async_save = False
            ckpt.save(args.steps, state, {"data": pipe.state.to_dict()})
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    out.state = state
    if out.losses:
        print(f"[train] done: loss {out.losses[0]:.4f} -> "
              f"{out.losses[-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
