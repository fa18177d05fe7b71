"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each ending in one line:
  1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
  2. the build: ``nvcc`` compiles every kernel of the serve path;
  3. the kernels: each kernel against its plain PyTorch version on the card,
     in fp32 (tolerance 2e-5, TF32 off) and bf16 (2e-2 prefill, 3e-2
     decode), at the serving shapes of qwen1.5-0.5b and at a GQA shape of
     starcoder2-15b's widths, with its time, the plain version's, one
     PyTorch library call's (``scaled_dot_product_attention``, a yardstick
     the port never calls) and the least time the card could take;
  4. serving: qwen1.5-0.5b at its published width and depth through the
     engine (``repro_torch.launch.serve.main``), with the kernels' launch
     counters reset just before and read just after; then one prefill and
     a few decode steps of the served model under ``torch.profiler``, for
     the device's busy time, idle share and top kernels;
  5. the end-to-end check: at the published width in fp32, prefill and
     greedy decode through the kernels against the same model with the
     kernels' plain versions swapped in, on the card; and the served bf16
     ``unembed`` against fp32 sums, to show its logits stay fp32;
then the ``kernels`` JSON line, the card line, and the result line.

Any failed phase exits non-zero. Nothing runs on the CPU in place of the
card: without CUDA the script fails.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
ARCH = "qwen1.5-0.5b"
SERVE = dict(requests=8, prompt=512, max_new=64, batch=4)
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,            # dense tensor-core bf16
              "float32": 67e12}              # fp32 outside the tensor cores
TOL = {"flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
       "flash_decode": {"float32": 2e-5, "bfloat16": 3e-2}}
KERNELS = {
    "flash_attention": {
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:93"},
    "flash_decode": {
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/decode_attention.py:75"},
}


class SmokeFailure(Exception):
    pass


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ----------------------------------------------------------------- timing


def median_ms(fn, iters: int = 50, warmup: int = 5, flush=None) -> float:
    """Median of ``iters`` single-call times from CUDA events, after
    ``warmup`` calls. ``flush`` (a large tensor) is rewritten before each
    call, outside the timed pair, so the call finds the L2 cache cold."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# ----------------------------------------------------------------- phases


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    require(bool(out), "nvidia-smi printed no card")
    return out[0]


def prefill_case(B, H, KVH, S, D, dtype, causal, gen):
    """q/k/v as transpose views of [B,S,*,D] tensors, as the model passes
    them. Returns (args, kwargs, bytes, flops)."""
    import torch
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, KVH, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, KVH, D, generator=gen, device="cuda").to(dtype)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    item = q.element_size()
    nbytes = item * (2 * B * H * S * D + 2 * B * KVH * S * D)
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * D * pairs
    return (q, k, v), {"causal": causal}, nbytes, flops


def decode_case(B, H, KVH, S, D, dtype, lengths, gen):
    """q [B,H,D] and the cache [B,S,KVH,D] as a permute view, with
    ragged lengths. Returns (args, kwargs, bytes, flops)."""
    import torch
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, S, KVH, D, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(B, S, KVH, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    item = q.element_size()
    n = sum(min(x, S) for x in lengths)
    nbytes = item * (2 * B * H * D + 2 * n * KVH * D) + 4 * B
    flops = 4 * H * D * n
    return ((q, kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3), lens), {},
            nbytes, flops)


def library_call(name, args, kwargs):
    """One PyTorch call computing the same function (timed only)."""
    import torch
    import torch.nn.functional as F
    if name == "flash_attention":
        q, k, v = args
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=kwargs["causal"], enable_gqa=True)
    q, k, v, lens = args
    mask = (torch.arange(k.shape[2], device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], k, v, attn_mask=mask, enable_gqa=True)


def check_kernel(name, case, label, dtype_name, timed):
    """Kernel against its plain version on the same inputs; optionally
    timed. Returns a result dict."""
    import torch
    from repro_torch.kernels import decode_attention, flash_attention, ref
    kern = {"flash_attention": flash_attention.flash_attention,
            "flash_decode": decode_attention.flash_decode}[name]
    plain = {"flash_attention": ref.attention_ref,
             "flash_decode": ref.decode_attention_ref}[name]
    args, kwargs, nbytes, flops = case
    got = kern(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name} {label}: {tuple(got.shape)} {got.dtype} vs plain "
            f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    require(bool(torch.isfinite(g).all()), f"{name} {label}: non-finite")
    tol = TOL[name][dtype_name]
    err = (g - w).abs().max().item()
    ok = bool(((g - w).abs() <= tol + tol * w.abs()).all())
    res = {"shape": label, "dtype": dtype_name, "max_abs_err": err,
           "tol": tol, "ok": ok}
    if timed:
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") \
            if name == "flash_decode" else None
        res["ms"] = median_ms(lambda: kern(*args, **kwargs), flush=flush)
        res["plain_ms"] = median_ms(lambda: plain(*args, **kwargs),
                                    flush=flush)
        res["library_ms"] = median_ms(library_call(name, args, kwargs),
                                      flush=flush)
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        res["bound_ms"] = max(by_bytes, by_ops)
        res["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    say(f"  {name} {label} {dtype_name}: max_abs_err={err:.3g} (tol {tol})"
        + (f" ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
           f"library_ms={res['library_ms']:.4f} bound_ms="
           f"{res['bound_ms']:.4f} ({res['bound_by']})" if timed else "")
        + ("" if ok else "  MISMATCH"))
    return res


def kernel_phase():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"flash_attention": [], "flash_decode": []}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        timed = True
        results["flash_attention"] += [
            check_kernel("flash_attention",
                         prefill_case(1, 16, 16, 512, 64, dtype, True, gen),
                         "serve B1 H16 KVH16 S512 D64 causal", dname, timed),
            check_kernel("flash_attention",
                         prefill_case(4, 48, 4, 500, 128, dtype, True, gen),
                         "gqa B4 H48 KVH4 S500 D128 causal", dname, timed),
            check_kernel("flash_attention",
                         prefill_case(2, 48, 4, 77, 128, dtype, False, gen),
                         "gqa B2 H48 KVH4 S77 D128 full", dname, False),
        ]
        results["flash_decode"] += [
            check_kernel("flash_decode",
                         decode_case(1, 16, 16, 576, 64, dtype, [513], gen),
                         "serve B1 H16 KVH16 S576 D64 len513", dname, timed),
            check_kernel("flash_decode",
                         decode_case(4, 48, 4, 576, 128, dtype,
                                     [1, 100, 511, 576], gen),
                         "gqa B4 H48 KVH4 S576 D128 len{1,100,511,576}",
                         dname, timed),
        ]
    bad = [(n, r["shape"], r["dtype"]) for n, rs in results.items()
           for r in rs if not r["ok"]]
    require(not bad, f"kernels disagree with their plain versions: {bad}")
    return results


def serve_phase():
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--mode", "engine"]
    for k, v in SERVE.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    ops.reset_launch_counts()
    m, ex = serve.main(argv)
    launches = ops.launch_counts()
    n, N = SERVE["requests"], SERVE["max_new"]
    require(m.completed == n, f"{m.completed}/{n} requests completed")
    from repro_torch.configs import get_arch
    cfg = get_arch(ARCH)
    need = {"flash_attention": n * cfg.n_layers,
            "flash_decode": n * (N - 1) * cfg.n_layers}
    for name, k in need.items():
        require(launches[name] >= k,
                f"{name} launched {launches[name]} times, expected >= {k}")
    for rid in range(n):
        toks = ex.generated(rid)
        require(len(toks) == N and all(0 <= t < cfg.vocab for t in toks),
                f"request {rid}: tokens {toks[:8]}...")
    return m, ex, launches


def profile_phase(model, params, steps: int = 8):
    """Where a serving step's time goes: one prefill of the serve prompt
    and ``steps`` decode steps of one request, traced with
    ``torch.profiler``. Prints wall time, device busy time (union of the
    kernels' intervals), the idle share and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    P, dev = SERVE["prompt"], model.device
    toks = torch.randint(0, model.cfg.vocab, (1, P), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def traced(fn):
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
        busy, end = 0.0, float("-inf")
        for s, e in spans:
            if e > end:
                busy += e - max(s, end)
                end = e
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        return wall_us, busy, len(kern), top

    state = {}

    def prefill():
        cache = model.init_cache(params, None, 1, P + steps + 1)
        logits, state["cache"] = model.prefill(params, {"tokens": toks}, cache)
        state["tok"] = logits.argmax(-1)[:, None]

    def decode():
        lengths = torch.full((1,), P, dtype=torch.int32, device=dev)
        for _ in range(steps):
            logits, state["cache"] = model.decode_step(
                params, state["cache"], state["tok"], lengths)
            state["tok"], lengths = logits.argmax(-1)[:, None], lengths + 1

    prefill()                                       # warm
    for name, fn, n in (("prefill", prefill, 1), ("decode", decode, steps)):
        wall, busy, nk, top = traced(fn)
        if nk == 0:
            say(f"  {name}: wall {wall / n / 1e3:.3f} ms/step; device time "
                "not measured (the profiler saw no CUDA kernels)")
            continue
        say(f"  {name}: wall {wall / n / 1e3:.3f} ms/step, device busy "
            f"{busy / n / 1e3:.3f} ms/step, idle share {1 - busy / wall:.3f}, "
            f"{nk / n:.0f} kernels/step; top: " + "; ".join(
                f"{k[:48]} {v / n:.1f} us" for k, v in top))


@contextlib.contextmanager
def plain_attention():
    """Swap the kernels' plain versions into the model's dispatchers."""
    from repro_torch.kernels import ops, ref
    saved = ops.flash_attention, ops.flash_decode
    ops.flash_attention = ref.attention_ref
    ops.flash_decode = ref.decode_attention_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.flash_decode = saved


def end_to_end_phase(steps: int = 8, prompt: int = 512):
    """Published width and depth in fp32: prefill + greedy decode through
    the kernels, against the same weights with the plain versions."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(get_arch(ARCH), param_dtype="float32",
                              compute_dtype="float32")
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (2, prompt), generator=gen,
                         device="cuda")

    def run():
        cache = model.init_cache(params, None, 2, prompt + steps)
        logits, cache = model.prefill(params, {"tokens": toks}, cache)
        out, tok = [logits], logits.argmax(-1)[:, None]
        lengths = torch.full((2,), prompt, dtype=torch.int32, device="cuda")
        for _ in range(steps):
            logits, cache = model.decode_step(params, cache, tok, lengths)
            out.append(logits)
            tok, lengths = logits.argmax(-1)[:, None], lengths + 1
        return torch.stack(out)

    got = run()
    with plain_attention():
        want = run()
    require(bool(torch.isfinite(got).all()), "end-to-end logits not finite")
    err = (got - want).abs().max().item()
    tol = 1e-3 * max(1.0, want.abs().max().item())
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    say(f"  end-to-end fp32 {cfg.n_layers} layers, prompt {prompt} + "
        f"{steps} decode steps x 2 sequences: max logit err {err:.3g} "
        f"(tol {tol:.3g}), greedy tokens equal: {same}")
    require(err <= tol and same, "kernel path disagrees with the plain "
            "path at the published width")
    return err


def unembed_phase(rows: int = 4, tol: float = 1e-3):
    """The served bf16 ``unembed`` at the published width keeps fp32
    logits: against the same bf16 operands widened to fp32 (exact
    products, fp32 sums), at logits of standard deviation about 19, where
    the bf16 step is 0.06 to 0.5."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import unembed
    cfg = get_arch(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(rows, 1, cfg.d_model, generator=gen, device="cuda")
    w = torch.randn(cfg.vocab, cfg.d_model, generator=gen, device="cuda")
    x, w = x.to(torch.bfloat16), (w * 0.6).to(torch.bfloat16)
    got = unembed(x, w, torch.bfloat16)
    want = x.float() @ w.float().T
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    big = want.abs().max().item()
    say(f"  unembed bf16 [{rows},{cfg.d_model}] x [{cfg.vocab},"
        f"{cfg.d_model}]: logits {got.dtype}, max |logit| {big:.3g}, max "
        f"err vs fp32 sums {err:.3g} (tol {tol})")
    require(got.dtype == torch.float32 and got.shape == want.shape,
            f"unembed gave {got.dtype} {tuple(got.shape)}")
    require(big > 10.0 and err <= tol,
            "unembed logits are not fp32-accurate")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("[chip_smoke] FAIL: src/repro_torch not found; run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is false; "
              "this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        card = card_line()
        say(f"phase 1 card: {card}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}")

        from repro_torch.kernels import build
        secs = build.build(KERNELS)
        say(f"phase 2 build: {len(KERNELS)} kernels with nvcc in "
            f"{secs:.1f}s ({' '.join(build.NVCC_FLAGS)})")

        say("phase 3 kernels against their plain versions:")
        results = kernel_phase()
        say("phase 3 kernels: all agree")

        say("phase 4 serving:")
        m, ex, launches = serve_phase()
        s = m.summary()
        say(f"phase 4 serving: {m.completed}/{SERVE['requests']} requests, "
            f"ttft p50/p99 {s['ttft_p50_ms']:.3f}/{s['ttft_p99_ms']:.3f} ms, "
            f"itl p50/p99 {s['itl_p50_ms']:.3f}/{s['itl_p99_ms']:.3f} ms, "
            f"launches {launches}, pool_busy {m.pool_busy}, "
            f"freq {{{', '.join(f'{k}: {v['avg_freq_ghz']:.3f} GHz' for k, v in m.pool_freq.items())}}}")
        say("phase 4 where a serving step's time goes (torch.profiler):")
        profile_phase(ex.model, ex.params)

        say("phase 5 end to end against the plain path:")
        end_to_end_phase()
        unembed_phase()
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1

    line = []
    for name, meta in KERNELS.items():
        main_case = next(r for r in results[name]
                         if r["dtype"] == "bfloat16" and "ms" in r)
        line.append({
            "name": name, "route": "cuda", **meta,
            "launches": launches[name],
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "shape": main_case["shape"],
            "checks": results[name]})
    say(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
