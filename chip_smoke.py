"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each ending in one line:
  1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
  2. the build: ``nvcc`` compiles every kernel of the serve and
     calibration paths; ``cuobjdump`` gives
     chacha20's instruction mix and the bf16 ``flash_attention``'s
     tensor-core instructions (``HGMMA``), ``ptxas -v`` the registers,
     spills and static shared memory of each bf16 attention kernel, and
     the decode grid at the serving shape is printed with its launches a
     call;
  3. the kernels: each kernel against its plain PyTorch version on the card.
     The attention kernels in fp32 (tolerance 2e-5, TF32 off) and bf16
     (2e-2 prefill, 3e-2 decode), at the serving shapes of qwen1.5-0.5b
     and at a GQA shape of starcoder2-15b's widths, with one PyTorch
     library call's time (``scaled_dot_product_attention``, a yardstick
     the port never calls). ``chacha20`` bit-exact (0 mismatched words) on
     the RFC 7539 vector, across the 2^32 counter wrap at a block count
     that is no multiple of 256, at the calibration shapes (256 and 64
     blocks) and on 64 MiB of keystream (1,048,576 blocks), which is
     timed (no PyTorch call computes ChaCha20: no library time). Each
     timed case prints its time, the plain version's and the least time
     the card could take, all device-only (``device_ms``: 50 calls queued
     behind a spin kernel, so the host's per-call work is hidden); decode
     rotates over copies of its inputs that exceed the 50 MB L2, so every
     call finds its cache cold, and also prints the older flushed
     single-pair time. ``flash_decode`` is also checked, fp32 and bf16,
     at the cache phase 7's runs give it (batch 1, prompt + max_new =
     520 positions, whose last split chunk is ragged) at the first and
     last decode lengths. The attention kernels are also checked in fp32
     at every shape phase 6's calibration gives them (the kernel suite's
     and the reduced model differential's, from the constants of
     ``repro_torch.analysis.calibrate``);
  4. serving: qwen1.5-0.5b at its published width and depth through the
     engine (``repro_torch.launch.serve.main``), with the kernels' launch
     counters reset just before and read just after; then one prefill and
     a few decode steps of the served model under ``torch.profiler``, for
     the device's busy time, idle share and top kernels;
  5. the end-to-end check: at the published width in fp32, prefill and
     greedy decode through the kernels against the same model with the
     kernels' plain versions swapped in, on the card; and the served bf16
     ``unembed`` against fp32 sums, to show its logits stay fp32;
  6. calibration: ``repro_torch.analysis.calibrate.main`` on the card at
     the full published configs of the five ported archs, with the launch
     counters reset just before and read just after: all three kernels
     must launch, each kernel and every arch's ``prefill`` must be tagged
     heavy as in the reference's ``derived.json`` (``decode_step``'s tags
     are printed beside the reference's), ``derived.json`` must be
     unchanged, and the committed ``derived_cuda.json`` must equal the
     run's kernel and workload entries (their differentials aside);
  7. cluster serving: qwen1.5-0.5b at its published width through
     ``repro_torch.launch.serve``'s cluster path, 2 shards sharing the
     card under ``cluster-adaptive`` and the seeded ``crash`` fault plan,
     24 requests 2.5 s of engine time apart, with the cluster oracle
     attached and the launch counters reset just before and read just
     after: 0 oracle violations, exact conservation (injected = completed
     + shed + expired), at least one fault and one shard recovery, both
     attention kernels launched on every shard's path, and for 4
     completed requests the greedy tokens of the executor that finished
     each equal a fresh single-request run of its recorded prompt; then
     8 requests of the ``multi_tenant`` workload in engine mode must all
     complete;
  8. the intermittency lint (``repro_torch.analysis.lint``) on the card,
     counters reset just before: all three kernels must launch, and the
     ranked findings must equal the committed ``lint_baseline_cuda.json``
     (its three untagged ``decode_step`` findings included, which
     ``--check-baseline`` fails on by design);
then the ``kernels`` JSON line, the card line, and the result line.

Any failed phase exits non-zero. Nothing runs on the CPU in place of the
card: without CUDA the script fails.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ARCH = "qwen1.5-0.5b"
SERVE = dict(requests=8, prompt=512, max_new=64, batch=4)
# phase 7: 24 arrivals 2.5 s of engine time apart (a 57.5 s window, in
# which the seeded crash plan fails and recovers shards), 2 shards
CLUSTER = dict(shards=2, cluster_policy="cluster-adaptive",
               fault_plan="crash", requests=24, rate=0.4, prompt=512,
               max_new=8, batch=4)
CLUSTER_TOKEN_CHECKS = 4
WORKLOAD = dict(workload="multi_tenant", requests=8, prompt=512, max_new=8,
                batch=4)
CALIB_OUT = ROOT / "build" / "repro_torch" / "derived_cuda.json"
# decode timings rotate over copies of their inputs that together exceed
# the H100's 50 MB L2 cache
ROTATE_BYTES = 75e6
TOL = {"flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
       "flash_decode": {"float32": 2e-5, "bfloat16": 3e-2}}
KERNELS = {
    "flash_attention": {
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:93"},
    "flash_decode": {
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/decode_attention.py:75"},
    "chacha20": {
        "source": "src/repro_torch/csrc/chacha20.cu",
        "replaces": "src/repro/kernels/chacha20.py:89"},
}
# ChaCha20 keystream block 1 of RFC 7539 section 2.3.2 (key 00..1f,
# nonce 000000090000004a00000000, counter 1), little-endian bytes
RFC_BLOCK1 = bytes.fromhex(
    "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
    "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")
# 32-bit instructions the card issues for one ChaCha20 block: 10 double
# rounds x 8 quarter rounds x (4 adds, 4 xors, 4 rotates as one SHF or
# PRMT each) + 16 final adds (csrc/chacha20.cu)
CHACHA20_INSTR_PER_BLOCK = 10 * 8 * 12 + 16


class SmokeFailure(Exception):
    pass


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def machine():
    """The H100's data-sheet rates, kept in one place: the port's
    ``MachineModel`` (``repro_torch.analysis.regions``)."""
    from repro_torch.analysis.regions import MachineModel
    return MachineModel()


# ----------------------------------------------------------------- timing


def flushed_ms(fn, iters: int = 50, warmup: int = 5, flush=None) -> float:
    """Time of one call from CUDA events: the median of ``iters``
    single-call event pairs, with ``flush`` (a large tensor) rewritten
    before each pair outside it so that the call finds the L2 cache cold.
    A single pair also holds whatever of the host's per-call work the
    rewrite does not cover; kept for continuity with PERF.md's history."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_ms(fns, iters: int = 50, reps: int = 5) -> dict:
    """Device time of one call, with the host left out: ``iters`` calls,
    rotating over ``fns`` (each a call on its own copy of the inputs, so
    that enough copies find the L2 cache cold), queued between one
    CUDA-event pair behind a spin kernel (``torch.cuda._sleep``) that
    lasts longer than the host takes to queue them. The device then runs
    the calls back to back whatever the host's per-call work (argument
    checks, custom-op dispatch, ``ctypes``). Returns the median over
    ``reps`` pairs of the pair's time over ``iters``, and ``hidden``:
    whether in every pair the host queued the last call before the device
    could have run out of work (the host's queueing time below the spin's
    plus the calls'). A host that blocks on a full launch queue (a plain
    version's many small kernels) waits for the device and hides too."""
    import torch
    fns = list(fns)
    for fn in fns:                      # warm every copy once
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fns[i % len(fns)]()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # 2 GHz is above the SM clock, so the spin lasts at least this long
    cycles = int(2.0e9 * (2 * host_s + 2e-4))
    runs = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for i in range(iters):
            fns[i % len(fns)]()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        runs.append((ev, host_ms))
    torch.cuda.synchronize()
    spins = [ev[0].elapsed_time(ev[1]) for ev, _ in runs]
    calls = [ev[1].elapsed_time(ev[2]) for ev, _ in runs]
    return {"ms": statistics.median(calls) / iters,
            "hidden": all(h < sp + c for (_, h), sp, c
                          in zip(runs, spins, calls))}


# ----------------------------------------------------------------- phases


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    require(bool(out), "nvidia-smi printed no card")
    return out[0]


def prefill_case(B, H, KVH, S, D, dtype, causal, gen, contiguous=False):
    """q/k/v as transpose views of [B,S,*,D] tensors, as the model passes
    them, or ``contiguous`` [B,*,S,D] tensors, as calibration passes
    them. Returns (args, kwargs, bytes, flops)."""
    import torch

    def make(heads):
        t = torch.randn(B, S, heads, D, generator=gen, device="cuda")
        t = t.to(dtype).transpose(1, 2)
        return t.contiguous() if contiguous else t

    q, k, v = make(H), make(KVH), make(KVH)
    item = q.element_size()
    nbytes = item * (2 * B * H * S * D + 2 * B * KVH * S * D)
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * D * pairs
    return (q, k, v), {"causal": causal}, nbytes, flops


def decode_case(B, H, KVH, S, D, dtype, lengths, gen, contiguous=False):
    """q [B,H,D] and the cache [B,S,KVH,D] as a permute view, as the
    model's cache gives it, or ``contiguous`` [B,KVH,S,D], as calibration
    passes it; with ragged lengths. Returns (args, kwargs, bytes, flops)."""
    import torch

    def make():
        t = torch.randn(B, S, KVH, D, generator=gen, device="cuda")
        t = t.to(dtype).permute(0, 2, 1, 3)
        return t.contiguous() if contiguous else t

    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kc, vc = make(), make()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    item = q.element_size()
    n = sum(min(x, S) for x in lengths)
    nbytes = item * (2 * B * H * D + 2 * n * KVH * D) + 4 * B
    flops = 4 * H * D * n
    return (q, kc, vc, lens), {}, nbytes, flops


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
        copies = [args]
        if name == "flash_decode":
            # a decode call reads a cache that the previous layer's call did
            # not leave in L2: rotate over copies that together exceed it
            per = sum(t.numel() * t.element_size() for t in args)
            copies += [tuple(t.clone() for t in args)
                       for _ in range(math.ceil(ROTATE_BYTES / per) - 1)]
        res["host_hidden"] = {}
        for key, make in (
                ("ms", lambda a: lambda: kern(*a, **kwargs)),
                ("plain_ms", lambda a: lambda: plain(*a, **kwargs)),
                ("library_ms", lambda a: library_call(name, a, kwargs))):
            t = device_ms([make(a) for a in copies])
            res[key] = t["ms"]
            res["host_hidden"][key] = t["hidden"]
        res["copies"] = len(copies)
        if name == "flash_decode":
            flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
            res["flushed_ms"] = flushed_ms(lambda: kern(*args, **kwargs),
                                           flush=flush)
        m = machine()
        peak = {"bfloat16": m.tensor_flops_per_s,
                "float32": m.vector_flops_per_s}[dtype_name]
        by_bytes = nbytes / m.hbm_bytes_per_s * 1e3
        by_ops = flops / peak * 1e3
        res["bound_ms"] = max(by_bytes, by_ops)
        res["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    say(f"  {name} {label} {dtype_name}: max_abs_err={err:.3g} (tol {tol})"
        + (f" ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
           f"library_ms={res['library_ms']:.4f} bound_ms="
           f"{res['bound_ms']:.4f} ({res['bound_by']}); device-only over "
           f"{res['copies']} input copies, host hidden (kernel/plain/"
           f"library): {'/'.join(str(v) for v in res['host_hidden'].values())}"
           + (f"; flushed single-pair ms={res['flushed_ms']:.4f}"
              if "flushed_ms" in res else "") if timed else "")
        + ("" if ok else "  MISMATCH"))
    return res


def u32_words(n, gen):
    """n random u32 words on the card, made through their int32 bits."""
    import torch
    return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                         generator=gen, device="cuda").view(torch.uint32)


def check_chacha20(label, key, nonce, counter0, n_blocks, timed=False):
    """The kernel against its plain version, bit-exact; optionally timed
    (the plain version over fewer launches: it runs about 2,500 int64
    kernels a call)."""
    import torch
    from repro_torch.kernels import chacha20, ref
    got = chacha20.keystream(key, nonce, counter0, n_blocks)
    want = ref.chacha20_keystream_ref(key, nonce, counter0, n_blocks)
    torch.cuda.synchronize()
    require(got.shape == want.shape == (n_blocks, 16)
            and got.dtype == want.dtype == torch.uint32,
            f"chacha20 {label}: {tuple(got.shape)} {got.dtype} vs plain "
            f"{tuple(want.shape)} {want.dtype}")
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    err = int((ref.u32_to_i64(got) - ref.u32_to_i64(want)).abs().max())
    res = {"shape": label, "dtype": "uint32", "max_abs_err": err,
           "mismatched_words": bad, "tol": 0, "ok": bad == 0}
    if timed:
        m = machine()
        res["ms"] = device_ms(
            [lambda: chacha20.keystream(key, nonce, counter0, n_blocks)])["ms"]
        res["plain_ms"] = device_ms(
            [lambda: ref.chacha20_keystream_ref(key, nonce, counter0,
                                                n_blocks)], iters=5,
            reps=3)["ms"]
        res["library_ms"] = None
        nbytes = 4 * (8 + 3) + 64 * n_blocks
        by_bytes = nbytes / m.hbm_bytes_per_s * 1e3
        by_ops = CHACHA20_INSTR_PER_BLOCK * n_blocks / m.lane_ops_per_s * 1e3
        res["bound_ms"] = max(by_bytes, by_ops)
        res["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    say(f"  chacha20 {label}: {bad} mismatched words, max_abs_err={err}"
        + (f" ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
           f"library_ms=none bound_ms={res['bound_ms']:.4f} "
           f"({res['bound_by']}: {CHACHA20_INSTR_PER_BLOCK} 32-bit "
           f"instructions a block at {m.lane_ops_per_s:.4g}/s, "
           f"{nbytes} bytes at {m.hbm_bytes_per_s:.4g} B/s)"
           if timed else "")
        + ("" if res["ok"] else "  MISMATCH"))
    return res


def chacha20_checks():
    import torch
    from repro_torch.kernels import chacha20
    gen = torch.Generator(device="cuda").manual_seed(5)
    rfc_key = torch.frombuffer(bytearray(range(32)), dtype=torch.int32)
    rfc_nonce = torch.frombuffer(
        bytearray.fromhex("000000090000004a00000000"), dtype=torch.int32)
    rfc_key, rfc_nonce = (t.to("cuda").view(torch.uint32)
                          for t in (rfc_key, rfc_nonce))
    rfc = check_chacha20("RFC 7539 2.3.2, counter 1, 4 blocks", rfc_key,
                         rfc_nonce, 1, 4)
    block1 = chacha20.keystream(rfc_key, rfc_nonce, 1, 1).view(torch.int32)
    same = block1.cpu().numpy().astype("<i4").tobytes() == RFC_BLOCK1
    rfc["ok"] = rfc["ok"] and same
    say(f"  chacha20 RFC block 1 equals the RFC's bytes: {same}")
    key, nonce = u32_words(8, gen), u32_words(3, gen)
    return [rfc] + [
        check_chacha20(label, key, nonce, ctr, n, timed)
        for label, ctr, n, timed in (
            ("counter 2^32-3, 1000 blocks (wrap, tail)", 2**32 - 3, 1000,
             False),
            ("calibration 256 blocks", 1, 256, False),
            ("calibration 64 blocks", 1, 64, False),
            ("64 MiB, 1048576 blocks", 7, 1 << 20, True))]


def demangle(names):
    """C++ names of mangled kernel symbols (``c++filt``), or the symbols."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return list(names)
    return [o.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ") for o in out] \
        if len(out) == len(names) else list(names)


def sass_ops(name: str) -> dict:
    """SASS opcode counts of each kernel in the built library ``name``,
    from ``cuobjdump``, keyed by the kernel's C++ name."""
    import collections
    import re

    from repro_torch.kernels import build
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(build._so_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)", sass)[1:]
    funcs = {}
    for fn, body in zip(demangle(parts[0::2]), parts[1::2]):
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)",
                body))
        ops.pop("NOP", None)
        funcs[fn] = ops
    return funcs


def chacha20_sass() -> str:
    """Instruction mix of the built chacha20 kernel, beside the count its
    bound assumes. The kernel has no loop left after unrolling, so each
    instruction runs once a block."""
    import collections
    funcs = sass_ops("chacha20")
    if not funcs:
        return "not measured (no cuobjdump)"
    ops = sum(funcs.values(), collections.Counter())
    top = ", ".join(f"{k} {v}" for k, v in ops.most_common(8))
    return (f"{sum(ops.values())} instructions ({top}); the bound counts "
            f"{CHACHA20_INSTR_PER_BLOCK}")


def ptxas_usage(name: str) -> dict:
    """Registers, spills and static shared memory of each kernel of the
    library ``name``, from ``ptxas -v`` as this process's build printed
    it, keyed by the kernel's C++ name."""
    import re

    from repro_torch.kernels import build
    usage, fn = {}, None
    for line in build.LOGS.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[fn]["spills"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[fn]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            usage[fn]["smem"] = int(s.group(1)) if s else 0
    return dict(zip(demangle(list(usage)), usage.values()))


def is_bf16(fn: str) -> bool:
    """Whether a kernel's C++ name is a bf16 instantiation (the tensor-core
    attention kernel takes bf16 only and has no type parameter)."""
    return "bfloat16" in fn or "_tc_kernel" in fn


def kernel_build_report() -> None:
    """Phase 2's lines for the attention kernels: each bf16 instantiation's
    registers, spills and static shared memory (``ptxas -v``), the
    tensor-core instructions
    of the bf16 ``flash_attention`` (``HGMMA`` for ``wgmma``, ``HMMA`` for
    ``mma.sync``), and the decode grid at the serve shape."""
    import collections

    from repro_torch.kernels import build, decode_attention, flash_attention
    for name in ("flash_attention", "flash_decode"):
        use = {fn: u for fn, u in ptxas_usage(name).items() if is_bf16(fn)}
        warn = sorted({line.split(":", 1)[-1].strip()[:160] for line in
                       build.LOGS.get(name, "").splitlines()
                       if "Performance" in line or "arning" in line})
        if warn:
            say(f"  {name} ptxas warnings: " + " | ".join(warn))
        say(f"  {name} ptxas (bf16): " + ("; ".join(
            f"{fn} {u.get('registers')} regs, {u.get('spills')} B spilled, "
            f"{u.get('smem')} B static smem" for fn, u in sorted(use.items()))
            or "not measured (the library was not built by this process)"))
    say("  flash_attention dynamic shared memory a block, D 16/32/64/128: "
        + "; ".join(f"{dt}{gl} {[flash_attention.smem_bytes(dt, d, g) for d in (16, 32, 64, 128)]}"
                    for dt, g, gl in (("float32", 1, ""),
                                      ("bfloat16", 1, " G odd"),
                                      ("bfloat16", 2, " G even"))))
    funcs = sass_ops("flash_attention")
    tc = {fn: {op: n for op, n in ops.items() if op in ("HGMMA", "HMMA")}
          for fn, ops in funcs.items()
          if is_bf16(fn) and "flash_attention" in fn}
    tc_total = sum((collections.Counter(v) for v in tc.values()),
                   collections.Counter())
    say(f"  flash_attention bf16 tensor-core SASS: {dict(tc_total) or 0} "
        f"over {len(tc)} instantiations" if funcs else
        "  flash_attention SASS: not measured (no cuobjdump)")
    grid = (decode_attention.plan_splits(1, 16, 576, 132)[0], 16, 1)
    say(f"  flash_decode grid at the serve shape (B1 KVH16 S576): {grid}, "
        f"{math.prod(grid)} blocks; {decode_attention.LAUNCHES_PER_CALL} "
        "CUDA launch a call")
    return tc_total


def calibration_shape_checks(gen):
    """The attention kernels at the shapes, layouts and dtypes that phase
    6's calibration gives them (constants of
    ``repro_torch.analysis.calibrate``), on random data: the kernel
    suite's timelines and differential, contiguous fp32, and the reduced
    configs' prefills of the model differential, as the model passes
    them."""
    import torch
    from repro_torch.analysis import calibrate as cal
    from repro_torch.configs import get_arch
    checks = {"flash_attention": [], "flash_decode": []}
    for what, (B, H, S, D) in (("timeline", cal.TIMELINE_ATTENTION_SHAPE),
                               ("differential", cal.DIFF_ATTENTION_SHAPE)):
        checks["flash_attention"].append(check_kernel(
            "flash_attention", prefill_case(B, H, H, S, D, torch.float32,
                                            True, gen, contiguous=True),
            f"calibration {what} B{B} H{H} S{S} D{D} causal", "float32",
            False))
    B, H, S, D = cal.TIMELINE_DECODE_SHAPE
    checks["flash_decode"].append(check_kernel(
        "flash_decode", decode_case(B, H, H, S, D, torch.float32, [S] * B,
                                    gen, contiguous=True),
        f"calibration timeline B{B} H{H} S{S} D{D} len{S}", "float32",
        False))
    for arch in cal.DIFFERENTIAL_ARCHS:
        cfg = get_arch(arch).reduced()
        H, KVH, D = cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
        dname = cfg.compute_dtype
        checks["flash_attention"].append(check_kernel(
            "flash_attention", prefill_case(
                1, H, KVH, cal.DIFF_PROMPT, D, getattr(torch, dname), True,
                gen), f"calibration {arch} reduced prefill B1 H{H} KVH{KVH} "
            f"S{cal.DIFF_PROMPT} D{D} causal", dname, False))
    return checks


def cluster_decode_checks(dname, dtype, gen):
    """``flash_decode`` at the cache that phase 7's cluster and workload
    runs give it: batch 1, ``prompt + max_new`` positions, which the
    split planner cuts into chunks with a ragged last one. Lengths: the
    prompt (a whole number of chunks), the first decode step's and the
    last's."""
    from repro_torch.configs import get_arch
    cfg = get_arch(ARCH)
    H, KVH, D = cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    checks = []
    for P, N in sorted({(run["prompt"], run["max_new"])
                        for run in (CLUSTER, WORKLOAD)}):
        S = P + N
        for length in (P, P + 1, S - 1):
            checks.append(check_kernel(
                "flash_decode",
                decode_case(1, H, KVH, S, D, dtype, [length], gen),
                f"cluster B1 H{H} KVH{KVH} S{S} D{D} len{length}", dname,
                False))
    return checks


def kernel_phase():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"flash_attention": [], "flash_decode": [],
               "chacha20": chacha20_checks()}
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
        results["flash_decode"] += cluster_decode_checks(dname, dtype, gen)
    for name, checks in calibration_shape_checks(gen).items():
        results[name] += checks
    bad = [(n, r["shape"], r["dtype"]) for n, rs in results.items()
           for r in rs if not r["ok"]]
    require(not bad, f"kernels disagree with their plain versions: {bad}")
    return results


def serve_argv(mode: str, settings: dict) -> list:
    argv = ["--arch", ARCH, "--mode", mode]
    for k, v in settings.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return argv


def serve_phase():
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    argv = serve_argv("engine", SERVE)
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


def calibration_phase():
    """``python -m repro_torch.analysis.calibrate`` on the card, through its
    ``main``: kernel timelines and differentials launch the three kernels,
    the five ported archs are analysed at their published configs on the
    meta device. Returns the launches of that run."""
    import hashlib

    from repro_torch.analysis import derived
    from repro_torch.analysis.calibrate import DERIVED_CUDA_PATH
    from repro_torch.analysis.calibrate import main as calibrate_main
    from repro_torch.analysis.calibrate import ported_archs
    from repro_torch.kernels import ops

    def digest():
        return hashlib.sha256(derived.DERIVED_PATH.read_bytes()).hexdigest()

    before = digest()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = calibrate_main(["--out", str(CALIB_OUT)])
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    say(f"  calibration wall {wall:.1f}s, exit {rc}, launches {launches}")
    require(rc == 0, f"calibration exited {rc}")
    for name in KERNELS:
        require(launches[name] >= 1,
                f"{name} launched {launches[name]} times in calibration")
    data = json.loads(CALIB_OUT.read_text())
    ref = json.loads(derived.DERIVED_PATH.read_text())
    ported, _ = ported_archs()
    require(sorted(data["workloads"]) == sorted(ported),
            f"calibrated {sorted(data['workloads'])}, expected {ported}")
    for name in KERNELS:
        tags = data["kernels"][name]["tags"]
        require(name in tags and name in ref["kernels"][name]["tags"],
                f"kernel {name} tags {tags} (reference "
                f"{ref['kernels'][name]['tags']})")
    for arch, w in sorted(data["workloads"].items()):
        pre, dec = w["prefill"], w["decode_step"]
        heavy = [dec["est_us"] * dec["heavy_share"],
                 pre["est_us"] * pre["heavy_share"]]
        say(f"  {arch}: tags {w['tags']} (reference "
            f"{ref['workloads'][arch]['tags']}); decode/prefill heavy time "
            f"{heavy[0]:.1f}/{heavy[1]:.1f} us = {heavy[0] / heavy[1]:.4f} "
            "(tag_heavy's rel_duration is 0.10)")
        require("prefill" in w["tags"]
                and "prefill" in ref["workloads"][arch]["tags"],
                f"{arch}: prefill not tagged heavy ({w['tags']})")
    require(digest() == before, "derived.json changed during calibration")
    committed = json.loads(DERIVED_CUDA_PATH.read_text())
    stale = [f"{part}/{name}" for part in ("kernels", "workloads")
             for name, entry in committed[part].items()
             if {k: v for k, v in entry.items() if k != "differential"}
             != {k: v for k, v in data[part][name].items()
                 if k != "differential"}]
    say(f"  the committed derived_cuda.json equals this run's kernels and "
        f"workloads (differentials aside): {not stale}")
    require(not stale, f"derived_cuda.json is stale for {stale}")
    return launches


@contextlib.contextmanager
def counting_executors():
    """Make every executor the serve path builds count the kernel launches
    of its own calls (``ex.launches``), from the wrappers' counters."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    base = serve.RealModelExecutor

    class Counting(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.launches = dict.fromkeys(ops.KERNEL_MODULES, 0)

        def _counted(self, call, *args):
            before = ops.launch_counts()
            out = call(*args)
            for name, n in ops.launch_counts().items():
                self.launches[name] += n - before[name]
            return out

        def prefill(self, *args):
            return self._counted(super().prefill, *args)

        def decode(self, *args):
            return self._counted(super().decode, *args)

    serve.RealModelExecutor = Counting
    try:
        yield
    finally:
        serve.RealModelExecutor = base


def greedy_tokens(ex, prompt, max_new: int) -> list:
    """A fresh single-request run of ``prompt`` through the executor's
    model: prefill and ``max_new - 1`` greedy decode steps at batch 1."""
    import torch
    model, params = ex.model, ex.params
    toks = torch.as_tensor(prompt[None], dtype=torch.long,
                           device=model.device)
    cache = model.init_cache(params, {"tokens": toks}, 1, ex.max_seq)
    logits, cache = model.prefill(params, {"tokens": toks}, cache)
    tok = logits.argmax(-1)[:, None]
    out = [int(tok)]
    length = torch.full((1,), toks.shape[1], dtype=torch.int32,
                        device=model.device)
    for _ in range(max_new - 1):
        logits, cache = model.decode_step(params, cache, tok, length)
        tok, length = logits.argmax(-1)[:, None], length + 1
        out.append(int(tok))
    return out


def cluster_phase():
    """Cluster serving with the crash fault plan at the published width,
    then a workload in engine mode. Returns the cluster run's launches,
    its summary and the phase's wall seconds."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    with counting_executors():
        ops.reset_launch_counts()
        m, executors, oracle = serve.main(serve_argv("cluster", CLUSTER))
        launches = ops.launch_counts()
    s = m.summary()
    n = CLUSTER["requests"]
    say(f"  cluster: {s['completed']}/{n} completed, shed "
        f"{s['shed_total']}, expired {s['expired_total']}, leftover "
        f"{s['leftover']}; faults {dict(m.faults_injected)}, recoveries "
        f"{s['shard_recoveries']}, drained {s['drained']}, retries "
        f"{s['retries']}; oracle violations {oracle.n_violations}; "
        f"launches {launches}")
    require(oracle.n_violations == 0,
            f"cluster oracle violations: {oracle.violations[:5]}")
    require(s["injected"] == n and s["leftover"] == 0
            and s["injected"] == s["completed"] + s["shed_total"]
            + s["expired_total"],
            f"conservation broken: {s['injected']} injected, "
            f"{s['completed']} completed, {s['shed_total']} shed, "
            f"{s['expired_total']} expired, {s['leftover']} left over")
    require(s["faults_injected"] >= 1 and s["shard_recoveries"] >= 1,
            f"the crash plan injected {s['faults_injected']} faults and "
            f"{s['shard_recoveries']} recoveries in this window")
    import torch
    copies = len({id(ex.params) for ex in executors.values()})
    require(copies == min(CLUSTER["shards"], torch.cuda.device_count()),
            f"{copies} copies of the weights for {len(executors)} shards")
    for name, ex in executors.items():
        say(f"  {name} on {ex.device}: kernel launches {ex.launches}, "
            f"finished {len(ex.done)} requests")
        for kernel in ("flash_attention", "flash_decode"):
            require(ex.launches[kernel] >= 1,
                    f"{name} launched {kernel} {ex.launches[kernel]} times")
    # the executor that finished a request holds its highest attempt
    finished = {}
    for name, ex in executors.items():
        for rid, attempt in ex.done.items():
            if rid not in finished or attempt > finished[rid][0]:
                finished[rid] = (attempt, name)
    require(len(finished) == s["completed"],
            f"{len(finished)} requests finished on executors, "
            f"{s['completed']} completed")
    # the checked requests: those finished on other attempts first, then
    # one a shard in turn
    order = sorted(finished, key=lambda r: (-finished[r][0], r))
    by_shard = {}
    for rid in order:
        by_shard.setdefault(finished[rid][1], []).append(rid)
    picks = []
    while len(picks) < min(CLUSTER_TOKEN_CHECKS, len(order)):
        for rids in by_shard.values():
            if rids and len(picks) < CLUSTER_TOKEN_CHECKS:
                picks.append(rids.pop(0))
    for rid in picks:
        attempt, name = finished[rid]
        ex = executors[name]
        got = ex.generated(rid)
        want = greedy_tokens(ex, ex.prompts[rid], CLUSTER["max_new"])
        say(f"  request {rid} (attempt {attempt}, finished on {name}): "
            f"tokens {got} equal a fresh run: {got == want}")
        require(got == want, f"request {rid}: served {got}, fresh {want}")

    wm, _ = serve.main(serve_argv("engine", WORKLOAD))
    ws = wm.summary()
    say(f"  workload {WORKLOAD['workload']!r} (engine): "
        f"{wm.completed}/{WORKLOAD['requests']} completed, ttft p50/p99 "
        f"{ws['ttft_p50_ms']:.3f}/{ws['ttft_p99_ms']:.3f} ms, itl p50/p99 "
        f"{ws['itl_p50_ms']:.3f}/{ws['itl_p99_ms']:.3f} ms")
    require(wm.completed == WORKLOAD["requests"],
            f"workload: {wm.completed}/{WORKLOAD['requests']} completed")
    return launches, s, time.perf_counter() - t0


def lint_phase():
    """``repro_torch.analysis.lint``'s ``run_lint`` on the card, held to
    the committed baseline. Returns the run's launches and wall seconds."""
    from repro_torch.analysis import lint
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = lint.run_lint(device="cuda")
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    print(lint.render(result), flush=True)
    untagged = [f"{f['workload']}/{f['entrypoint']}"
                for f in result["findings"]
                if f["kind"] == "untagged-heavy-entrypoint"]
    say(f"  lint wall {wall:.1f}s, launches {launches}; "
        f"n_untagged {result['n_untagged']}: {untagged}")
    for name in KERNELS:
        require(launches[name] >= 1,
                f"{name} launched {launches[name]} times in the lint")
    committed = json.loads(lint.BASELINE_PATH.read_text())
    same = json.loads(json.dumps(result)) == committed
    say(f"  the findings equal the committed {lint.BASELINE_PATH.name}: "
        f"{same}")
    require(same, f"lint findings differ from {lint.BASELINE_PATH.name}")
    return launches, wall


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
        say(f"  chacha20 SASS (one block a thread, fully unrolled): "
            f"{chacha20_sass()}")
        kernel_build_report()

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

        say("phase 6 calibration on the card "
            "(repro_torch.analysis.calibrate):")
        calib_launches = calibration_phase()
        say("phase 6 calibration: all kernels launched and tagged")

        say("phase 7 cluster serving under the crash fault plan:")
        cluster_launches, cs, cluster_s = cluster_phase()
        say(f"phase 7 cluster: {cs['completed']}/{CLUSTER['requests']} "
            f"requests, ttft p50/p99 {cs['ttft_p50_ms']:.3f}/"
            f"{cs['ttft_p99_ms']:.3f} ms, itl p50/p99 "
            f"{cs['itl_p50_ms']:.3f}/{cs['itl_p99_ms']:.3f} ms, "
            f"{cluster_s:.1f}s wall")

        say("phase 8 the intermittency lint on the card "
            "(repro_torch.analysis.lint):")
        lint_launches, lint_s = lint_phase()
        say(f"phase 8 lint: all kernels launched, baseline equal, "
            f"{lint_s:.1f}s wall")
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1

    line = []
    for name, meta in KERNELS.items():
        main_case = next(r for r in results[name]
                         if r["dtype"] in ("bfloat16", "uint32")
                         and "ms" in r)
        # each kernel's launches on its own path: serving for attention,
        # calibration for chacha20 (serving never runs it)
        path_launches = calib_launches if name == "chacha20" else launches
        line.append({
            "name": name, "route": "cuda", **meta,
            "launches": path_launches[name],
            "launches_by_path": {"serve": launches[name],
                                 "calibrate": calib_launches[name],
                                 "cluster": cluster_launches[name],
                                 "lint": lint_launches[name]},
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
