"""Where the bf16 ``flash_attention`` kernel's time goes, on the card.

Builds copies of ``csrc/flash_attention.cu`` with one part taken out each
(the tensor-core products, the exponentials, the K/V copies inside the KV
loop, all three, every KV tile but the first, the pairing of two GQA heads
a block) or the K/V ring resized, and times each beside the kernel as it
is, at the serving and GQA shapes that ``chip_smoke.py`` times, device-only
(50 calls queued behind a spin kernel). The copies compute wrong results:
only their times mean anything. The parts are found by their source text;
a copy whose text is gone fails loudly, so keep the markers below in step
with the kernel. Needs a GPU and ``nvcc``; from the repository root:

    PYTHONPATH=src python -m repro_torch.kernels.ablate

prints one line a shape, the card's name and power limit first. With
``--against SRC`` it builds another copy of the kernel's source instead
(another commit's ``flash_attention.cu``, with the headers beside it) and
times it beside this one in turns (this, other, other, this, ...) at the
bf16 shapes of ``AGAINST_SHAPES``, so that two versions are compared on
one card in one process:

    PYTHONPATH=src python -m repro_torch.kernels.ablate --against \
        parent/src/repro_torch/csrc/flash_attention.cu
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import time
from pathlib import Path

from repro_torch.kernels import build

S_PRODUCT = """      wgmma_ss_n64(s, desc(q_s + kk * 256, 128, 16 * DQK),
                   desc(k_s + kk * 256, 128, 16 * DQK), kk > 0);"""
PV_PRODUCT = ("      wgmma_pv<DV>(o_acc, a[kk], "
              "desc(v_s + kk * 32 * DV, 16 * DV, 128));")
EXP = "      s[i] = exp2f(s[i] - m[r]);"
LOOP_COPIES = "    if (ahead < n_kv) {"
N_KV = "  const int n_kv = (kv_end + BK - 1) / BK;"
PAIR = "    return (H / KVH) % 2 == 0"
STAGES = ("  static constexpr int STAGES = DQK <= 64 ? 4 : DQK <= 128 ? 3 "
          ": 2;")

NO_PRODUCTS = [(S_PRODUCT, "      {}"), (PV_PRODUCT, "      {}")]
NO_EXP = [(EXP, "      s[i] = s[i] - m[r];")]
NO_LOOP_COPIES = [(LOOP_COPIES, "    if (false) {")]
VARIANTS = {
    "as is": [],
    "no products": NO_PRODUCTS,
    "no exp2": NO_EXP,
    "no copies in the loop": NO_LOOP_COPIES,
    "none of the three": NO_PRODUCTS + NO_EXP + NO_LOOP_COPIES,
    "first KV tile only": [(N_KV, "  const int n_kv = 1;")],
    "one head a block": [(PAIR, "    return false")],
    "2 stages": [(STAGES, "  static constexpr int STAGES = 2;")],
    "8 stages at D <= 64": [(STAGES, "  static constexpr int STAGES = "
                                     "DQK <= 64 ? 8 : DQK <= 128 ? 3 : 2;")],
}
# (B, H, KVH, S, D), causal, q/k/v as transpose views of [B, S, heads, D]
SHAPES = [(1, 16, 16, 512, 64), (4, 48, 4, 500, 128)]
# --against: the serve and GQA shapes and zamba2-2.7b's and stablelm-12b's
# prefill (head dims 80 and 160)
AGAINST_SHAPES = SHAPES + [(1, 32, 32, 512, 80), (1, 32, 8, 512, 160)]
AGAINST_ROUNDS = 6           # timed calls of each version a shape


def variant_source(edits) -> str:
    """The kernel's source with each (text, replacement) applied."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"ablate: marker not in flash_attention.cu: "
                               f"{old.strip()[:60]}")
        src = src.replace(old, new)
    return src


def build_variants(sources: dict) -> dict:
    """Compile each ``name -> (source text, header directory)`` of
    ``sources``, all at once; returns name -> loaded library."""
    out = build.BUILD_DIR / "ablate"
    procs = {}
    for i, (name, (text, headers)) in enumerate(sources.items()):
        # each variant in a directory of its own, beside its own headers
        d = out / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for header in Path(headers).glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        cu = d / "fa.cu"
        cu.write_text(text)
        so = d / "libfa.so"
        flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        procs[name] = (so, subprocess.Popen(
            [build.nvcc(), *flags, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate: nvcc failed for {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def device_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Median device time of one call: ``iters`` calls queued between one
    CUDA-event pair behind a spin kernel that outlasts the host's
    queueing."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2.0e9 * (3 * host_s + 2e-4)))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / iters


def caller(lib, text: str):
    """``fn(q, k, v, o, B, H, KVH, S, D, st, stream)``: a causal bf16 call
    of ``lib``'s ``flash_attention_fwd``, whose C signature is read from
    its source ``text``: one sequence length, or ``Sq`` and ``Skv``; and
    a score scale (0: 1/sqrt(D)) where the source takes one."""
    two = "int Sq, int Skv, int DQK" in text
    scaled = "double scale, void* stream" in text
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (8 if two else 7) \
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int] \
        + [ctypes.c_double] * scaled + [ctypes.c_void_p]
    code = build.DTYPE_CODES["bfloat16"]

    def call(q, k, v, o, B, H, KVH, S, D, st, stream):
        lengths = (S, S) if two else (S,)
        return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  code, B, H, KVH, *lengths, D, D, st, 1,
                  *([0.0] if scaled else []), stream)
    return call


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", default=None, metavar="SRC",
                    help="another flash_attention.cu to time beside this "
                         "one, in turns, instead of the ablations")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    mine = (build.CSRC / "flash_attention.cu").read_text()
    if args.against:
        other = Path(args.against)
        sources = {"this": (mine, build.CSRC),
                   "other": (other.read_text(), other.parent)}
        shapes = AGAINST_SHAPES
    else:
        sources = {name: (variant_source(edits), build.CSRC)
                   for name, edits in VARIANTS.items()}
        shapes = SHAPES
    libs = build_variants(sources)
    calls = {name: caller(libs[name], text)
             for name, (text, _) in sources.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for B, H, KVH, S, D in shapes:
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2)
                   for h in (H, KVH, KVH))
        o = torch.empty_like(q)
        st = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3], *o.stride()[:3])

        def time_one(name):
            return device_ms(lambda: calls[name](q, k, v, o, B, H, KVH, S,
                                                 D, st, stream))

        label = f"B{B} H{H} KVH{KVH} S{S} D{D} causal bf16"
        if not args.against:
            print(f"{label}: " + "; ".join(
                f"{name} {time_one(name) * 1e3:.1f} us" for name in calls),
                flush=True)
            continue
        times = {"this": [], "other": []}
        for r in range(AGAINST_ROUNDS):
            for name in (("this", "other") if r % 2 == 0
                         else ("other", "this")):
                times[name].append(time_one(name) * 1e3)
        print(f"{label}: " + "; ".join(
            f"{name} median {statistics.median(t):.2f} us "
            f"({', '.join(f'{x:.2f}' for x in t)})"
            for name, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
