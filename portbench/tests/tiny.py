"""A copy of the benchmark at CPU size, for the tests: ``BENCHMARK.json``
and ``portbench/`` (without the tests) copied under a temporary root,
each configuration's model cut to the port's reduced widths, each mix to
short prompts and outputs. The harness then runs its cells on the CPU
with the kernels' plain versions."""
from __future__ import annotations

import dataclasses
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# few threads: the CPU is shared, and its reduced models are small
torch.set_num_threads(2)


def reduced_model(name: str, dtype: str = "float32") -> dict:
    """The port's CPU-sized configuration of ``name`` as a model dict."""
    from repro_torch.configs import get_arch
    m = dataclasses.asdict(get_arch(name).reduced())
    m.update(param_dtype=dtype, compute_dtype=dtype)
    for k in ("moe", "mla", "rwkv", "enc_dec", "notes", "attn_chunk_q",
              "attn_chunk_kv"):
        m.pop(k, None)
    for k in ("ssm", "hybrid"):
        if m.get(k) is None:
            m.pop(k, None)
    return m


def make(tmp: Path, dtype: str = "float32", prompt: int = 24,
         out_lo: int = 4, out_hi: int = 9) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        f = root / c["file"]
        conf = json.loads(f.read_text())
        conf["model"] = reduced_model(conf["model"]["name"], dtype)
        f.write_text(json.dumps(conf))
    for w in bench["workloads"]:
        f = root / "portbench" / "workloads" / f"{w['name']}.json"
        mix = json.loads(f.read_text())
        mix["prompt"] = prompt
        mix["output"] = {"kind": "uniform", "lo": out_lo, "hi": out_hi}
        if mix.get("ramp_s"):
            mix["ramp_s"] = 0.5
        f.write_text(json.dumps(mix))
    return root


def edit_bench(root: Path, fn) -> None:
    f = Path(root) / "BENCHMARK.json"
    spec = json.loads(f.read_text())
    fn(spec)
    f.write_text(json.dumps(spec))
