"""The port stands alone: importing every module of ``repro_torch`` (and
``chip_smoke`` as a module) loads neither JAX nor any module of the JAX
package, no source file of the port imports them, and nothing of it
carries on on the CPU when the GPU it defaults to is missing."""
import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|from\s+repro\.|"
                       r"import\s+repro\.|from\s+repro\s+import|"
                       r"import\s+repro\s*$)", re.M)

PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for n in names:
    importlib.import_module(n)
sys.path.insert(0, {root!r})
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(json.dumps({{"modules": names, "bad": bad}}))
"""


def _port_modules() -> list:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert set(res["modules"]) == set(_port_modules())
    assert "repro_torch.launch.serve" in res["modules"]
    assert {f"repro_torch.{m}" for m in (
        "sched.workload", "sched.cluster", "sched.faults", "sched.replay",
        "sched.sweep", "core.task", "core.runqueue", "core.license",
        "core.muqss", "core.simulator", "core.workloads",
        "core.perfcounters", "core.experiments", "core.static_analysis",
        "analysis.lint", "examples.identify_hot_code", "models.mamba2",
        "models.hybrid", "models.rwkv6", "models.encdec",
        "kernels.attention_grad", "data.pipeline", "train.optimizer",
        "train.loop", "train.checkpoint", "train.elastic", "launch.train",
        "examples.quickstart", "dist", "dist.context", "dist.sharding",
        "dist.collectives", "dist.pipeline", "launch.mesh")} <= \
        set(res["modules"])


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_reference(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_derived_artifact_is_the_reference_copy():
    ref = ROOT / "src" / "repro" / "analysis" / "derived.json"
    assert (PORT / "analysis" / "derived.json").read_bytes() == \
        ref.read_bytes()


def test_every_arch_resolves_and_reduces_like_the_reference():
    from repro.configs import arch_ids as jarch_ids, get_arch as jget_arch
    from repro_torch.configs import arch_ids, get_arch
    assert arch_ids() == jarch_ids()
    for a in arch_ids():
        assert repr(get_arch(a)) == repr(jget_arch(a))
        assert repr(get_arch(a).reduced()) == repr(jget_arch(a).reduced())


def test_serve_without_gpu_raises_instead_of_using_the_cpu():
    import torch
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1"])


@pytest.mark.parametrize("module,argv", [
    ("repro_torch.launch.serve", ["--reduced", "--mode", "cluster",
                                  "--requests", "1"]),
    ("repro_torch.analysis.lint", []),
    ("repro_torch.examples.identify_hot_code", []),
    ("repro_torch.launch.train", ["--reduced", "--steps", "1"]),
    ("repro_torch.examples.quickstart", []),
], ids=["serve-cluster", "lint", "identify_hot_code", "train", "quickstart"])
def test_entry_point_without_gpu_raises(module, argv):
    import importlib

    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(module).main(argv)


def test_chip_smoke_fails_without_the_repository(tmp_path):
    """Alone in a directory, the script exits non-zero and prints no
    result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_a_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
