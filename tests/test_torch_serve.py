"""The port's serve path on the CPU: the CLI completes in both modes, the
executor's tokens equal the reference model's greedy tokens on the same
prompts and bridged weights, and the port's copy of the engine gives the
reference engine's summary on the same requests."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.sched as jsched
from repro.sched.engine import Engine as JEngine
from repro.sched.engine import PoolModel as JPoolModel
from repro.sched.engine import Request as JRequest
import repro_torch.sched as tsched
from repro_torch.launch import serve
from repro_torch.sched.engine import Engine as TEngine
from repro_torch.sched.engine import PoolModel as TPoolModel
from repro_torch.sched.engine import Request as TRequest
from test_torch_model import reference_and_port, reference_greedy

ROOT = Path(__file__).resolve().parents[1]
CLI = ["--device", "cpu", "--reduced", "--arch", "qwen1.5-0.5b",
       "--requests", "4", "--prompt", "16", "--max-new", "4", "--batch", "2"]


@pytest.mark.parametrize("mode", ["engine", "loop"])
def test_serve_cli_completes(mode):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *CLI,
         "--mode", mode], capture_output=True, text=True, env=env,
        timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[serve] 4/4 requests" in out.stdout
    assert "heavy tags (derived.json): ['prefill']" in out.stdout


def test_engine_tokens_match_reference_greedy():
    jmodel, jparams, tmodel, tparams = reference_and_port("qwen1.5-0.5b")
    args = serve.build_parser().parse_args(CLI)
    m, ex = serve.run_engine(args, tmodel.cfg, tmodel, tparams)
    assert m.completed == 4
    for rid in range(4):
        _, want = reference_greedy(jmodel, jparams,
                                   ex.prompts[rid][None, :], 3)
        assert ex.generated(rid) == want[0].tolist()


MOE_ARCHS = ["grok-1-314b", "deepseek-v3-671b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serve_cli_completes(arch):
    """``--arch <moe arch> --reduced --device cpu`` serves; the heavy tag
    comes from the copied ``derived.json``, which has both archs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    argv = [*CLI[:CLI.index("--arch")], "--arch", arch,
            *CLI[CLI.index("--arch") + 2:]]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[serve] 4/4 requests" in out.stdout
    assert "heavy tags (derived.json): ['prefill', 'decode_step']" \
        in out.stdout


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_tokens_match_reference_greedy(arch):
    jmodel, jparams, tmodel, tparams = reference_and_port(arch)
    argv = [*CLI[:CLI.index("--arch")], "--arch", arch,
            *CLI[CLI.index("--arch") + 2:]]
    args = serve.build_parser().parse_args(argv)
    m, ex = serve.run_engine(args, tmodel.cfg, tmodel, tparams)
    assert m.completed == 4
    for rid in range(4):
        _, want = reference_greedy(jmodel, jparams,
                                   ex.prompts[rid][None, :], 3)
        assert ex.generated(rid) == want[0].tolist()


@pytest.mark.parametrize("mode", ["engine", "loop"])
def test_hybrid_serve_cli_completes(mode):
    """``--arch zamba2-2.7b --reduced --device cpu`` serves in both modes;
    the heavy tag comes from the copied ``derived.json``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    argv = [*CLI[:CLI.index("--arch")], "--arch", "zamba2-2.7b",
            *CLI[CLI.index("--arch") + 2:], "--mode", mode]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[serve] 4/4 requests" in out.stdout
    assert "heavy tags (derived.json): ['prefill']" in out.stdout


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "stablelm-12b"])
def test_engine_tokens_match_reference_greedy_new_archs(arch):
    """The engine's greedy tokens for the hybrid and for stablelm-12b
    (LayerNorm, GQA 32/8) equal the reference model's on the executor's
    prompts and bridged weights."""
    jmodel, jparams, tmodel, tparams = reference_and_port(arch)
    argv = [*CLI[:CLI.index("--arch")], "--arch", arch,
            *CLI[CLI.index("--arch") + 2:]]
    args = serve.build_parser().parse_args(argv)
    m, ex = serve.run_engine(args, tmodel.cfg, tmodel, tparams)
    assert m.completed == 4
    for rid in range(4):
        _, want = reference_greedy(jmodel, jparams,
                                   ex.prompts[rid][None, :], 3)
        assert ex.generated(rid) == want[0].tolist()


def test_loop_tokens_match_reference_greedy():
    jmodel, jparams, tmodel, tparams = reference_and_port("qwen1.5-0.5b",
                                                          kv_heads=2)
    args = serve.build_parser().parse_args([*CLI, "--mode", "loop"])
    batches = serve.run_loop(args, tmodel.cfg, tmodel, tparams)
    assert len(batches) == 2
    for prompts, toks in batches:
        _, want = reference_greedy(jmodel, jparams, prompts, 3)
        np.testing.assert_array_equal(toks, want)


def test_heavy_tags_and_freq_levels_come_from_the_artifact():
    from repro_torch.configs import get_arch
    cfg = get_arch("qwen1.5-0.5b").reduced()
    assert serve.heavy_tags("qwen1.5-0.5b", cfg, 16, 20) == \
        (["prefill"], "derived.json")
    tags, src = serve.heavy_tags("no-such-arch", cfg, 16, 20)
    assert "prefill" in tags and src == "fresh tag_heavy"
    from repro.launch.serve import engine_freq_config as jfreq
    for arch in ("qwen1.5-0.5b", "deepseek-v3-671b", "no-such-arch"):
        assert serve.engine_freq_config(arch).freqs_ghz == \
            jfreq(arch).freqs_ghz


def _requests(cls, n=32, seed=3):
    rng = np.random.default_rng(seed)
    arrive = np.cumsum(rng.exponential(40.0, size=n))
    return [cls(rid=i, arrive_ms=float(arrive[i]),
                prompt_len=int(rng.integers(64, 2048)),
                max_new=int(rng.integers(4, 64))) for i in range(n)]


@pytest.mark.parametrize("policy", ["specialized", "shared", "adaptive"])
def test_copied_engine_summary_matches_reference(policy):
    def run(sched, engine_cls, pool_cls, req_cls):
        topo = sched.Topology.serving(n_devices=4, prefill_devices=1)
        eng = engine_cls(topo, sched.make_policy(policy), model=pool_cls())
        return eng.run(_requests(req_cls)).summary()

    want = run(jsched, JEngine, JPoolModel, JRequest)
    got = run(tsched, TEngine, TPoolModel, TRequest)
    assert want["completed"] == 32
    assert got == want


def _argv(arch):
    return [*CLI[:CLI.index("--arch")], "--arch", arch,
            *CLI[CLI.index("--arch") + 2:]]


@pytest.mark.parametrize("mode", ["engine", "loop", "cluster"])
def test_rwkv6_serve_cli_completes(mode):
    """``--arch rwkv6-3b --reduced --device cpu`` serves in every mode,
    through the Model API alone (the executor stores the states each call
    returns); the heavy tag comes from the copied ``derived.json``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve",
         *_argv("rwkv6-3b"), "--mode", mode],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[serve] 4/4 requests" in out.stdout
    assert "heavy tags (derived.json): ['prefill']" in out.stdout


def test_rwkv6_engine_tokens_match_reference_greedy():
    """The engine's greedy tokens for RWKV6 equal the reference model's
    (prefill, then decode steps carrying the states) on the executor's
    prompts and bridged weights."""
    jmodel, jparams, tmodel, tparams = reference_and_port("rwkv6-3b")
    args = serve.build_parser().parse_args(_argv("rwkv6-3b"))
    m, ex = serve.run_engine(args, tmodel.cfg, tmodel, tparams)
    assert m.completed == 4
    for rid in range(4):
        _, want = reference_greedy(jmodel, jparams,
                                   ex.prompts[rid][None, :], 3)
        assert ex.generated(rid) == want[0].tolist()


def test_whisper_is_not_served_and_says_why():
    """The encoder-decoder's cache needs audio frames and the executor
    passes tokens only, as the reference's does: serving it raises an
    error that names the reason, before any model is built."""
    with pytest.raises(ValueError, match=r"whisper-large-v3 .*frames"):
        serve.main(_argv("whisper-large-v3"))
