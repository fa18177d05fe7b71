"""The port's cluster tier with a real model on the CPU: ``--mode cluster``
(shards behind the router, fault plans, the cluster oracle) and
``--workload`` complete with exact conservation, and every completed
request's greedy tokens, read from the executor that finished it, equal
the reference model's greedy tokens for the prompt that executor
recorded. Also the heavy-tag fallback for an arch ``derived.json`` lacks,
and what a retried request meets on an executor that still holds its
earlier attempt."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import serve
from repro_torch.sched.engine import Request
from test_torch_model import reference_and_port, reference_greedy

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--reduced", "--arch", "qwen1.5-0.5b",
         "--prompt", "16", "--max-new", "4", "--batch", "2"]
# 24 arrivals 2.5 s of engine time apart: a 57.5 s window in which the
# seeded `crash` plan fails and recovers shards
CRASH = [*SMALL, "--mode", "cluster", "--shards", "2", "--requests", "24",
         "--rate", "0.4", "--fault-plan", "crash"]
# 120 arrivals at 4/s under `storm`: the plan drops responses, so requests
# are retried and finish on a later attempt
STORM = [*SMALL, "--mode", "cluster", "--shards", "2", "--requests", "120",
         "--rate", "4", "--fault-plan", "storm"]


@pytest.fixture(scope="module")
def models():
    return reference_and_port("qwen1.5-0.5b")


class FixedClock:
    """A stand-in for the ``time`` module that ``serve`` reads, whose
    ``perf_counter`` advances ``step_ms`` at every reading. The executor
    reads it on each side of a model call, so every prefill and decode
    call is charged ``step_ms`` of engine time, however busy the host is:
    which storm events meet which attempt, and whether a dropped request
    is retried or expires, no longer depend on the host's load."""

    def __init__(self, step_ms: float):
        self.now, self.step = 0.0, step_ms / 1e3

    def perf_counter(self) -> float:
        self.now += self.step
        return self.now


@pytest.fixture
def fixed_clock(monkeypatch):
    """Engine service times from a 5 ms fixed clock, for this test only."""
    monkeypatch.setattr(serve, "time", FixedClock(5.0))


def finishing_executor(executors, rid):
    """The executor whose attempt of ``rid`` completed: the highest
    attempt any executor finished (an earlier one was dropped or lost)."""
    done = [(ex.done[rid], name) for name, ex in executors.items()
            if rid in ex.done]
    return executors[max(done)[1]]


def assert_tokens_match_reference(jmodel, jparams, executors, rids,
                                  max_new):
    exs = [finishing_executor(executors, rid) for rid in rids]
    prompts = np.stack([ex.prompts[rid] for ex, rid in zip(exs, rids)])
    _, want = reference_greedy(jmodel, jparams, prompts, max_new - 1)
    got = [ex.generated(rid) for ex, rid in zip(exs, rids)]
    assert got == want.tolist()


def completed_rids(executors):
    return sorted({rid for ex in executors.values() for rid in ex.done})


def test_cluster_cli_completes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *SMALL,
         "--mode", "cluster", "--shards", "2", "--requests", "6"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[serve] 6/6 requests" in out.stdout
    assert "[serve] shard0: 2 pools units, device cpu" in out.stdout
    assert "[serve] oracle violations=0" in out.stdout


def test_cluster_under_crash_conserves_and_matches_reference(models,
                                                           fixed_clock):
    jmodel, jparams, tmodel, tparams = models
    args = serve.build_parser().parse_args(CRASH)
    m, executors, oracle = serve.run_cluster(args, tmodel.cfg, tmodel,
                                             tparams)
    s = m.summary()
    assert oracle.n_violations == 0, oracle.violations[:5]
    assert s["injected"] == 24
    assert s["injected"] == s["completed"] + s["shed_total"] \
        + s["expired_total"] + s["leftover"]
    assert s["leftover"] == 0
    assert s["faults_injected"] >= 1 and s["shard_recoveries"] >= 1
    assert len(executors) == 2
    assert all(ex.model is tmodel for ex in executors.values())
    rids = completed_rids(executors)
    assert len(rids) == s["completed"]
    assert_tokens_match_reference(jmodel, jparams, executors, rids, 4)
    assert all(not ex.state and not ex.live for ex in executors.values())


def test_cluster_under_storm_retries_and_matches_reference(models,
                                                           fixed_clock):
    """Requests retried after a dropped response finish on a later
    attempt; their tokens are read from the executor that finished that
    attempt, and no executor keeps an earlier attempt's state."""
    jmodel, jparams, tmodel, tparams = models
    args = serve.build_parser().parse_args(STORM)
    m, executors, oracle = serve.run_cluster(args, tmodel.cfg, tmodel,
                                             tparams)
    s = m.summary()
    assert oracle.n_violations == 0, oracle.violations[:5]
    assert s["retries"] >= 1 and s["dropped"] >= 1
    assert s["injected"] == 120 == s["completed"] + s["shed_total"] \
        + s["expired_total"]
    assert s["leftover"] == 0
    rids = completed_rids(executors)
    assert len(rids) == s["completed"]
    retried = [rid for rid in rids
               if finishing_executor(executors, rid).done[rid] >= 1]
    assert retried
    assert_tokens_match_reference(jmodel, jparams, executors, rids, 4)
    assert all(not ex.state and not ex.live for ex in executors.values())


def test_a_later_attempt_frees_the_earlier_one_on_its_peers(models):
    """An attempt started on one shard drops the earlier attempt's cache
    that another shard of the cluster still holds."""
    _, _, tmodel, tparams = models
    P, N = 16, 4
    peers = []
    a, b = (serve.RealModelExecutor(tmodel, tparams, tmodel.cfg.vocab, P,
                                    P + N, peers=peers) for _ in range(2))
    assert peers == [a, b]
    req = Request(rid=3, arrive_ms=0.0, prompt_len=P, max_new=N)
    a.prefill(req, P, "prefill", 1)
    assert 3 in a.state
    req.attempts, req.prefilled, req.generated = 1, 0, 0
    b.prefill(req, P, "prefill", 1)
    assert 3 not in a.state and 3 not in a.live
    assert b.attempt[3] == 1 and b.live[3] is req
    req.attempts = 2                      # shed at the attempt cap
    b.prune()
    assert not b.state and not b.live


def test_hybrid_cluster_under_crash_conserves_and_matches_reference(
        fixed_clock):
    """zamba2's reduced config through the cluster under the crash plan:
    exact conservation, no oracle violation, every completed request's
    tokens equal the reference's, and no executor keeps a state tree
    (Mamba2 states and shared-block KV caches) after the run."""
    jmodel, jparams, tmodel, tparams = reference_and_port("zamba2-2.7b")
    argv = [*CRASH[:CRASH.index("--arch")], "--arch", "zamba2-2.7b",
            *CRASH[CRASH.index("--arch") + 2:]]
    args = serve.build_parser().parse_args(argv)
    m, executors, oracle = serve.run_cluster(args, tmodel.cfg, tmodel,
                                             tparams)
    s = m.summary()
    assert oracle.n_violations == 0, oracle.violations[:5]
    assert s["injected"] == 24 == s["completed"] + s["shed_total"] \
        + s["expired_total"]
    assert s["leftover"] == 0
    assert s["faults_injected"] >= 1 and s["shard_recoveries"] >= 1
    rids = completed_rids(executors)
    assert len(rids) == s["completed"]
    assert_tokens_match_reference(jmodel, jparams, executors, rids, 4)
    assert all(not ex.state and not ex.live for ex in executors.values())


def test_a_later_attempt_frees_a_hybrid_state_on_its_peers():
    """The drop of an earlier attempt works on the hybrid's
    ``{"mamba", "kv"}`` state tree as on a ``{"k", "v"}`` cache."""
    _, _, tmodel, tparams = reference_and_port("zamba2-2.7b")
    P, N = 16, 4
    peers = []
    a, b = (serve.RealModelExecutor(tmodel, tparams, tmodel.cfg.vocab, P,
                                    P + N, peers=peers) for _ in range(2))
    req = Request(rid=5, arrive_ms=0.0, prompt_len=P, max_new=N)
    a.prefill(req, P, "prefill", 1)
    cache = a.state[5][0]
    assert set(cache) == {"mamba", "kv"}
    req.attempts, req.prefilled, req.generated = 1, 0, 0
    b.prefill(req, P, "prefill", 1)
    assert 5 not in a.state and 5 not in a.live
    assert set(b.state[5][0]) == {"mamba", "kv"}


def test_workload_in_engine_mode_matches_reference(models):
    jmodel, jparams, tmodel, tparams = models
    args = serve.build_parser().parse_args(
        [*SMALL, "--requests", "8", "--workload", "multi_tenant"])
    m, ex = serve.run_engine(args, tmodel.cfg, tmodel, tparams)
    assert m.completed == 8
    rids = sorted(ex.done)
    assert len(rids) == 8
    assert_tokens_match_reference(jmodel, jparams, {"engine": ex}, rids, 4)


def test_workload_in_cluster_mode_conserves(models, fixed_clock):
    _, _, tmodel, tparams = models
    args = serve.build_parser().parse_args(
        [*SMALL, "--mode", "cluster", "--requests", "8",
         "--workload", "multi_tenant", "--fault-plan", "flaky"])
    m, executors, oracle = serve.run_cluster(args, tmodel.cfg, tmodel,
                                             tparams)
    s = m.summary()
    assert oracle.n_violations == 0
    assert s["injected"] == 8 == s["completed"] + s["shed_total"] \
        + s["expired_total"]


def test_workload_clamps_tokens_to_the_served_shape():
    args = serve.build_parser().parse_args(
        [*SMALL, "--requests", "5", "--workload", "heavy_tail"])
    reqs = serve.requests(args)
    assert len(reqs) == 5
    assert {(r.prompt_len, r.max_new) for r in reqs} == {(16, 4)}
    assert [r.arrive_ms for r in reqs] == sorted(r.arrive_ms for r in reqs)


def test_shard_devices():
    assert serve.shard_devices(3, "cpu") == [torch.device("cpu")] * 3
    assert serve.shard_devices(2, "cuda:1") == [torch.device("cuda", 1)] * 2


def test_shards_round_robin_over_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert serve.shard_devices(3, "cuda") == [
        torch.device("cuda", 0), torch.device("cuda", 1),
        torch.device("cuda", 0)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert serve.shard_devices(2, "cuda") == [torch.device("cuda", 0)] * 2


def test_heavy_tags_fall_back_to_a_fresh_tag_heavy_like_the_reference(
        models, monkeypatch):
    jmodel, jparams, tmodel, _ = models
    from repro.analysis import derived as jderived
    from repro.launch import serve as jserve
    from repro_torch.analysis import derived as tderived
    monkeypatch.setattr(jderived, "workloads", lambda: {})
    monkeypatch.setattr(tderived, "workloads", lambda: {})
    _, want, wsrc = jserve.identify_heavy_phase(
        jmodel, jparams, 2, 16, 20, "qwen1.5-0.5b")
    got, src = serve.heavy_tags("qwen1.5-0.5b", tmodel.cfg, 16, 20, 2)
    assert wsrc == "fresh tag_heavy"
    assert (got, src) == (want, wsrc)


def test_cluster_crash_runs_never_reuse_an_earlier_attempt(models,
                                                           monkeypatch):
    """Both packages, the same seed and fault plan: no retried request
    comes back to an executor that still holds its earlier attempt."""
    from repro.launch import serve as jserve
    hits = []
    orig = jserve.RealModelExecutor.prefill

    def prefill(self, req, chunk, pool, ndev):
        seen = self.__dict__.setdefault("_attempt", {})
        if req.rid in self.state and seen.get(req.rid) != req.attempts:
            hits.append((req.rid, seen.get(req.rid), req.attempts))
        if req.rid not in self.state:
            seen[req.rid] = req.attempts
        return orig(self, req, chunk, pool, ndev)

    monkeypatch.setattr(jserve.RealModelExecutor, "prefill", prefill)
    argv = [a for a in CRASH if a not in ("--device", "cpu", "--reduced")]
    jserve.main(argv)
    assert hits == []
    _, _, tmodel, tparams = models
    args = serve.build_parser().parse_args(CRASH)
    _, executors, _ = serve.run_cluster(args, tmodel.cfg, tmodel, tparams)
    assert all(ex.attempt[rid] == 0 for ex in executors.values()
               for rid in ex.attempt)


def test_a_new_attempt_is_prefilled_anew(models):
    """A request retried onto an executor that holds its earlier attempt:
    the reference decodes on from the old cache (its prefill returns 0.0),
    the port discards that state, prefills a fresh prompt and never
    writes past its cache."""
    jmodel, jparams, tmodel, tparams = models
    from repro.launch import serve as jserve
    P, N = 16, 4
    tex = serve.RealModelExecutor(tmodel, tparams, tmodel.cfg.vocab, P,
                                  P + N)
    jex = jserve.RealModelExecutor(jmodel, jparams, jmodel.cfg.vocab, P,
                                   P + N)
    for ex in (tex, jex):
        req = Request(rid=7, arrive_ms=0.0, prompt_len=P, max_new=N)
        assert ex.prefill(req, P, "prefill", 1) > 0.0
        req.generated = 1                 # prefill gives the first token
        for _ in range(N - 2):
            ex.decode([req], "decode", 1)
            req.generated += 1
        req.attempts, req.prefilled, req.generated = 1, 0, 0
        redo = ex.prefill(req, P, "prefill", 1)
        if ex is jex:
            assert redo == 0.0
            assert int(ex.state[7][2][0]) == P + N - 2
            continue
        assert redo > 0.0
        assert int(ex.state[7][2][0]) == P
        req.generated = 1
        for _ in range(N - 1):
            ex.decode([req], "decode", 1)
            req.generated += 1
        assert ex.done[7] == 1 and 7 not in ex.state
        _, want = reference_greedy(jmodel, jparams, ex.prompts[7][None],
                                   N - 1)
        assert ex.generated(7) == want[0].tolist()
