"""The port's copies of the framework-free scheduler and OS simulator
(``repro_torch.sched`` and ``repro_torch.core``) stay the reference's: each
copy's text is the reference module's with ``repro.`` read as
``repro_torch.``, and the modelled runs (no real model) give summaries,
fault counts and oracle verdicts equal to the reference's."""
import re
from pathlib import Path

import pytest

import repro.core.experiments as jexp
import repro.sched.faults as jfaults
import repro.sched.replay as jreplay
import repro.sched.sweep as jsweep
import repro.sched.workload as jwork
import repro_torch.core.experiments as texp
import repro_torch.sched.faults as tfaults
import repro_torch.sched.replay as treplay
import repro_torch.sched.sweep as tsweep
import repro_torch.sched.workload as twork

SRC = Path(__file__).resolve().parents[1] / "src"
COPIES = [
    "sched/workload.py", "sched/cluster.py", "sched/faults.py",
    "sched/replay.py", "sched/sweep.py", "sched/engine.py",
    "sched/freq.py", "sched/policy.py", "sched/topology.py",
    "core/task.py", "core/runqueue.py", "core/license.py",
    "core/muqss.py", "core/simulator.py", "core/workloads.py",
    "core/perfcounters.py", "core/experiments.py", "core/adaptive.py",
]
# lines a copy must word differently, as (reference line, port line)
DIFFERS = {
    "sched/workload.py": [
        ("# (`python -m repro_torch.analysis.calibrate --update` -> "
         "analysis/derived.json).",
         "# (`python -m repro.analysis.calibrate --update` -> "
         "analysis/derived.json, copied).")],
}
# the reference's notes on which of its pull requests added a thing read
# "original" in the copies
HISTORY = re.compile(r"\bPR \d+\b")
FAULT_PLANS = ["none", "crash", "brownout", "straggler", "flaky", "storm"]
HORIZON_MS = 30_000.0


@pytest.mark.parametrize("module", COPIES)
def test_copy_is_the_reference_with_imports_repointed(module):
    want = HISTORY.sub("original", (SRC / "repro" / module).read_text()
                       .replace("repro.", "repro_torch."))
    for ref_line, port_line in DIFFERS.get(module, []):
        assert ref_line in want, f"{module}: {ref_line!r} is gone"
        want = want.replace(ref_line, port_line)
    got = (SRC / "repro_torch" / module).read_text()
    assert got == want


def test_every_registry_matches_the_reference():
    assert sorted(twork.SCENARIOS) == sorted(jwork.SCENARIOS)
    assert sorted(twork.CLUSTER_SCENARIOS) == sorted(jwork.CLUSTER_SCENARIOS)
    assert sorted(tfaults.FAULT_PLANS) == sorted(jfaults.FAULT_PLANS)
    assert sorted(tsweep.PRESETS) == sorted(jsweep.PRESETS)
    for name in jfaults.FAULT_PLANS:
        assert tfaults.resolve_fault_plan(name).plan_hash == \
            jfaults.resolve_fault_plan(name).plan_hash


@pytest.mark.parametrize("scenario", ["steady", "multi_tenant", "zoo/qwen1.5-0.5b"])
@pytest.mark.parametrize("policy", ["specialized", "shared"])
def test_engine_replay_equals_the_reference(scenario, policy):
    want = jreplay.replay_engine(
        jwork.scenario_trace(scenario, duration_ms=HORIZON_MS), policy)
    got = treplay.replay_engine(
        twork.scenario_trace(scenario, duration_ms=HORIZON_MS), policy)
    assert want["n_violations"] == 0
    assert got == want


@pytest.mark.parametrize("plan", FAULT_PLANS)
def test_cluster_replay_under_faults_equals_the_reference(plan):
    want = jreplay.replay_cluster(
        jwork.scenario_trace("fleet_steady", duration_ms=HORIZON_MS),
        fault_plan=plan)
    got = treplay.replay_cluster(
        twork.scenario_trace("fleet_steady", duration_ms=HORIZON_MS),
        fault_plan=plan)
    assert want["n_violations"] == 0
    if plan != "none":
        assert sum(want["fault_counts"][k] for k in ("faults", "drops")) > 0
    assert got == want


@pytest.mark.parametrize("scenario", ["steady", "bursty", "diurnal",
                                      "heavy_tail", "multi_tenant",
                                      "fleet_mixed", "faults/crash"])
def test_traces_and_their_json_round_trips_equal_the_reference(scenario):
    want = jwork.scenario_trace(scenario, duration_ms=HORIZON_MS, seed=3)
    got = twork.scenario_trace(scenario, duration_ms=HORIZON_MS, seed=3)
    assert got.to_json() == want.to_json()
    assert twork.Trace.from_json(want.to_json()).to_json() == want.to_json()
    assert jwork.Trace.from_json(got.to_json()).to_json() == got.to_json()


def test_load_trace_reads_a_saved_trace(tmp_path):
    path = tmp_path / "trace.json"
    twork.scenario_trace("bursty", duration_ms=5_000.0).save(path)
    assert twork.load_trace(str(path)).to_json() == \
        jwork.load_trace(str(path)).to_json()
    assert [r.arrive_ms for r in twork.poisson_workload(4.0, 5_000.0)] == \
        [r.arrive_ms for r in jwork.poisson_workload(4.0, 5_000.0)]


@pytest.mark.parametrize("specialization", [True, False])
def test_trace_simulation_equals_the_reference(specialization):
    want = jexp.run_trace_sim(
        jwork.scenario_trace("steady", duration_ms=3_000.0), specialization)
    got = texp.run_trace_sim(
        twork.scenario_trace("steady", duration_ms=3_000.0), specialization)
    assert want["completed"] > 0
    assert got == want


def test_faults_smoke_sweep_and_its_resilience_check_equal_the_reference():
    want = jsweep.run_sweep(jsweep.preset_spec("faults-smoke"))
    got = tsweep.run_sweep(tsweep.preset_spec("faults-smoke"))
    assert jfaults.check_resilience(want) == []
    assert tfaults.check_resilience(got) == []
    assert tsweep.sweep_json(got, meta=False) == \
        jsweep.sweep_json(want, meta=False)
