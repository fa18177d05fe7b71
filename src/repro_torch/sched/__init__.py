"""Shared scheduling API of the port: Topology (mechanism-agnostic pool
layout), Policy (placement / stealing / preemption / resizing decisions),
the frequency domain, the event-driven serving engine, the scenario
workload subsystem, and the cluster tier (N engine shards behind a
frequency-aware router). Copies of the framework-free ``repro.sched``
modules, imports repointed: `core/muqss.py` (OS simulator) and
`sched/engine.py` (serving) both consume this API; `sched/cluster.py`
interleaves N engines on one heap behind SLO-aware admission control;
`sched/workload.py` generates seeded, JSON-replayable traces,
`sched/replay.py` replays one trace differentially through every
registered policy and mechanism, and `sched/sweep.py` compiles
declarative grid specs over all of it into cached, cost-ordered parallel
sweeps; `sched/faults.py` injects seeded, oracle-checked fault schedules
into cluster replays."""
from repro_torch.sched.cluster import (FAULTS, ClusterConfig, ClusterEngine,
                                       ClusterMetrics, ClusterTopology, Router,
                                       ShardSpec)
from repro_torch.sched.engine import (Engine, PoolModel, Request, ServeConfig,
                                      ServeMetrics)
from repro_torch.sched.faults import (FAULT_PLANS, FaultEvent, FaultPlan,
                                      check_resilience, register_fault_plan,
                                      registered_fault_plans,
                                      resolve_fault_plan)
from repro_torch.sched.freq import (ENGINE_FREQ_MS, KV_HANDOFF_MS,
                                    FreqDomainConfig, FrequencyDomain,
                                    ResidencyWindow)
from repro_torch.sched.policy import (CLUSTER_POLICIES, POLICIES,
                                      AdaptivePolicy, ClusterAdaptivePolicy,
                                      ClusterFreqAwarePolicy, ClusterPolicy,
                                      ClusterRoundRobinPolicy, CohortPolicy,
                                      LoadSignals, Policy,
                                      SharedBaselinePolicy, ShardView,
                                      SpecializedPolicy, TypeChangeDecision,
                                      light_penalty, make_cluster_policy,
                                      make_policy, register_cluster_policy,
                                      register_policy,
                                      registered_cluster_policies,
                                      registered_policies)
from repro_torch.sched.sweep import (PRESETS, AxisGrid, SweepCache, SweepSpec,
                                     SweepSpecError, baseline_deltas, leg_key,
                                     matrix_spec, preset_spec, reduce_rows,
                                     register_preset, run_legs, run_sweep,
                                     sweep_json, tidy_rows)
from repro_torch.sched.topology import Pool, Topology, WorkKind
from repro_torch.sched.workload import (CLUSTER_SCENARIOS, SCENARIOS, Tenant,
                                        Trace, WorkloadSpec, poisson_workload,
                                        register_cluster_scenario,
                                        register_scenario, scenario_spec,
                                        scenario_trace)

__all__ = [
    "AdaptivePolicy", "AxisGrid", "CLUSTER_POLICIES", "CLUSTER_SCENARIOS",
    "ClusterAdaptivePolicy", "ClusterConfig", "ClusterEngine",
    "ClusterFreqAwarePolicy", "ClusterMetrics", "ClusterPolicy",
    "ClusterRoundRobinPolicy", "ClusterTopology", "CohortPolicy",
    "ENGINE_FREQ_MS", "Engine", "FAULTS", "FAULT_PLANS", "FaultEvent",
    "FaultPlan", "FreqDomainConfig", "FrequencyDomain",
    "KV_HANDOFF_MS", "LoadSignals", "POLICIES", "PRESETS", "Policy",
    "Pool", "PoolModel", "Request", "ResidencyWindow", "Router",
    "SCENARIOS", "ServeConfig", "ServeMetrics",
    "SharedBaselinePolicy", "ShardSpec", "ShardView",
    "SpecializedPolicy", "SweepCache", "SweepSpec", "SweepSpecError",
    "Tenant", "Topology", "Trace", "TypeChangeDecision", "WorkKind",
    "WorkloadSpec", "baseline_deltas", "check_resilience", "leg_key",
    "light_penalty", "make_cluster_policy", "make_policy", "matrix_spec",
    "poisson_workload", "preset_spec", "reduce_rows",
    "register_cluster_policy", "register_fault_plan", "register_policy",
    "register_preset", "register_cluster_scenario", "register_scenario",
    "registered_cluster_policies", "registered_fault_plans",
    "registered_policies", "resolve_fault_plan", "run_legs",
    "run_sweep", "scenario_spec", "scenario_trace", "sweep_json",
    "tidy_rows",
]
