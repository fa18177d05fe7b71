"""Scheduling API of the port: Topology (pool layout), Policy (placement,
stealing, resizing), the frequency domain, and the event-driven serving
engine. Copies of the framework-free ``repro.sched`` modules the serve
path runs; the cluster, fault, sweep, replay and workload tiers are not
ported yet."""
from repro_torch.sched.engine import (Engine, PoolModel, Request,
                                      ServeConfig, ServeMetrics)
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
from repro_torch.sched.topology import Pool, Topology, WorkKind

__all__ = [
    "AdaptivePolicy", "CLUSTER_POLICIES", "ClusterAdaptivePolicy",
    "ClusterFreqAwarePolicy", "ClusterPolicy", "ClusterRoundRobinPolicy",
    "CohortPolicy", "ENGINE_FREQ_MS", "Engine", "FreqDomainConfig",
    "FrequencyDomain", "KV_HANDOFF_MS", "LoadSignals", "POLICIES",
    "Policy", "Pool", "PoolModel", "Request", "ResidencyWindow",
    "ServeConfig", "ServeMetrics", "SharedBaselinePolicy", "ShardView",
    "SpecializedPolicy", "Topology", "TypeChangeDecision", "WorkKind",
    "light_penalty", "make_cluster_policy", "make_policy",
    "register_cluster_policy", "register_policy",
    "registered_cluster_policies", "registered_policies",
]
