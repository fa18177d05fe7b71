"""CORE_POWER.* performance-counter analysis + throttle flame graphs.

Mirrors the paper's §3.3 workflow: the THROTTLE counter fires right after
the condition for a frequency reduction is detected, so attributing
throttle cycles to call stacks localizes the code that *causes* license
requests (whereas LVL1/LVL2 cycles smear across the 2 ms tail into
innocent scalar code — reproduced by ``smearing_demo`` in the tests).

``folded()`` emits Brendan-Gregg folded-stack lines; feed to flamegraph.pl
or read directly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.simulator import Simulator


@dataclass
class CounterReport:
    counters: Dict[str, float]
    flame_throttle: Dict[Tuple[str, ...], float]
    flame_cycles: Dict[Tuple[str, ...], float]

    def folded(self, which: str = "throttle") -> str:
        src = self.flame_throttle if which == "throttle" else self.flame_cycles
        return "\n".join(f"{';'.join(stack)} {int(v)}"
                         for stack, v in sorted(src.items(),
                                                key=lambda kv: -kv[1]) if v > 0)

    def culprits(self, top: int = 5) -> List[Tuple[str, float]]:
        """Stacks ranked by throttle cycles — the paper's candidates for
        core specialization (after cross-checking with static analysis)."""
        ranked = sorted(self.flame_throttle.items(), key=lambda kv: -kv[1])
        return [("/".join(k), v) for k, v in ranked[:top] if v > 0]

    def license_residency(self) -> Dict[str, float]:
        tot = sum(self.counters[f"LVL{i}_TURBO_LICENSE"] for i in range(3))
        if not tot:
            return {f"LVL{i}": 0.0 for i in range(3)}
        return {f"LVL{i}": self.counters[f"LVL{i}_TURBO_LICENSE"] / tot
                for i in range(3)}


def collect(sim: Simulator) -> CounterReport:
    return CounterReport(counters=sim.counters(),
                         flame_throttle=dict(sim.metrics.flame_throttle),
                         flame_cycles=dict(sim.metrics.flame_cycles))


def cross_check(report_: CounterReport, static_ranked: Sequence) -> List[str]:
    """§3.3: intersect throttle-flame-graph culprits with the static
    analysis ranking to drop false positives (code merely *after* a
    frequency change). Returns function names to annotate."""
    static_heavy = {p.name for p in static_ranked if p.heavy_ratio > 0.25}
    out = []
    for stack, _ in report_.culprits(top=10):
        leaf = stack.split("/")[-1]
        if any(s in leaf or leaf in s for s in static_heavy):
            out.append(leaf)
    return out
