"""Adaptive core-specialization policy (paper §4.3, stated as future work
— implemented here as a beyond-paper feature).

"A good policy has to estimate the impact of core specialization on
performance and, depending on the outcome, has to choose whether to use
core specialization or not."

The estimator compares, from online counters over a sampling window:

  benefit  ≈ scalar_cycle_share * freq_drop_avoided * coverage
  cost     ≈ type_change_rate * cost_per_change_pair / n_cores

and enables specialization when benefit > cost (with hysteresis so the
decision does not flap). It also sizes the AVX-core pool from the
observed AVX cycle share (§2.1: the core-ratio must match the work
ratio or utilization collapses).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class AdaptiveConfig:
    window_us: float = 100_000.0
    cost_per_change_pair_us: float = 0.45e-3 * 1e3   # 450 ns, Fig. 7
    enable_margin: float = 1.2       # benefit must exceed cost x margin
    disable_margin: float = 0.8
    min_avx_cores: int = 1


@dataclass
class AdaptiveState:
    enabled: bool = False
    n_avx_cores: int = 1


class AdaptivePolicy:
    def __init__(self, cfg: AdaptiveConfig, n_cores: int, freq=None):
        # repro_torch.sched.freq is imported lazily: repro_torch.sched.policy
        # imports this module at its own import time, so a module-level
        # import here would make `import repro_torch.core.adaptive` (as the
        # first repro import of a process) circular
        from repro_torch.sched.freq import FreqDomainConfig
        self.cfg = cfg
        self.n_cores = n_cores
        self.freq = freq if freq is not None else FreqDomainConfig()
        self.state = AdaptiveState()

    def estimate_benefit(self, scalar_share: float, heavy_share: float,
                         l2_residency: float) -> float:
        """Fraction of total capacity recovered by confining heavy work.

        Without specialization every core spends ~l2_residency of its time
        at the reduced frequency; with it, only the AVX pool does."""
        f = self.freq.freqs_ghz
        drop = 1.0 - f[-1] / f[0]
        pool = self.pool_size(heavy_share) / self.n_cores
        return scalar_share * l2_residency * drop * (1.0 - pool)

    def estimate_cost(self, type_changes_per_s: float) -> float:
        pairs = type_changes_per_s / 2.0
        us_per_s = pairs * self.cfg.cost_per_change_pair_us
        return us_per_s / (self.n_cores * 1e6)

    def pool_size(self, heavy_share: float) -> int:
        """§2.1: allocate as many AVX cores as the AVX work needs, or more
        (asymmetric stealing absorbs the slack)."""
        import math
        need = math.ceil(heavy_share * self.n_cores * 1.3)
        return max(self.cfg.min_avx_cores, min(need, self.n_cores - 1))

    def update(self, *, scalar_share: float, heavy_share: float,
               l2_residency: float, type_changes_per_s: float
               ) -> AdaptiveState:
        benefit = self.estimate_benefit(scalar_share, heavy_share,
                                        l2_residency)
        cost = self.estimate_cost(type_changes_per_s)
        if self.state.enabled:
            if benefit < cost * self.cfg.disable_margin:
                self.state.enabled = False
        else:
            if benefit > cost * self.cfg.enable_margin:
                self.state.enabled = True
        self.state.n_avx_cores = self.pool_size(heavy_share)
        return self.state
