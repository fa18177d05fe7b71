"""The general traffic generator: one cell's mix file in, a list of
(arrival in engine ms, output tokens) out.

The arrival processes and length samplers are frozen copies of
``repro_torch/sched/workload.py`` (``PoissonArrivals``, ``MMPPArrivals``,
``FixedLen``, ``UniformLen``, ``LognormalLen``, ``ZipfLen``), kept here so
that no change to the program moves the yardstick. ``MMPPArrivals`` gains
``phases``, which ``times`` is now written over: the same draws, kept by
phase.

``requests(mix, seed)`` gives every seed the same work in another order.
The gaps between arrivals and the output lengths are drawn once, from the
mix's ``base_seed``, over ``horizon_s`` of engine time; ``seed`` then
shuffles them inside blocks (``block`` requests; for the on/off process
``cycle_block`` on+off cycles, each keeping its own arrivals). So every
block holds the same gaps and lengths whatever the seed, and a run's load
does not drift with its seed; what changes is their order, the prompts and
the weights.

A mix file (JSON):

  {"prompt": 256, "output": {"kind": "uniform", "lo": 32, "hi": 97},
   "arrivals": {"kind": "poisson", "rate_per_s": 0.7},
   "base_seed": 0, "horizon_s": 900, "block": 16, ...}

``arrivals`` takes ``{"kind": "mmpp", "rate_on_per_s", "rate_off_per_s",
"mean_on_ms", "mean_off_ms"}`` too. A length sampler is ``{"kind":
"fixed" | "uniform" | "lognormal" | "zipf", ...}`` with its class's fields.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

# ------------------------------------------------------------- arrivals
# (frozen copies of repro_torch.sched.workload)


@dataclass(frozen=True)
class PoissonArrivals:
    """Memoryless arrivals at a constant rate (the original baseline)."""
    rate_per_s: float

    def times(self, duration_ms: float, rng: np.random.Generator
              ) -> List[float]:
        out, t = [], 0.0
        while True:
            t += rng.exponential(1000.0 / self.rate_per_s)
            if t >= duration_ms:
                return out
            out.append(t)


@dataclass(frozen=True)
class MMPPArrivals:
    """2-state Markov-modulated Poisson process: exponential ON bursts
    at ``rate_on_per_s`` alternating with quiet OFF stretches — the
    classic bursty-traffic model (flash crowds, batch ingest)."""
    rate_on_per_s: float
    rate_off_per_s: float
    mean_on_ms: float
    mean_off_ms: float

    def phases(self, duration_ms: float, rng: np.random.Generator
               ) -> List[Tuple[float, List[float]]]:
        """(length, arrival offsets in it) of each phase, ON first, with
        the draws of ``times`` in its order."""
        out, t, on = [], 0.0, True
        while t < duration_ms:
            phase = rng.exponential(self.mean_on_ms if on
                                    else self.mean_off_ms)
            rate = self.rate_on_per_s if on else self.rate_off_per_s
            end = min(t + phase, duration_ms)
            offs = []
            if rate > 0:
                tt = t
                while True:
                    tt += rng.exponential(1000.0 / rate)
                    if tt >= end:
                        break
                    offs.append(tt - t)
            out.append((phase, offs))
            t += phase
            on = not on
        return out

    def times(self, duration_ms: float, rng: np.random.Generator
              ) -> List[float]:
        out, t = [], 0.0
        for phase, offs in self.phases(duration_ms, rng):
            out.extend(t + o for o in offs)
            t += phase
        return out


# -------------------------------------------------------------- lengths


@dataclass(frozen=True)
class FixedLen:
    n: int

    def sample(self, rng: np.random.Generator) -> int:
        return self.n


@dataclass(frozen=True)
class UniformLen:
    """Uniform on [lo, hi): ``hi`` itself is never drawn."""
    lo: int
    hi: int

    def sample(self, rng: np.random.Generator) -> int:
        return int(rng.uniform(self.lo, self.hi))


@dataclass(frozen=True)
class LognormalLen:
    """Heavy-tailed lengths around ``median`` (exp-normal), clipped."""
    median: float
    sigma: float = 0.7
    lo: int = 16
    hi: int = 16_384

    def sample(self, rng: np.random.Generator) -> int:
        v = math.exp(rng.normal(math.log(self.median), self.sigma))
        return int(min(max(v, self.lo), self.hi))


@dataclass(frozen=True)
class ZipfLen:
    """Zipf-tailed lengths: ``lo`` plus a Zipf(alpha) draw, clipped at
    ``hi`` — most requests short, a fat tail of very long ones."""
    alpha: float = 1.6
    lo: int = 16
    hi: int = 1_024

    def sample(self, rng: np.random.Generator) -> int:
        return int(min(self.lo + int(rng.zipf(self.alpha)) - 1, self.hi))


ARRIVALS = {"poisson": PoissonArrivals, "mmpp": MMPPArrivals}
LENGTHS = {"fixed": FixedLen, "uniform": UniformLen,
           "lognormal": LognormalLen, "zipf": ZipfLen}


def _make(spec: dict, registry: dict):
    spec = dict(spec)
    return registry[spec.pop("kind")](**spec)


def _shuffled(items: list, block: int, rng: np.random.Generator) -> list:
    """``items`` with each run of ``block`` shuffled in place."""
    out = []
    for i in range(0, len(items), block):
        part = items[i:i + block]
        out.extend(part[j] for j in rng.permutation(len(part)))
    return out


def requests(mix: dict, seed: int, arrivals: dict | None = None
             ) -> List[Tuple[float, int]]:
    """(arrival ms, output tokens) of every request in ``mix``'s horizon,
    in arrival order: the base draws of ``mix["base_seed"]`` shuffled by
    ``seed`` (any whole number). ``arrivals`` replaces the mix's own
    arrival process (the knee sweep offers the cell's lengths at other
    rates)."""
    base = np.random.default_rng(int(mix.get("base_seed", 0)))
    order = np.random.default_rng(np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1), 0x7261]))
    horizon = float(mix["horizon_s"]) * 1000.0
    proc = _make(arrivals or mix["arrivals"], ARRIVALS)
    block = int(mix.get("block", 16))
    if isinstance(proc, MMPPArrivals):
        ph = proc.phases(horizon, base)
        cycles = [ph[i:i + 2] for i in range(0, len(ph), 2)]
        cycles = _shuffled(cycles, int(mix.get("cycle_block", 4)), order)
        times, t = [], 0.0
        for cyc in cycles:
            for length, offs in cyc:
                times.extend(t + o for o in offs)
                t += length
    else:
        raw = proc.times(horizon, base)
        gaps = np.diff([0.0] + raw).tolist()
        times = np.cumsum(_shuffled(gaps, block, order)).tolist()
    out_len = _make(mix["output"], LENGTHS)
    lens = [max(1, out_len.sample(base)) for _ in times]
    lens = _shuffled(lens, block, order)
    return [(round(t, 6), n) for t, n in zip(times, lens) if t < horizon]
