"""Unified frequency/power domain layer: ONE license state machine.

The paper's entire mechanism exists because of a physical process —
per-core license levels with a ~500 µs grant window and a ~2 ms revert
hysteresis that slows trailing scalar code. Before this module that
state machine lived in ``core/license.py`` and only the OS simulator
integrated it; the serving engine priced heavy work with fixed per-kind
durations. ``FrequencyDomain`` is the state machine refactored into a
mechanism-agnostic layer consumed by BOTH schedulers:

  * the OS simulator attaches one domain per core (µs time base,
    ``CoreLicense`` in ``core/license.py`` is now a thin IClass-mapping
    view over it);
  * the serving engine attaches one domain per pool (ms time base) and
    integrates every prefill/decode/handoff duration through it, so the
    trailing-work slowdown is *emergent* — a decode landing inside the
    hysteresis window after a prefill runs slow because the pool's
    clock is still at the reduced level, not because of a hand-tuned
    constant.

Semantics (documented Intel Skylake-SP behaviour, paper §2/Fig. 1):

  * N license levels with per-level max frequency (default Xeon Gold
    6130 all-core turbo: L0 2.8 GHz, L1 heavy-AVX2 2.4 GHz, L2
    heavy-AVX-512 1.9 GHz);
  * a *dense* heavy section requests a lower-frequency (higher-index)
    license; the PCU takes up to ``grant_delay`` to grant, during which
    execution proceeds at ``throttle_factor`` x the target frequency;
  * a small ``detect_delay`` (~100 instructions) precedes the request;
  * reverting to L0 is delayed ``hysteresis`` after the last dense
    heavy section — the tail that slows trailing scalar/decode work;
  * accounting: cycles and wall time per level, throttle window
    cycles/time, transition log, and an energy proxy
    (power ∝ (f/f0)^3, Dim Silicon's DVFS argument, times a
    ``heavy_power_factor`` while heavy sections execute — the current
    draw that makes licenses exist in the first place).

Times are in the domain's own unit (µs for cores, ms for serving
pools); frequencies in GHz. ``cycles_per_ghz`` converts between them
and cancels out for consumers that only speak durations
(``heavy_section``/``light_section``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class FreqDomainConfig:
    """Per-domain license/frequency parameters.

    ``grant_delay``/``hysteresis``/``detect_delay`` are in the domain's
    time unit (``time_unit`` is documentation, not arithmetic).
    """
    freqs_ghz: Tuple[float, ...] = (2.8, 2.4, 1.9)
    grant_delay: float = 500.0        # PCU evaluation window (<= 500 µs)
    hysteresis: float = 2_000.0       # revert delay after last heavy op
    detect_delay: float = 0.035       # ~100 instructions @ ~2.8 GHz
    throttle_factor: float = 0.75     # x target freq during the request
    cycles_per_ghz: float = 1000.0    # cycles per time-unit per GHz
    heavy_power_factor: float = 1.3   # relative power of heavy sections
    time_unit: str = "us"

    @property
    def n_levels(self) -> int:
        return len(self.freqs_ghz)

    @property
    def max_level(self) -> int:
        return len(self.freqs_ghz) - 1


# The serving engine's domain: same license physics on a millisecond
# time base (grant window 0.5 ms, revert hysteresis 2 ms). Frequencies
# keep the Xeon Gold 6130 levels — the engine only consumes ratios.
ENGINE_FREQ_MS = FreqDomainConfig(grant_delay=0.5, hysteresis=2.0,
                                  detect_delay=0.0, time_unit="ms")

# ---------------------------------------------------------------------
# Two engine constants are numerically equal BY COINCIDENCE and must
# never shadow each other:
#
#   HYSTERESIS_MS (2.0)  — license physics: how long a pool's clock
#                          stays at the reduced level after the last
#                          heavy section (ENGINE_FREQ_MS.hysteresis).
#   KV_HANDOFF_MS (2.0)  — scheduling cost: how long the KV-cache copy
#                          of one request between pools takes (the
#                          400-500 ns core-migration analogue, scaled).
#
# Changing one must not change the other: the engine reads the
# hysteresis only through its FreqDomainConfig and the handoff cost
# only through PoolModel.handoff_ms (defaulted from KV_HANDOFF_MS).
# ---------------------------------------------------------------------
HYSTERESIS_MS = ENGINE_FREQ_MS.hysteresis
KV_HANDOFF_MS = 2.0


class FrequencyDomain:
    """License state machine + cycle/time/energy accounting for one
    clock domain (a core, or a serving pool).

    The integration algorithm is the original ``CoreLicense.execute``
    unchanged (paper tests pin its outputs); this class adds exact
    wall-time residency, an energy proxy, a transition log, and the
    duration-facing ``heavy_section``/``light_section`` API the serving
    engine consumes.
    """

    def __init__(self, cfg: FreqDomainConfig = FreqDomainConfig(),
                 record: bool = False):
        n = cfg.n_levels
        self.cfg = cfg
        self.level = 0                       # currently granted level
        self.pending: Optional[int] = None   # requested level
        self.grant_at = 0.0                  # when pending becomes level
        self.revert_at: Optional[float] = None   # hysteresis expiry
        self.last_heavy_end = 0.0
        # brownout clamp (fault injection): while t < clamp_until the
        # domain's frequency is capped at freqs_ghz[clamp_level], as if
        # the PCU were stuck granting a low license. Inactive by
        # default (clamp_level 0 caps at f0 == no-op).
        self.clamp_level = 0
        self.clamp_until = 0.0
        # accounting (CORE_POWER.* perf counters + frequency residency)
        self.cycles_at_level: List[float] = [0.0] * n
        self.time_at_level: List[float] = [0.0] * n
        self.throttle_cycles = 0.0
        self.throttled_time = 0.0
        self.busy_time = 0.0
        self.freq_time = 0.0                 # ∫ f dt over busy time
        self.energy = 0.0                    # ∫ (f/f0)^3 * pf dt
        self.transitions = 0
        # transition log: ("request", t, want) | ("grant", t, frm, to)
        #               | ("revert", t, frm, last_heavy_end)
        self.events: List[Tuple] = []
        # optional per-span trace for the replay oracle:
        # (start, end, granted_level, pending_level | None, speed_ghz)
        self.record = record
        self.sections: List[Tuple] = []

    # -------------------------------------------------- state machine

    def _advance(self, t: float):
        if self.pending is not None and t >= self.grant_at:
            self.events.append(("grant", self.grant_at, self.level,
                                self.pending))
            self.level = self.pending
            self.pending = None
            self.transitions += 1
        if self.revert_at is not None and t >= self.revert_at:
            self.events.append(("revert", self.revert_at, self.level,
                                self.last_heavy_end))
            self.level = 0
            self.revert_at = None
            self.transitions += 1

    def advance(self, t: float):
        """Apply any grant/revert whose boundary has passed (the engine
        calls this from explicit revert events on its heap so level
        transitions are applied at their boundary even while the domain
        is idle)."""
        self._advance(t)

    def speed_ghz(self, t: float) -> float:
        self._advance(t)
        if self.pending is not None:
            v = self.cfg.freqs_ghz[self.pending] * self.cfg.throttle_factor
        else:
            v = self.cfg.freqs_ghz[self.level]
        if self.clamp_level > 0 and t < self.clamp_until:
            v = min(v, self.cfg.freqs_ghz[self.clamp_level])
        return v

    def next_event(self, t: float) -> Optional[float]:
        ev = []
        if self.pending is not None and self.grant_at > t:
            ev.append(self.grant_at)
        if self.revert_at is not None and self.revert_at > t:
            ev.append(self.revert_at)
        if self.clamp_level > 0 and self.clamp_until > t:
            ev.append(self.clamp_until)
        return min(ev) if ev else None

    def set_clamp(self, level: int, until: float) -> None:
        """Brownout fault: cap this domain at ``freqs_ghz[level]`` until
        ``until`` (absolute domain time). The cap binds only when it is
        below the license state machine's own speed, and residency is
        attributed to the clamped level while it binds — so the router's
        measured-residency signal sees a browned-out shard as reduced
        without any special-casing."""
        if not (0 <= level < self.cfg.n_levels):
            raise ValueError(f"clamp level {level} out of range")
        self.clamp_level = int(level)
        self.clamp_until = float(until)

    def _acct_idx(self, now: float) -> int:
        """Level index residency/cycles are charged to at ``now`` —
        the license index, raised to the clamp level while a brownout
        clamp binds."""
        idx = self.level if self.pending is None else self.pending
        if self.clamp_level > idx and now < self.clamp_until:
            idx = self.clamp_level
        return idx

    def execute(self, t: float, cycles: float, level: int,
                dense: bool) -> float:
        """Run ``cycles`` nominal cycles of level-``level`` work starting
        at ``t``; returns the end time and updates license state and all
        counters. ``dense`` heavy work requests/refreshes the license;
        sparse sections run through without changing frequency."""
        return self.execute_until(t, cycles, level, dense)[0]

    def execute_until(self, t: float, cycles: float, level: int,
                      dense: bool, deadline: Optional[float] = None
                      ) -> Tuple[float, float]:
        """Batched fast path: integrate up to ``cycles`` of level-
        ``level`` work starting at ``t``, stopping early when the wall
        clock reaches ``deadline``. Splits only at license transitions
        (grant/revert boundaries), in closed form — one loop iteration
        per frequency phase instead of one per caller-side chunk.

        Returns ``(end_time, cycles_done)``. With ``deadline=None`` the
        arithmetic is operation-for-operation the original ``execute``
        (the paper pins rely on that). A deadline-capped dense section
        still requests the license and schedules the revert hysteresis
        from its *partial* end — exactly what back-to-back chunked
        ``execute`` calls produced."""
        cfg = self.cfg
        self._advance(t)
        want = level
        if dense and want > self.level and (
                self.pending is None or self.pending < want):
            # request a lower-frequency (higher-index) license
            self.pending = want
            self.grant_at = t + cfg.detect_delay + cfg.grant_delay
            self.events.append(("request", t, want))
        if dense and want >= 1:
            # dense heavy section: cancel any pending revert (the license
            # timer refreshes); sparse heavy sections do not sustain it
            self.revert_at = None
        power_factor = cfg.heavy_power_factor if (dense and want >= 1) \
            else 1.0
        f0 = cfg.freqs_ghz[0]
        remaining = cycles
        now = t
        while remaining > 1e-9:
            if deadline is not None and now >= deadline:
                break
            v_ghz = self.speed_ghz(now)
            v = v_ghz * cfg.cycles_per_ghz                 # cycles / unit
            nxt = self.next_event(now)
            span = remaining / v if nxt is None else min(remaining / v,
                                                         nxt - now)
            if deadline is not None and deadline - now < span:
                span = deadline - now
            done = span * v
            idx = self._acct_idx(now)
            self.cycles_at_level[idx] += done
            self.time_at_level[idx] += span
            if self.pending is not None:
                self.throttle_cycles += done
                self.throttled_time += span
            self.busy_time += span
            self.freq_time += span * v_ghz
            self.energy += span * power_factor * (v_ghz / f0) ** 3
            if self.record:
                self.sections.append((now, now + span, self.level,
                                      self.pending, v_ghz))
            remaining -= done
            now += span
            self._advance(now)
        if dense and want >= 1:
            self.last_heavy_end = now
            self.revert_at = now + cfg.hysteresis
        return now, cycles - remaining

    # ------------------------------------------------ state save/restore

    def save_state(self) -> Tuple:
        """Cheap full snapshot of license + accounting state. Used by the
        event-horizon simulator to undo an optimistically committed span
        when a preemption IPI lands inside it (history lists are
        truncated back by length, not copied). Taken once per span —
        keep it a flat tuple, no introspection."""
        return (self.level, self.pending, self.grant_at, self.revert_at,
                self.last_heavy_end, self.throttle_cycles,
                self.throttled_time, self.busy_time, self.freq_time,
                self.energy, self.transitions,
                list(self.cycles_at_level), list(self.time_at_level),
                len(self.events), len(self.sections),
                self.clamp_level, self.clamp_until)

    def restore_state(self, snap: Tuple) -> None:
        (self.level, self.pending, self.grant_at, self.revert_at,
         self.last_heavy_end, self.throttle_cycles, self.throttled_time,
         self.busy_time, self.freq_time, self.energy, self.transitions,
         cyc, tim, n_ev, n_sec,
         self.clamp_level, self.clamp_until) = snap
        self.cycles_at_level[:] = cyc
        self.time_at_level[:] = tim
        del self.events[n_ev:]
        del self.sections[n_sec:]

    # ------------------------------------------- duration-facing API

    def heavy_section(self, t: float, dur: float,
                      level: Optional[int] = None) -> float:
        """Run a heavy section whose nominal duration ``dur`` is
        measured AT its own license level (a roofline prefill time IS
        the time the MXU-bound work takes while holding the license):
        requests/refreshes the license and is extended only by the
        throttle window while the grant is pending."""
        lvl = self.cfg.max_level if level is None else level
        cycles = dur * self.cfg.freqs_ghz[lvl] * self.cfg.cycles_per_ghz
        return self.execute(t, cycles, lvl, dense=True)

    def light_section(self, t: float, dur: float) -> float:
        """Run a light section whose nominal duration ``dur`` is
        measured at L0: while the domain sits below L0 (grant pending or
        hysteresis tail after heavy work) the section is slowed by
        f0/f(t) — the paper's trailing-scalar effect, emergent."""
        cycles = dur * self.cfg.freqs_ghz[0] * self.cfg.cycles_per_ghz
        return self.execute(t, cycles, 0, dense=False)

    def observe(self, t: float, dur: float, level: int = 0,
                dense: bool = False) -> float:
        """Accounting-only integration of a MEASURED section [t, t+dur]:
        drives the license state machine (requests, hysteresis refresh,
        grant/revert boundaries) and attributes residency/energy, but
        never alters the duration. The engine uses this for live
        executors — a real jitted call's wall time already contains any
        real throttling, so re-stretching it through the model would
        report latencies nothing actually exhibited."""
        cfg = self.cfg
        self._advance(t)
        want = level
        if dense and want > self.level and (
                self.pending is None or self.pending < want):
            self.pending = want
            self.grant_at = t + cfg.detect_delay + cfg.grant_delay
            self.events.append(("request", t, want))
        if dense and want >= 1:
            self.revert_at = None
        power_factor = cfg.heavy_power_factor if (dense and want >= 1) \
            else 1.0
        f0 = cfg.freqs_ghz[0]
        now, end = t, t + dur
        while now < end - 1e-12:
            v_ghz = self.speed_ghz(now)
            nxt = self.next_event(now)
            span = end - now if nxt is None else min(end - now, nxt - now)
            done = span * v_ghz * cfg.cycles_per_ghz
            idx = self._acct_idx(now)
            self.cycles_at_level[idx] += done
            self.time_at_level[idx] += span
            if self.pending is not None:
                self.throttle_cycles += done
                self.throttled_time += span
            self.busy_time += span
            self.freq_time += span * v_ghz
            self.energy += span * power_factor * (v_ghz / f0) ** 3
            if self.record:
                self.sections.append((now, now + span, self.level,
                                      self.pending, v_ghz))
            now += span
            self._advance(now)
        if dense and want >= 1:
            self.last_heavy_end = end
            self.revert_at = end + cfg.hysteresis
        return end

    # ------------------------------------------------------ accounting

    def window_counters(self) -> Tuple[float, float, float, int]:
        """(reduced, busy, energy, transitions) — the counters
        :class:`ResidencyWindow` differentiates per window."""
        return (self.reduced_time(), self.busy_time, self.energy,
                self.transitions)

    def reduced_time(self) -> float:
        """Wall time executed below L0 (the measured license residency
        the adaptive policy sizes pools from). Throttle-window spans are
        already charged to ``time_at_level[pending >= 1]``, so the sum
        over levels 1.. captures them — adding ``throttled_time`` here
        would double-count and push residency past 1.0."""
        return sum(self.time_at_level[1:])

    def avg_freq_ghz(self) -> float:
        """Busy-time-weighted average frequency (exact — includes the
        throttle window at its actual reduced speed)."""
        if self.busy_time <= 0.0:
            return self.cfg.freqs_ghz[0]
        return self.freq_time / self.busy_time

    def freq_time_integral(self) -> Tuple[float, float]:
        """Legacy Fig. 6 derivation (cycles / level frequency), kept
        bit-identical for the paper-results pins: returns
        (avg_freq_ghz, total_time)."""
        f = self.cfg.freqs_ghz
        total_c = sum(self.cycles_at_level)
        if total_c == 0:
            return (f[0], 0.0)
        t_at = [c / (f[i] * self.cfg.cycles_per_ghz)
                for i, c in enumerate(self.cycles_at_level)]
        total_t = sum(t_at)
        avg = sum(f[i] * t_at[i] for i in range(len(f))) / total_t
        return (avg, total_t)

    def snapshot(self) -> dict:
        """JSON-able accounting summary (metrics matrices, benchmarks,
        the CI frequency-trace artifact)."""
        return {
            "time_at_level": list(self.time_at_level),
            "throttled": self.throttled_time,
            "busy": self.busy_time,
            "reduced": self.reduced_time(),
            "transitions": self.transitions,
            "avg_freq_ghz": self.avg_freq_ghz(),
            "energy_proxy": self.energy,
        }


class ResidencyWindow:
    """Windowed deltas over a set of :class:`FrequencyDomain` counters.

    Every adaptive layer in the system sizes or routes on *measured*
    license residency over its own observation window: the engine's
    ``AdaptivePolicy`` resizes a pool split on the per-window reduced
    time of its heavy pools, and the cluster router scores shard
    placement on each shard's per-window residency and energy draw.
    Both previously would have to snapshot/diff raw counters by hand;
    this class owns that bookkeeping — snapshot at window start
    (``roll``), delta on demand (``peek``/``peek_reduced``).

    Domains are keyed by name; the window survives the set of domains
    being replaced only by constructing a fresh window (per run), which
    is what every consumer does.
    """

    def __init__(self, domains):
        self.domains = domains        # Dict[str, FrequencyDomain]
        self._base = {k: d.window_counters() for k, d in domains.items()}

    def peek(self) -> dict:
        """Per-domain deltas since the last ``roll`` (or construction):
        ``{name: {"reduced": .., "busy": .., "energy": ..,
        "transitions": ..}}`` — no reset."""
        out = {}
        for k, d in self.domains.items():
            red, busy, en, tr = d.window_counters()
            b_red, b_busy, b_en, b_tr = self._base[k]
            out[k] = {"reduced": red - b_red, "busy": busy - b_busy,
                      "energy": en - b_en, "transitions": tr - b_tr}
        return out

    def peek_reduced(self, names) -> float:
        """Sum of reduced-time deltas over ``names`` since the last
        roll — the engine's resize signal (heavy pools only)."""
        total = 0.0
        for k in names:
            total += self.domains[k].reduced_time() - self._base[k][0]
        return total

    def roll(self) -> None:
        """Close the window: future deltas measure from now."""
        self._base = {k: d.window_counters()
                      for k, d in self.domains.items()}
