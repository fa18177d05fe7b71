"""Scheduling policy: *what* runs *where* — separated from mechanism.

The paper's contribution is a policy (confine marked-heavy work to a
core subset, steal asymmetrically, migrate on type change); the OS
simulator (`core/muqss.py` + `core/simulator.py`) and the serving
engine (`sched/engine.py`) are mechanisms. A :class:`Policy` answers
the questions both mechanisms ask:

  * **placement** — on which pools should work of a given kind queue?
  * **steal eligibility** — may an idle pool execute a kind it is not
    the placement target for (the asymmetric rule: the heavy pool may
    run light work, never the reverse)?
  * **queue order / penalty** — in what order does a pool scan its
    queues, and with what deadline penalty (the MuQSS idle-priority
    trick, §3.2)?
  * **preemption on type change** — when work changes kind (the
    ``with_avx``/``without_avx`` syscalls; prefill→decode in serving),
    must it migrate, and should a lower-class occupant of the target
    pool be preempted via IPI?
  * **resizing** — given observed load, should the topology change
    (the §4.3 adaptive policy, previously wired to nothing)?

Mechanisms consume the subset they need: the MuQSS scheduler uses
``queue_order``/``penalty``/``placement``/``on_type_change``; the
event-driven serving engine uses ``eligible``/``placement``/
``on_type_change``/``heavy_burst``/``resize``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.adaptive import AdaptivePolicy as AdaptiveEstimator
from repro_torch.sched.freq import FreqDomainConfig
from repro_torch.sched.topology import Pool, Topology, WorkKind


def light_penalty(freq: FreqDomainConfig = FreqDomainConfig()) -> float:
    """Deadline penalty added to light work on dedicated heavy pools —
    the MuQSS idle-priority trick, but derived from the frequency
    domain instead of a magic constant: the worst-case slowdown ratio
    (f0 / f_min) integrated over one full request + hysteresis cycle,
    scaled 1e6x past any virtual deadline either mechanism generates.
    Light work on a heavy pool therefore only ever wins when no
    heavy-eligible work exists anywhere — exactly the asymmetric rule."""
    ratio = freq.freqs_ghz[0] / min(freq.freqs_ghz)
    window = freq.detect_delay + freq.grant_delay + freq.hysteresis
    return ratio * window * 1e6


# Derived for the default (paper) domain; ~3.7e9 deadline units — vast
# against the ~3e6 µs simulations but traceable to license physics.
LIGHT_PENALTY = light_penalty()


@dataclass(frozen=True)
class TypeChangeDecision:
    """Policy verdict when work changes kind while placed on ``pool``.

    migrate — the work must leave its current pool (requeue);
    preempt — a heavy-pool unit currently running light work should be
        preempted (IPI) so it can pick up the newly-heavy work;
    yield_if_heavy_waiting — keep running, but give the unit back if
        heavy work is queued for this pool (the asymmetric-steal exit).
    """
    migrate: bool = False
    preempt: bool = False
    yield_if_heavy_waiting: bool = False


@dataclass
class LoadSignals:
    """Windowed observations a mechanism feeds to ``Policy.resize``."""
    heavy_share: float = 0.0          # heavy busy-time / total busy-time
    light_share: float = 0.0
    utilization: float = 0.0          # busy-time / (wall * n_units)
    type_changes_per_s: float = 0.0
    heavy_residency: float = 0.0      # wall-clock fraction heavy is live
    # MEASURED fraction of the window the heavy pools' frequency
    # domains executed below L0 (repro_torch.sched.freq residency counters);
    # 0.0 when the mechanism has no domains to measure
    license_residency: float = 0.0
    window_ms: float = 0.0


class Policy:
    """Base policy: shared/no-specialization behaviour (safe defaults).

    Subclasses override the decisions they change; every method is total
    so a custom policy only has to implement what it cares about.
    """

    name = "base"

    # ------------------------------------------------------- placement

    def placement(self, topo: Topology, kind: WorkKind) -> Tuple[str, ...]:
        """Pool names where `kind` work should queue, preferred first."""
        pools = topo.pools_with(kind) or topo.pools
        return tuple(p.name for p in pools)

    def eligible(self, topo: Topology, pool: Pool, kind: WorkKind) -> bool:
        """May `pool` *execute* `kind` (placement target or steal)?"""
        return pool.can(kind)

    # ----------------------------------------------------- queue scans

    def queue_order(self, topo: Topology, pool: Pool
                    ) -> Tuple[WorkKind, ...]:
        """Order in which `pool` scans kind-queues (first wins ties)."""
        return (WorkKind.LIGHT, WorkKind.HEAVY, WorkKind.ANY)

    def penalty(self, topo: Topology, pool: Pool) -> Dict[WorkKind, float]:
        """Deadline penalty per kind when `pool` compares queued work."""
        return {}

    # ----------------------------------------------------- transitions

    def on_type_change(self, topo: Topology, pool: Optional[Pool],
                       new_kind: WorkKind) -> TypeChangeDecision:
        return TypeChangeDecision()

    def heavy_burst(self, topo: Topology, pool: Pool) -> int:
        """How many heavy items a pool may run back-to-back before
        reconsidering light work (cohort scheduling batches >1)."""
        return 1

    # -------------------------------------------------------- resizing

    def resize(self, topo: Topology, signals: LoadSignals
               ) -> Optional[Topology]:
        """Return a replacement topology, or None to keep the current."""
        return None


class SharedBaselinePolicy(Policy):
    """No specialization: every pool runs everything, EDF order, no
    penalties, no forced migrations — plain MuQSS / vLLM-style
    continuous batching with interleaved chunked prefill."""

    name = "shared"

    def eligible(self, topo: Topology, pool: Pool, kind: WorkKind) -> bool:
        return True

    def placement(self, topo: Topology, kind: WorkKind) -> Tuple[str, ...]:
        return topo.names


class SpecializedPolicy(Policy):
    """The paper's core-specialization policy (§3.1–3.2).

    * heavy work queues only on heavy-capable pools; light/untyped work
      queues on the others (falling back to everywhere);
    * the heavy pool may run light work when idle (asymmetric steal,
      work conservation) but deprioritizes it by a large deadline
      penalty; light pools never run heavy work;
    * work turning heavy on a light pool migrates immediately, and a
      heavy-pool unit running stolen light work is preempted (IPI);
    * work turning light on the heavy pool keeps running unless heavy
      work is waiting.
    """

    name = "specialized"

    def _dedicated(self, topo: Topology, pool: Pool) -> bool:
        """Is `pool` a heavy pool in a topology that actually splits?"""
        return pool.can(WorkKind.HEAVY) \
            and len(topo.pools_with(WorkKind.HEAVY)) < len(topo.pools)

    def placement(self, topo: Topology, kind: WorkKind) -> Tuple[str, ...]:
        if kind == WorkKind.HEAVY:
            pools = topo.pools_with(WorkKind.HEAVY) or topo.pools
        else:
            light = tuple(p for p in topo.pools
                          if not self._dedicated(topo, p))
            pools = light or topo.pools
        return tuple(p.name for p in pools)

    def eligible(self, topo: Topology, pool: Pool, kind: WorkKind) -> bool:
        if kind == WorkKind.HEAVY:
            return pool.can(WorkKind.HEAVY)
        return True                     # asymmetric: heavy pool steals light

    def queue_order(self, topo: Topology, pool: Pool
                    ) -> Tuple[WorkKind, ...]:
        if self._dedicated(topo, pool):
            return (WorkKind.HEAVY, WorkKind.ANY, WorkKind.LIGHT)
        if pool.can(WorkKind.HEAVY):    # shared topology: plain order
            return (WorkKind.LIGHT, WorkKind.HEAVY, WorkKind.ANY)
        return (WorkKind.LIGHT, WorkKind.ANY)

    def penalty(self, topo: Topology, pool: Pool) -> Dict[WorkKind, float]:
        if self._dedicated(topo, pool):
            return {WorkKind.LIGHT: LIGHT_PENALTY}
        return {}

    def on_type_change(self, topo: Topology, pool: Optional[Pool],
                       new_kind: WorkKind) -> TypeChangeDecision:
        if pool is None:
            return TypeChangeDecision()
        if new_kind == WorkKind.HEAVY and not pool.can(WorkKind.HEAVY):
            return TypeChangeDecision(migrate=True, preempt=True)
        if new_kind == WorkKind.LIGHT and self._dedicated(topo, pool):
            return TypeChangeDecision(yield_if_heavy_waiting=True)
        return TypeChangeDecision()


class CohortPolicy(SharedBaselinePolicy):
    """Cohort scheduling (paper §5 comparison): no pool split, but heavy
    sections are batched back-to-back so frequency transitions (or, in
    serving, prefill/decode alternations) amortize over ``batch_n``
    items. Helps less than specialization — every unit still
    periodically runs heavy work — which is exactly the comparison the
    paper draws."""

    name = "cohort"

    def __init__(self, batch_n: int = 8):
        self.batch_n = batch_n

    def heavy_burst(self, topo: Topology, pool: Pool) -> int:
        return self.batch_n


@dataclass
class _ResizeState:
    proposal: Optional[int] = None      # pending size change
    streak: int = 0                     # consecutive windows proposing it
    ema_heavy: Optional[float] = None   # smoothed heavy work share


class AdaptivePolicy(Policy):
    """§4.3 adaptive specialization, wrapping the
    :class:`repro_torch.core.adaptive.AdaptivePolicy` estimator (previously
    wired to nothing).

    Scheduling behaviour delegates to an inner :class:`SpecializedPolicy`;
    ``resize`` sizes the heavy pool from the observed heavy share via the
    estimator's §2.1 rule, with two anti-flap measures: the share is
    EMA-smoothed over windows (windowed Poisson arrivals are bursty),
    and a new size is applied only when proposed in two consecutive
    windows (debounce).
    """

    name = "adaptive"

    def __init__(self, cfg: Optional[AdaptiveConfig] = None,
                 inner: Optional[Policy] = None, ema_alpha: float = 0.3):
        self.cfg = cfg or AdaptiveConfig()
        self.inner = inner or SpecializedPolicy()
        self.ema_alpha = ema_alpha
        self._resize = _ResizeState()
        self._estimator: Optional[AdaptiveEstimator] = None

    # behaviour delegates to the inner policy ---------------------------
    def placement(self, topo, kind):
        return self.inner.placement(topo, kind)

    def eligible(self, topo, pool, kind):
        return self.inner.eligible(topo, pool, kind)

    def queue_order(self, topo, pool):
        return self.inner.queue_order(topo, pool)

    def penalty(self, topo, pool):
        return self.inner.penalty(topo, pool)

    def on_type_change(self, topo, pool, new_kind):
        return self.inner.on_type_change(topo, pool, new_kind)

    # resizing ----------------------------------------------------------
    def _heavy_pool(self, topo: Topology) -> Optional[Pool]:
        dedicated = [p for p in topo.pools if p.can(WorkKind.HEAVY)
                     and len(topo.pools_with(WorkKind.HEAVY))
                     < len(topo.pools)]
        return dedicated[0] if dedicated else None

    def resize(self, topo: Topology, signals: LoadSignals
               ) -> Optional[Topology]:
        heavy = self._heavy_pool(topo)
        if heavy is None or len(topo.pools) != 2:
            return None
        st = self._resize
        if st.ema_heavy is None:
            st.ema_heavy = signals.heavy_share
        else:
            st.ema_heavy += self.ema_alpha * (signals.heavy_share
                                              - st.ema_heavy)
        n_units = topo.n_units
        if self._estimator is None or self._estimator.n_cores != n_units:
            self._estimator = AdaptiveEstimator(self.cfg, n_units)
        est = self._estimator
        est.state.n_avx_cores = heavy.n_units
        # size on the MEASURED license residency when the mechanism
        # reports one (the engine's per-pool frequency domains); fall
        # back to the heavy-share heuristic for domain-less mechanisms
        l2 = signals.license_residency \
            if signals.license_residency > 0.0 else signals.heavy_residency
        state = est.update(scalar_share=signals.light_share,
                           heavy_share=st.ema_heavy,
                           l2_residency=l2,
                           type_changes_per_s=signals.type_changes_per_s)
        if not state.enabled:
            # §4.3: cost exceeds benefit — fall back toward the minimal
            # pool (a two-pool topology cannot be unsplit in place)
            want = self.cfg.min_avx_cores
        else:
            want = state.n_avx_cores
        want = max(1, min(want, n_units - 1))
        if want == heavy.n_units:
            st.proposal, st.streak = None, 0
            return None
        if st.proposal != want:
            st.proposal, st.streak = want, 1
            return None
        st.streak += 1
        # dead-band against flapping on a size boundary: a >=2-unit
        # mismatch applies after the 2-window debounce; a 1-unit drift
        # must persist for 4 consecutive windows
        needed = 2 if abs(want - heavy.n_units) >= 2 else 4
        if st.streak < needed:
            return None
        st.proposal, st.streak = None, 0
        return topo.resized(heavy.name, want)


# ----------------------------------------------------- cluster policies


@dataclass(frozen=True)
class ShardView:
    """Read-only per-shard signals a :class:`ClusterPolicy` scores.

    Built by the cluster engine at every routing decision: backlog from
    the shard engine's queues, license residency and energy draw from
    the shard's per-window :class:`repro_torch.sched.freq.ResidencyWindow`
    deltas (the cluster-scale analogue of the per-core residency the
    paper's adaptive mechanism measures), and an instantaneous
    reduced-clock flag."""
    name: str
    n_units: int = 0
    heavy_units: int = 0
    queue_depth: int = 0              # waiting + active + in-flight
    admit_limit: int = 0              # router holds above this depth
    license_residency: float = 0.0    # last window, 0..1
    energy_rate: float = 0.0          # energy proxy per ms, last window
    reduced_now: bool = False         # any pool currently below L0
    failed: bool = False              # detected crash-stop (faults.py)


class ClusterPolicy:
    """Cluster-level decisions: *which shard* runs a request and *when*
    it is admitted, plus cross-shard resizing — the front-end analogue
    of :class:`Policy` one layer up. The paper's signal discipline is
    preserved: decisions are fed by MEASURED per-window frequency-domain
    deltas, never by static labels.

    ``shard_policy`` names the registered per-shard engine policy this
    cluster policy expects underneath it (the scheduling behaviour
    inside each shard)."""

    name = "cluster-base"
    shard_policy = "specialized"

    # Failure-handling knobs (sched/faults.py). A drained or dropped
    # request re-enters the router with its remaining deadline budget
    # after a capped exponential backoff; after ``max_attempts``
    # dispatches it is shed (never silently lost). When
    # ``hedge_on_brownout`` is set the router steers the EDF head away
    # from a browned-out shard whenever a healthy shard also admits it
    # (a placement hedge, not a duplicate dispatch — exactly-once
    # completion is preserved). ``shed_queue_factor`` bounds the router
    # backlog: above shed_queue_factor x total alive admit capacity the
    # router sheds lowest-SLO-class (largest deadline window) requests
    # first, accounted per tenant.
    max_attempts = 3
    retry_backoff_ms = 25.0
    retry_backoff_cap_ms = 400.0
    hedge_on_brownout = True
    shed_queue_factor = 4.0

    def admits(self, view: ShardView) -> bool:
        """Admission control: may the router dispatch to this shard
        now? Base rule: alive, and bounded per-shard backlog."""
        return (not view.failed) and view.queue_depth < view.admit_limit

    def place(self, views: Tuple[ShardView, ...], request
              ) -> Optional[str]:
        """Choose a shard for ``request`` among those that admit it, or
        None to hold it at the router (strict EDF head-of-line: later
        deadlines must not overtake). Default: least backlog,
        name-ordered tie-break — deterministic."""
        open_ = [v for v in views if self.admits(v)]
        if not open_:
            return None
        return min(open_, key=lambda v: (self.score(v, request),
                                         v.name)).name

    def score(self, view: ShardView, request) -> float:
        """Placement score (lower = better). Base: relative backlog."""
        return view.queue_depth / max(view.admit_limit, 1)

    def reshard(self, topologies: Dict[str, Topology],
                signals: Dict[str, LoadSignals]
                ) -> Dict[str, Topology]:
        """Cross-shard resize decisions, called once per cluster
        window with each shard's measured :class:`LoadSignals` (license
        residency included). Returns the shards to resize (empty dict =
        keep everything)."""
        return {}


class ClusterRoundRobinPolicy(ClusterPolicy):
    """Frequency-blind baseline: cycle through shards, skipping only
    shards that refuse admission. What a fleet balancer does when
    per-node frequency variation is invisible to it (Schuchart et
    al.'s problem statement)."""

    name = "cluster-rr"

    def __init__(self):
        self._next = 0

    def place(self, views, request):
        open_ = [v for v in views if self.admits(v)]
        if not open_:
            return None
        pick = views[self._next % len(views)]
        self._next += 1
        if self.admits(pick):
            return pick.name
        return min(open_, key=lambda v: v.name).name


class ClusterFreqAwarePolicy(ClusterPolicy):
    """Frequency-aware placement: score shards on backlog + measured
    license residency + energy draw. The residency penalty scales with
    the request's *heaviness* (prefill-dominated requests are the AVX
    analogue), so a shard stuck below L0 sheds heavy work first —
    exactly as the paper migrates AVX threads off scalar cores — and
    recovers once its hysteresis expires."""

    name = "cluster-freq"

    def __init__(self, w_freq: float = 1.5, w_energy: float = 0.1,
                 decode_token_cost: float = 8.0):
        self.w_freq = w_freq
        self.w_energy = w_energy
        # prompt tokens per decode token, cost-wise: used to estimate
        # how prefill-heavy a request is without consulting a PoolModel
        self.decode_token_cost = decode_token_cost

    def heaviness(self, request) -> float:
        """0..1 share of this request's cost that is heavy (prefill)."""
        heavy = float(request.prompt_len)
        light = self.decode_token_cost * float(request.max_new)
        return heavy / max(heavy + light, 1.0)

    def score(self, view: ShardView, request) -> float:
        depth = view.queue_depth / max(view.admit_limit, 1)
        h = self.heaviness(request)
        freq_pen = view.license_residency * (0.5 + h)
        if view.reduced_now:
            freq_pen += 0.25 * h      # currently below L0: shed heavy
        return depth + self.w_freq * freq_pen \
            + self.w_energy * view.energy_rate


class ClusterAdaptivePolicy(ClusterFreqAwarePolicy):
    """`AdaptivePolicy` promoted to cluster level: frequency-aware
    routing PLUS cross-shard resizing. Each shard's prefill/decode
    split is sized by its own §4.3 estimator (EMA + debounce, exactly
    the single-node :class:`AdaptivePolicy`), but driven centrally from
    the per-window :class:`LoadSignals` the cluster collects — shard
    engines themselves never resize in cluster mode."""

    name = "cluster-adaptive"

    def __init__(self, **kw):
        super().__init__(**kw)
        self._sizers: Dict[str, AdaptivePolicy] = {}

    def reshard(self, topologies, signals):
        out = {}
        for name in sorted(topologies):
            sig = signals.get(name)
            if sig is None:
                continue
            sizer = self._sizers.get(name)
            if sizer is None:
                sizer = self._sizers[name] = AdaptivePolicy()
            new = sizer.resize(topologies[name], sig)
            if new is not None:
                out[name] = new
        return out


# name -> zero-arg factory, mirroring the per-shard POLICIES registry.
CLUSTER_POLICIES: Dict[str, type] = {}


def register_cluster_policy(name: str, factory) -> None:
    CLUSTER_POLICIES[name] = factory


def make_cluster_policy(name: str) -> ClusterPolicy:
    try:
        return CLUSTER_POLICIES[name]()
    except KeyError:
        raise KeyError(f"unknown cluster policy {name!r}; "
                       f"registered: {sorted(CLUSTER_POLICIES)}") from None


def registered_cluster_policies() -> Tuple[str, ...]:
    return tuple(sorted(CLUSTER_POLICIES))


register_cluster_policy("cluster-rr", ClusterRoundRobinPolicy)
register_cluster_policy("cluster-queue", ClusterPolicy)
register_cluster_policy("cluster-freq", ClusterFreqAwarePolicy)
register_cluster_policy("cluster-adaptive", ClusterAdaptivePolicy)


# ------------------------------------------------------ policy registry

# name -> zero-arg factory. Factories (not instances) because policies
# may be stateful (AdaptivePolicy's EMA/debounce state): every replay
# must start from a fresh object or runs would contaminate each other.
POLICIES: Dict[str, type] = {}


def register_policy(name: str, factory) -> None:
    """Register a policy factory under ``name`` for the differential
    replay harness (`repro.sched.replay`) and any registry-driven
    consumer. Re-registering a name overwrites it (tests rely on this
    to inject instrumented policies)."""
    POLICIES[name] = factory


def make_policy(name: str) -> Policy:
    try:
        return POLICIES[name]()
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; "
                       f"registered: {sorted(POLICIES)}") from None


def registered_policies() -> Tuple[str, ...]:
    return tuple(sorted(POLICIES))


register_policy("shared", SharedBaselinePolicy)
register_policy("specialized", SpecializedPolicy)
register_policy("cohort", CohortPolicy)
register_policy("adaptive", AdaptivePolicy)
