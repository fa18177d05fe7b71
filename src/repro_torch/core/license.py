"""Per-core power-license view over the unified frequency-domain layer.

The license state machine itself now lives in
:mod:`repro_torch.sched.freq` (:class:`FrequencyDomain`) — ONE implementation
drives both the OS simulator (per-core, µs time base) and the serving
engine (per-pool, ms time base). This module keeps the paper-facing
surface:

  * :class:`LicenseConfig` — the µs-named knobs (grant window <= 500 µs,
    ~2 ms revert hysteresis, ~100-instruction detection delay) from
    paper §2/Fig. 1, with ``domain_config()`` mapping onto the generic
    :class:`repro_torch.sched.freq.FreqDomainConfig`;
  * ``LEVEL_OF`` — the instruction-class -> license-level mapping
    (SCALAR -> L0, heavy AVX2 -> L1, heavy AVX-512 -> L2; Xeon Gold
    6130 all-core turbo 2.8 / 2.4 / 1.9 GHz, paper §2/§4);
  * :class:`CoreLicense` — a :class:`FrequencyDomain` whose ``execute``
    speaks :class:`repro_torch.core.task.IClass` instead of raw level ints.

All times in µs, frequencies in GHz (cycles/µs = GHz * 1000).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.core.task import IClass
from repro_torch.sched.freq import FreqDomainConfig, FrequencyDomain


@dataclass(frozen=True)
class LicenseConfig:
    freqs_ghz: Tuple[float, float, float] = (2.8, 2.4, 1.9)
    grant_delay_us: float = 500.0          # PCU evaluation window (<= 500)
    hysteresis_us: float = 2_000.0         # revert delay after last heavy op
    detect_delay_us: float = 0.035         # ~100 instructions @ ~2.8 GHz
    throttle_factor: float = 0.75          # x target freq during request
    #   (§2/Fig.1: "executes at reduced performance while requesting")

    def domain_config(self) -> FreqDomainConfig:
        """The equivalent generic frequency-domain parameters (µs time
        base, 1000 cycles per µs per GHz)."""
        return FreqDomainConfig(
            freqs_ghz=tuple(self.freqs_ghz),
            grant_delay=self.grant_delay_us,
            hysteresis=self.hysteresis_us,
            detect_delay=self.detect_delay_us,
            throttle_factor=self.throttle_factor,
            cycles_per_ghz=1000.0,
            time_unit="us")


LEVEL_OF = {IClass.SCALAR: 0, IClass.AVX2: 1, IClass.AVX512: 2}


class CoreLicense(FrequencyDomain):
    """A per-core frequency domain addressed by instruction class."""

    def __init__(self, cfg: LicenseConfig = LicenseConfig(),
                 record: bool = False):
        super().__init__(cfg.domain_config(), record=record)

    def execute(self, t: float, cycles: float, iclass: IClass,
                dense: bool) -> float:
        """Run `cycles` nominal cycles starting at t; returns end time
        and updates license state + counters."""
        return super().execute(t, cycles, LEVEL_OF[iclass], dense)
