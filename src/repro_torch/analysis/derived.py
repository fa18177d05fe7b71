"""Loader for the calibration artifact (``derived.json``).

The port's own copy of the reference's pure-stdlib loader. ``derived.json``
beside it is a byte-identical copy of the artifact the reference's
calibration writes (``python -m repro.analysis.calibrate --update`` in the
JAX package); the serve path reads its heavy-phase tags and frequency
levels from here, so the port never imports the JAX package.
"""
from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, List

DERIVED_PATH = Path(__file__).with_name("derived.json")


@lru_cache(maxsize=1)
def load() -> Dict:
    """The full artifact as a dict (cached; empty dict if missing so
    consumers can fall back to hand-tuned defaults)."""
    try:
        return json.loads(DERIVED_PATH.read_text())
    except FileNotFoundError:
        return {}


def workloads() -> Dict[str, Dict]:
    return load().get("workloads", {})


def workload_ids() -> List[str]:
    return sorted(workloads())


def scenario_params(arch: str) -> Dict:
    """Arrival/length/sim_work parameters derived for one architecture."""
    return workloads()[arch]["scenario"]


def heavy_tags(arch: str) -> List[str]:
    """Analyzer-derived heavy entrypoint names for one architecture."""
    return list(workloads()[arch]["tags"])


def freq_levels_ghz(arch: str) -> List[float]:
    """Derived (f0, f1, f2) for one architecture's frequency domain."""
    return list(workloads()[arch]["freq"]["levels_ghz"])
