"""Failure handling for the training loop, the port of
``repro.train.elastic``.

* ``elastic_restore`` — resume the latest checkpoint. Checkpoints hold
  host arrays and the data cursor is global, so a resume is placement
  only: here onto one device; restoring onto a mesh of another shape
  comes with distribution (ROADMAP).
* ``Watchdog`` — straggler/failure detection: a per-step deadline.
* ``install_preemption_handler`` — SIGTERM -> synchronous final
  checkpoint (preemptible-VM style clean exit).
"""
from __future__ import annotations

import signal
from typing import Callable, Optional

from repro_torch.bridge import flatten, unflatten
from repro_torch.train.checkpoint import CheckpointManager


def elastic_restore(ckpt: CheckpointManager, like_state, device):
    """Restore the latest checkpoint into ``like_state``'s structure and
    place it on ``device``: (state, meta). The parameters come back as
    leaves that require grad where ``like_state``'s do."""
    host_state, meta = ckpt.restore(like_state)
    like = flatten(like_state)
    placed = {k: v.to(device).requires_grad_(like[k].requires_grad)
              for k, v in flatten(host_state).items()}
    return unflatten(placed), meta


class Watchdog:
    """Per-step deadline; trips when a step exceeds `factor` x the rolling
    median (straggler) or `hard_s` (hang)."""

    def __init__(self, factor: float = 3.0, hard_s: float = 600.0,
                 warmup: int = 3):
        self.factor = factor
        self.hard_s = hard_s
        self.warmup = warmup
        self.history = []

    def observe(self, step_s: float) -> Optional[str]:
        self.history.append(step_s)
        if step_s > self.hard_s:
            return "hang"
        if len(self.history) > self.warmup:
            med = sorted(self.history[:-1])[len(self.history[:-1]) // 2]
            if step_s > self.factor * med:
                return "straggler"
        return None


def install_preemption_handler(on_preempt: Callable[[], None]):
    """SIGTERM -> checkpoint-and-exit (returns the previous handler)."""
    prev = signal.getsignal(signal.SIGTERM)

    def handler(signum, frame):
        on_preempt()
        if callable(prev):
            prev(signum, frame)

    signal.signal(signal.SIGTERM, handler)
    return prev
