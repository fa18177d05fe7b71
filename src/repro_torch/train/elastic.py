"""Failure handling for the training loop, the port of
``repro.train.elastic``.

* ``elastic_restore`` — resume the latest checkpoint onto any mesh:
  checkpoints hold full host arrays (mesh-agnostic; a sharded state is
  gathered before it is saved, ``train.loop.gather_train_state``) and the
  data cursor is global, so a rescale is placement only: each rank keeps
  its shards of the mesh it is given, whatever mesh wrote the file.
* ``Watchdog`` — straggler/failure detection: a per-step deadline.
* ``install_preemption_handler`` — SIGTERM -> synchronous final
  checkpoint (preemptible-VM style clean exit).
"""
from __future__ import annotations

import signal
from typing import Callable, Optional

from repro_torch.bridge import flatten, unflatten
from repro_torch.dist.context import DistContext
from repro_torch.dist.sharding import map_with_specs, shard, tree_shardings
from repro_torch.train.checkpoint import CheckpointManager


def elastic_restore(ckpt: CheckpointManager, like_state,
                    new_dist: DistContext, state_specs=None, device=None):
    """Restore the latest checkpoint into ``like_state``'s structure (full
    shapes and dtypes; meta tensors will do) and place it: (state, meta).
    On an active ``new_dist`` each rank keeps its shards under
    ``state_specs`` (``train.loop.train_state_specs``), on the mesh's
    device; without one the full state goes to ``device``, which must be
    named, its leaves requiring grad where ``like_state``'s do."""
    if not new_dist.active and device is None:
        raise ValueError("elastic_restore without a mesh needs a device")
    host_state, meta = ckpt.restore(like_state)
    if not new_dist.active:
        like = flatten(like_state)
        placed = {k: v.to(device).requires_grad_(like[k].requires_grad)
                  for k, v in flatten(host_state).items()}
        return unflatten(placed), meta
    dev = new_dist.mesh.device
    placed = map_with_specs(
        lambda a, pl: shard(a, pl).to(dev, copy=True), host_state,
        tree_shardings(new_dist, like_state, state_specs))
    return placed, meta


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
