"""Fault-tolerant checkpoints, the port of ``repro.train.checkpoint``:
atomic writes, async save, keep-N garbage collection, full-state restore.

The layout is the reference's, so either package reads the other's:

    <dir>/step_<N>/   arrays.npz   (flat {"/"-joined path: array})
                      meta.json    (step, time, data cursor, ...)
    <dir>/step_<N>.tmp.*          (staging; renamed atomically)

numpy has no bfloat16. A bf16 leaf is written as the reference's numpy
writes an ``ml_dtypes`` bfloat16 array: two raw bytes an element (``|V2``),
the same bits. Restoring into a bf16 leaf reinterprets such an array's
bits, with no ``ml_dtypes``; so the port reads the reference's bf16 files,
which the reference's own restore cannot (its ``astype`` has no cast from
``|V2``, ROADMAP §3).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import flatten, unflatten

def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _restore_leaf(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.asarray(arr, np.float32)).to(
            torch.bfloat16)
    return torch.from_numpy(arr.astype(
        torch.empty(0, dtype=like.dtype).numpy().dtype))


def _unflatten_like(like, flat: Dict[str, np.ndarray]):
    out = {}
    for key, leaf in flatten(like).items():
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        out[key] = _restore_leaf(arr, leaf)
    return unflatten(out)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save

    def save(self, step: int, state, meta: Optional[Dict[str, Any]] = None):
        """Atomic (tmp + rename) snapshot of a nested dict of tensors;
        async by default."""
        self.wait()                    # one in-flight save at a time
        # copy to the host synchronously (cheap vs serialization)
        flat = {k: _to_numpy(v) for k, v in flatten(state).items()}
        meta = dict(meta or {})
        meta["step"] = step
        meta["time"] = time.time()

        def _write():
            try:
                tmp = self.dir / f"step_{step}.tmp.{os.getpid()}"
                tmp.mkdir(parents=True, exist_ok=True)
                np.savez(tmp / "arrays.npz", **flat)
                (tmp / "meta.json").write_text(json.dumps(meta))
                final = self.dir / f"step_{step}"
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            self._raise_if_failed()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
        # stale tmp dirs from crashed saves
        for p in self.dir.glob("step_*.tmp.*"):
            shutil.rmtree(p, ignore_errors=True)

    # ---------------------------------------------------------- restore

    def steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and ".tmp." not in p.name:
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like_state, step: Optional[int] = None
                ) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure, shapes and dtypes of ``like_state``
        (a nested dict of tensors, on any device, ``meta`` included); the
        tensors come back on the CPU. Returns (state, meta)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        with np.load(d / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        meta = json.loads((d / "meta.json").read_text())
        return _unflatten_like(like_state, flat), meta
