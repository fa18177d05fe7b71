"""Quickstart: train a small LM end to end with checkpoint/resume (port of
``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
  PYTHONPATH=src python -m repro_torch.examples.quickstart --full

The default trains the reduced qwen1.5-0.5b for 200 steps; ``--full``
trains qwen1.5-0.5b's published width at 4 layers (about 105M params) for
300 steps. Checkpoints go under ``build/`` at the repository root (which
git ignores): run it again to resume. It runs on the card by default
(``--device cuda``; it raises without a GPU unless ``--device cpu`` is
given).
"""
from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch.launch.train import main as train_main

CKPT = Path(__file__).resolve().parents[3] / "build" / "quickstart"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = ["--device", args.device]
    if args.full:
        # qwen1.5-0.5b width with 4 layers ~ 105M non-embedding+embedding
        return train_main(["--arch", "qwen1.5-0.5b", "--steps", "300",
                           "--n-layers", "4", "--data-order", "1",
                           "--batch", "4", "--seq", "512", "--grad-accum",
                           "2", "--lr", "1e-2",
                           "--ckpt-dir", str(CKPT / "full"),
                           "--ckpt-every", "50", *dev])
    return train_main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps",
                       "200", "--batch", "8", "--seq", "128", "--lr", "1e-2",
                       "--data-order", "1",
                       "--ckpt-dir", str(CKPT / "reduced"),
                       "--ckpt-every", "50", *dev])


if __name__ == "__main__":
    main()
