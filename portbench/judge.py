"""Whether the timed path served the right tokens.

After the window has closed and the program's state is freed, a sample
of the requests the window finished, drawn from the seed and always with
the one that served the most tokens, is run through the plain fp32
reference once, each over its prompt and its served tokens. For every
served token the reference's logits at the position that produced it
give the gap by which that token's logit lies below the reference's best:
0 where the program chose the reference's own argmax. The number compared
is the widest gap of the sample.

The control puts the reference itself in the program's place, computed
in fp8: every dense projection of the layers takes its inputs rounded to
float8 e4m3 (weights scaled per output column, activations per row, the
products accumulated in fp32), the step below the bf16 that the
configuration states. At each position of the same prompts and tokens,
its first choice is read against the fp32 reference's logits in the same
way.
"""
from __future__ import annotations

import numpy as np
import torch

FP8_MAX = 448.0


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., k] @ w [k, n] with both rounded to float8 e4m3 under a
    per-row (x) and per-column (w) scale, products in fp32."""
    sw = w.abs().amax(0, keepdim=True).clamp_min(1e-30) / FP8_MAX
    sx = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    wq = (w / sw).to(torch.float8_e4m3fn).float() * sw
    xq = (x / sx).to(torch.float8_e4m3fn).float() * sx
    return xq @ wq


def sample(served: dict, target: int, words: list) -> list:
    """Request ids to judge: the one with the most served tokens, then
    others in an order drawn from ``words`` until ``target`` tokens."""
    rids = sorted(served)
    if not rids:
        return []
    longest = max(rids, key=lambda r: (len(served[r]), -r))
    rng = np.random.default_rng(words)
    order = [longest] + [rids[i] for i in rng.permutation(len(rids))
                         if rids[i] != longest]
    out, n = [], 0
    for r in order:
        if n >= target:
            break
        out.append(r)
        n += len(served[r])
    return out


def check(serving, run, seed: int, control: bool = False) -> dict:
    """``{"requests", "tokens", "gap", "failed"}`` (and ``"control_gap"``
    with ``control``) of ``run``'s served tokens on ``serving``'s weights."""
    from portbench.harness import seed_words
    served, feed = run.served, run.feed
    chk = run.mix["check"]
    picked = sample(served, int(chk["tokens"]), seed_words(seed, 3))
    out = {"requests": len(picked), "tokens": 0, "gap": None, "failed": 0}
    if not picked:
        return out
    P, V, dev = run.prompt, serving.cfg.vocab, serving.device
    seqs, rows, toks = [], [], []
    for r in picked:
        t = served[r]
        prompt = feed.prompt(r, V, P).tolist()
        seqs.append(torch.tensor(prompt + t[:-1], dtype=torch.long,
                                 device=dev))
        rows.append(torch.arange(P - 1, P - 1 + len(t), device=dev))
        toks.append(torch.tensor(t, dtype=torch.long, device=dev))
    with torch.no_grad():
        ref = serving.ref.logits(serving.params, serving.m, seqs, rows)
        gaps = [(lg.amax(-1) - lg.gather(-1, tk[:, None])[:, 0])
                for lg, tk in zip(ref, toks)]
        out["tokens"] = sum(len(t) for t in toks)
        out["gap"] = max(float(g.max()) for g in gaps)
        out["failed"] = sum(int(float(g.max()) > float(chk["gap_limit"]))
                            for g in gaps)
        if control:
            low = serving.ref.logits(serving.params, serving.m, seqs, rows,
                                     mm=fp8_mm)
            out["control_gap"] = max(
                float((lg.amax(-1) - lg.gather(-1, lo.argmax(-1)[:, None])
                       [:, 0]).max()) for lg, lo in zip(ref, low))
    return out
