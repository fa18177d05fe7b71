"""What the dry-run's trace counts (``repro_torch.launch.dryrun``): each
layer once (flops linear in depth), each microbatch once (the traces at
two and three microbatches extended to four equal the trace of all
four), and on a fake world the same as a real one (the counter over a
fake trace of (2, 4) against the same counter over 8 gloo ranks running
the same steps)."""
import dataclasses

import pytest

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from torch_dist_ranks import launch


def _totals(tr):
    return dict(tr.totals.to_dict(), counter=tr.counter_flops,
                peak=tr.peak_bytes)


def _assert_close(a: dict, b: dict, rel=1e-9):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_close(a[k], b[k], rel)
        else:
            assert a[k] == pytest.approx(b[k], rel=rel), k


def _linear(f2, f3, f4):
    """f4 - f3 == f3 - f2, key by key (the peak aside)."""
    for k in f2:
        if isinstance(f2[k], dict):
            _linear(f2[k], f3[k], f4[k])
        elif k != "peak":
            assert f4[k] - f3[k] == pytest.approx(f3[k] - f2[k], rel=1e-9), k


def test_flops_are_linear_in_depth():
    """Each layer counted once: qwen1.5-0.5b's prefill_32k on the test
    mesh, and a train step of its reduced width, at 2, 3 and 4 layers
    add the same costs a layer."""
    pre = [dryrun.run_cell("qwen1.5-0.5b", "prefill_32k", "test",
                           overrides={"n_layers": n}) for n in (2, 3, 4)]
    f = [p["roofline"]["hlo_gflops"] for p in pre]
    assert f[2] - f[1] == pytest.approx(f[1] - f[0], rel=1e-9)
    assert f[1] > f[0] > 0
    base = get_arch("qwen1.5-0.5b").reduced()
    shape = ShapeConfig("t", 64, 16, "train")
    tr = [_totals(dryrun.trace_cell(dataclasses.replace(base, n_layers=n),
                                    shape, "test", grad_accum=2,
                                    device="cpu")[0]) for n in (2, 3, 4)]
    _linear(*tr)
    assert tr[1]["flops"] > tr[0]["flops"]


@pytest.mark.parametrize("ga", [2, 4])
def test_traced_microbatches_equal_every_microbatch(ga, monkeypatch):
    """The train trace at ``grad_accum`` 2 and 4 (above 3 extended from
    the traces at 2 and 3) equals the trace that runs every microbatch:
    the same costs, collectives, second count and peak."""
    cfg = get_arch("qwen1.5-0.5b").reduced()
    shape = ShapeConfig("t", 64, 16, "train")
    got = _totals(dryrun.trace_cell(cfg, shape, "test", grad_accum=ga,
                                    device="cpu")[0])

    def every(model, opt_cfg, n, specs, state, batch):
        step = dryrun.make_train_step(model, opt_cfg, grad_accum=n,
                                      batch_specs=specs)
        return dryrun._run(step, state, batch)
    monkeypatch.setattr(dryrun, "_train_trace", every)
    want = _totals(dryrun.trace_cell(cfg, shape, "test", grad_accum=ga,
                                     device="cpu")[0])
    _assert_close(got, want)


def test_fake_trace_counts_equal_a_real_gloo_run(tmp_path):
    """The reduced qwen1.5-0.5b's train step (grad_accum 2) and decode
    step on (2, 4): the fake trace's flops, bytes, collective counts and
    wire bytes by group are those of the same counter over 8 real gloo
    ranks running the same steps."""
    shapes = {"train": (64, 8), "decode": (32, 8)}
    ranks = launch("count", 8, tmp_path, timeout=180, arch="qwen1.5-0.5b",
                   shapes=shapes, grad_accum=2)
    cfg = get_arch("qwen1.5-0.5b").reduced()
    for kind, (S, B) in shapes.items():
        t = dryrun.trace_cell(cfg, ShapeConfig(kind, S, B, kind), "test",
                              grad_accum=2, device="cpu")[0].totals.to_dict()
        want = {f"{kind}/flops": t["flops"], f"{kind}/bytes": t["bytes"],
                **{f"{kind}/{f}/{k}": v for f in ("coll_counts", "coll_wire",
                                                   "wire_by_group")
                   for k, v in t[f].items()}}
        for r, got in enumerate(ranks):
            have = {k: float(v) for k, v in got.items()
                    if k.startswith(kind + "/")}
            assert have.keys() == want.keys(), r
            for k, v in want.items():
                assert have[k] == pytest.approx(v, rel=1e-9), (r, k)
