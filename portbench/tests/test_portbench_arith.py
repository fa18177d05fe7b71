"""The yardstick's arithmetic: the traffic generator, the operations and
bytes of each configuration's calls, the kernels' costs."""
import json
from collections import Counter

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tiny import ROOT, reduced_model
from portbench import arith, traffic, weights
from portbench.counts import dense_gqa as count_dense
from portbench.reference import dense_gqa

CELLS = sorted(p.stem for p in (ROOT / "portbench" / "workloads").glob(
    "*.json"))


def mix(cell):
    return json.loads((ROOT / "portbench" / "workloads"
                       / f"{cell}.json").read_text())


@pytest.mark.parametrize("cell", CELLS)
def test_one_seed_gives_the_same_trace(cell):
    a = traffic.requests(mix(cell), 2 ** 31 + 11)
    b = traffic.requests(mix(cell), 2 ** 31 + 11)
    assert a == b and len(a) > 100
    # blocks of one: every seed offers one trace, in one order
    other = traffic.requests(mix(cell), 2 ** 31 + 12)
    assert (a == other) is (mix(cell)["block"] == 1)


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_gets_the_same_work(cell):
    """Each block holds the same gaps and output lengths whatever the
    seed: only their order moves."""
    mx = mix(cell)
    runs = [traffic.requests(mx, s) for s in (1, 2 ** 33 + 5, 987654321)]
    n = min(len(r) for r in runs)
    # only the horizon's last on/off cycle, cut short, may move
    assert max(len(r) for r in runs) - n <= 0.01 * n
    blk = mx["block"]
    cut = n - n % blk
    for r in runs[1:]:
        for i in range(0, cut, blk):
            assert Counter(x[1] for x in r[i:i + blk]) == \
                Counter(x[1] for x in runs[0][i:i + blk])
            if mx["arrivals"]["kind"] == "poisson":
                assert abs(r[i + blk - 1][0] - runs[0][i + blk - 1][0]) \
                    < 1e-3


def test_mmpp_phases_are_the_times_of_the_frozen_copy():
    import numpy as np
    p = traffic.MMPPArrivals(4.0, 1.0, 2000.0, 2000.0)
    times = p.times(60_000.0, np.random.default_rng(3))
    ph = p.phases(60_000.0, np.random.default_rng(3))
    t, flat = 0.0, []
    for length, offs in ph:
        flat.extend(t + o for o in offs)
        t += length
    assert flat == times


def test_the_frozen_copies_are_the_programs():
    """The generators give what ``repro_torch.sched.workload``'s give for
    one stream of draws (the copies stay as they were taken)."""
    import numpy as np
    from repro_torch.sched import workload as w
    for ours, theirs, args in (
            (traffic.PoissonArrivals, w.PoissonArrivals, (3.0,)),
            (traffic.MMPPArrivals, w.MMPPArrivals, (4.0, 1.0, 2e3, 2e3))):
        assert ours(*args).times(30e3, np.random.default_rng(5)) == \
            theirs(*args).times(30e3, np.random.default_rng(5))
    for ours, theirs, args in ((traffic.UniformLen, w.UniformLen, (2, 9)),
                               (traffic.LognormalLen, w.LognormalLen, (64,)),
                               (traffic.ZipfLen, w.ZipfLen, ())):
        r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
        assert [ours(*args).sample(r1) for _ in range(50)] == \
            [theirs(*args).sample(r2) for _ in range(50)]


def _port(arch):
    from repro_torch.models.api import build_model
    from portbench.harness import arch_config
    m = reduced_model(arch)
    model = build_model(arch_config(m), "cpu")
    ref = {"stablelm-12b": dense_gqa}[arch]
    p = weights.make(ref.param_draws(m), m["param_dtype"],
                     torch.Generator().manual_seed(0), "cpu")
    return m, model, p


def _attention_core(m, S, n_calls):
    """The attention products inside the ``flash_attention`` op (which a
    FlopCounterMode cannot see into), over all S x S pairs."""
    hd = m["head_dim"] or m["d_model"] // m["n_heads"]
    return n_calls * 4.0 * m["n_heads"] * S * S * hd


@pytest.mark.parametrize("arch,counts", [("stablelm-12b", count_dense)])
@pytest.mark.parametrize("S", [40, 64])
def test_counts_agree_with_the_flop_counter(arch, counts, S):
    """The counts against ``FlopCounterMode`` over the port's own calls,
    exact (margin 1e-9) once the two known differences are put back: the
    attention inside the custom op, which the counter does not see, and
    the masked halves (causal pairs) the equations compute and the counts
    leave out."""
    m, model, p = _port(arch)
    toks = torch.randint(0, m["vocab"], (1, S))
    cache = model.init_cache(p, {"tokens": toks}, 1, S + 2)
    with FlopCounterMode(display=False) as fc:
        lg, cache = model.prefill(p, {"tokens": toks}, cache)
    n_att = counts.attention_calls(m)
    want = counts.prefill_flops(m, S, causal_half=False) \
        - _attention_core(m, S, n_att)
    assert fc.get_total_flops() == pytest.approx(want, rel=1e-9)
    assert counts.prefill_flops(m, S) < counts.prefill_flops(
        m, S, causal_half=False)
    with FlopCounterMode(display=False) as fc:
        model.decode_step(p, cache, lg.argmax(-1)[:, None],
                          torch.full((1,), S, dtype=torch.int32))
    hd = m["head_dim"] or m["d_model"] // m["n_heads"]
    core = n_att * 4.0 * m["n_heads"] * (S + 1) * hd
    assert fc.get_total_flops() == pytest.approx(
        counts.decode_flops(m, S + 1) - core, rel=1e-9)


@pytest.mark.parametrize("arch,counts", [("stablelm-12b", count_dense)])
def test_weight_bytes_are_the_weights_but_the_table(arch, counts):
    m, model, p = _port(arch)
    table = p["embed"].numel() * p["embed"].element_size()
    assert counts.weight_bytes(m) == weights.nbytes(p) - table


@pytest.mark.parametrize("name", ["stablelm-12b"])
def test_full_size_counts(name):
    """At the published sizes: the weights' bytes, and a prefill against
    2 x params x tokens (the products beside the weights add a little)."""
    conf = json.loads((ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())
    m = conf["model"]
    counts = {"dense_gqa": count_dense}[conf["counts"]]
    ref = {"dense_gqa": dense_gqa}[conf["reference"]]
    draws = ref.param_draws(m)
    assert weights.count(draws) == conf["params"]
    S = 512
    dense_part = 2.0 * S * (conf["params"] - 2 * m["vocab"] * m["d_model"])
    f = counts.prefill_flops(m, S)
    assert dense_part < f < 1.3 * dense_part


def test_kernel_costs():
    f, b = arith.flash_attention_cost(1, 32, 8, 2048, 2048, 160, 160, True)
    assert f == 2.0 * 32 * (2048 * 2049 / 2) * 320
    assert b == 2 * (2 * 32 * 2048 * 160 + 8 * 2048 * 320)
    f2, _ = arith.flash_attention_cost(1, 32, 8, 2048, 2048, 160, 160, False)
    assert f2 == 2.0 * 32 * 2048 * 2048 * 320
    f, b = arith.flash_decode_cost(1, 32, 8, 300, 160)
    assert f == 4.0 * 32 * 300 * 160
    assert b == 2 * (2 * 32 * 160 + 2 * 8 * 300 * 160) + 4
    assert arith.least_s(989e12, 0) == 1.0
    assert arith.least_s(0, 3.35e12) == 1.0
