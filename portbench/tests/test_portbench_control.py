"""The control at a size a test run holds: the port served in bf16 on the
CPU at its reduced configurations, and the reference put in its place in
fp8. The gap of the control's first choices has to stand well clear of
the program's widest gap (at the cells' own sizes on the chip,
``portbench/control.py`` reads both; PERF.md has the readings), so that a
limit between them passes the program and fails the control."""
import json
import math

import pytest

import tiny
from portbench import control


@pytest.fixture(scope="module")
def bf16_copy(tmp_path_factory):
    root = tiny.make(tmp_path_factory.mktemp("bf16"), dtype="bfloat16",
                     prompt=48, out_lo=8, out_hi=17)
    # the reduced model is fast: a load that finishes enough requests
    for f in (root / "portbench" / "workloads").glob("*.json"):
        mix = json.loads(f.read_text())
        mix["arrivals"] = {"kind": "poisson", "rate_per_s": 5.0}
        f.write_text(json.dumps(mix))
    return root


@pytest.mark.parametrize("cell", ["stablelm-12b.chat",
                                  "stablelm-12b.long-prompt"])
def test_the_control_fails_a_limit_the_program_passes(bf16_copy, cell):
    rows = control.readings(cell, [11, 12, 13], 3, 4.0, device="cpu",
                            root=bf16_copy)
    program = max(r["gap"] for r in rows)
    ctrl = min(r["control_gap"] for r in rows)
    assert all(r["tokens"] >= 40 for r in rows)
    assert ctrl >= 3 * program, (program, ctrl)
    limit = math.sqrt(program * ctrl)
    assert all(r["gap"] <= limit < r["control_gap"] for r in rows)
