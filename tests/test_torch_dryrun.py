"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch.perf``) on
fake worlds: the reference's four family cells traced on the (2, 4) test
mesh at published width and cut depth, held to the reference's
``run_cell`` on its Auto (2, 4) mesh; the reference's override tests;
the CLIs. What the trace counts: ``test_torch_dryrun_counts.py``."""
import json

import numpy as np
import pytest

from helpers import run_with_devices
from repro_torch.launch import dryrun, perf

# the reference test's cells, one a family and entry kind, at cut depth
# (zamba2 at one group of its six-layer period: the reference's hybrid
# refuses 2 layers)
CELLS = [("qwen1.5-0.5b", "train_4k", {"n_layers": 2}),
         ("rwkv6-3b", "decode_32k", {"n_layers": 2}),
         ("zamba2-2.7b", "long_500k", {"n_layers": 6}),
         ("whisper-large-v3", "prefill_32k", {"n_layers": 2})]

REF = """
import json
import jax
from jax.sharding import AxisType
from repro.launch import dryrun
# an Auto mesh: jax 0.9's make_mesh gives Explicit axes, which the
# reference's sharding constraints refuse
dryrun._mesh = lambda kind: jax.make_mesh(
    (2, 4), ('data', 'model'), axis_types=(AxisType.Auto,) * 2)
out = {}
for arch, shape, over in CELLS:
    r = dryrun.run_cell(arch, shape, 'test', overrides=over)
    out[arch] = {k: r.get(k) for k in ('status', 'error', 'memory',
                                       'roofline')}
print('RESULT ' + json.dumps(out))
"""


@pytest.fixture(scope="module")
def port_cells():
    return {arch: dryrun.run_cell(arch, shape, "test", overrides=over)
            for arch, shape, over in CELLS}


@pytest.fixture(scope="module")
def ref_cells():
    out = run_with_devices(f"CELLS = {CELLS!r}\n" + REF, n_devices=8,
                           timeout=600)
    line = next(x for x in out.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("arch", [c[0] for c in CELLS])
def test_family_cells_trace_on_the_fake_test_mesh(port_cells, arch):
    res = port_cells[arch]
    assert res["status"] == "ok", (res.get("error"), res.get("trace"))
    r = res["roofline"]
    assert r["hlo_gflops"] > 0 and r["hlo_gbytes"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert res["chips"] == 8 and res["device"] == "cuda"
    assert set(res["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert res["collectives"]["coll_counts"]      # gathered on use
    assert res["flop_counter"]["flops"] > 0


@pytest.mark.parametrize("arch", [c[0] for c in CELLS])
def test_cells_hold_to_the_reference(port_cells, ref_cells, arch):
    """Against the reference's ``run_cell`` on its Auto (2, 4) mesh: the
    analytic terms equal; this rank's arguments within 0.1% (rwkv6-3b's
    decode differs by its ``lengths``, 256 bytes a rank, which RWKV6's
    decode never reads and ``jax.jit`` drops from the program's
    arguments); the traced flops per rank within [0.5, 2] of the
    compiled program's once divided by ``replicas``, the ranks that
    compute the same rows (under gather on use the other families'
    ``model`` axis; the reference splits their rows over ``model`` too,
    and the transformer family's the port does too). A lost layer or
    microbatch would halve the ratio."""
    port, ref = port_cells[arch], ref_cells[arch]
    assert ref["status"] == "ok", ref.get("error")
    for k in ("model_gflops_total", "floor_gbytes"):
        assert port["roofline"][k] == pytest.approx(ref["roofline"][k],
                                                    rel=1e-12), k
    a, b = (x["memory"]["argument_size_in_bytes"] for x in (port, ref))
    assert abs(a - b) <= 1e-3 * b, (a, b)
    ratio = port["roofline"]["hlo_gflops"] / ref["roofline"]["hlo_gflops"]
    assert 0.5 <= ratio / port["replicas"] <= 2.0, (ratio, port["replicas"])


def test_replicated_serving_weights_cut_wire_bytes():
    """``fsdp: False`` (the perf variant ``serve_replicated``) removes the
    weight gathers of qwen1.5-0.5b's decode."""
    base = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", "test")
    opt = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", "test",
                          overrides={"fsdp": False})
    assert base["status"] == opt["status"] == "ok"
    assert opt["collectives"]["total_wire"] < base["collectives"]["total_wire"]


def test_zero1_override_traces():
    """ZeRO-1 without FSDP (the perf variants ``zero1``), on qwen1.5-0.5b
    at 2 layers (the reference's case, rwkv6-3b, traces its 128 WKV blocks
    a layer: about 50 s here)."""
    res = dryrun.run_cell("qwen1.5-0.5b", "train_4k", "test",
                          overrides={"zero1": True, "fsdp": False,
                                     "n_layers": 2})
    assert res["status"] == "ok", res.get("error")
    assert res["collectives"]["coll_counts"].get("all-reduce", 0) > 0


def test_seq_parallel_cell_is_ok_and_shows_the_sequence_collectives(
        port_cells):
    """qwen1.5-0.5b's train_4k at 2 layers under ``seq_parallel`` traces
    ``ok``; against the same cell without it (``port_cells``), each block's
    all-reduce exit becomes a reduce-scatter over the sequence and its
    entry an all-gather, and the temporaries fall."""
    res = dryrun.run_cell("qwen1.5-0.5b", "train_4k", "test",
                          overrides={"n_layers": 2, "seq_parallel": True})
    assert res["status"] == "ok", (res.get("error"), res.get("trace"))
    base = port_cells["qwen1.5-0.5b"]["collectives"]["coll_counts"]
    got = res["collectives"]["coll_counts"]
    assert got.get("all-reduce", 0) < base.get("all-reduce", 0)
    assert got["reduce-scatter"] > base["reduce-scatter"]
    assert got["all-gather"] > base["all-gather"]
    assert res["memory"]["temp_size_in_bytes"] < port_cells[
        "qwen1.5-0.5b"]["memory"]["temp_size_in_bytes"]


def test_the_clis_record_and_skip_cached_cells(tmp_path, capsys):
    out = tmp_path / "d.json"
    argv = ["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--mesh",
            "test", "--out", str(out)]
    assert dryrun.main(argv) == 0
    assert "1/1 cells ok" in capsys.readouterr().out
    assert json.loads(out.read_text())[
        "qwen1.5-0.5b|decode_32k|test"]["status"] == "ok"
    dryrun.main(argv)
    assert "[skip cached]" in capsys.readouterr().out
    pout = tmp_path / "p.json"
    perf.main(["--cell", "chameleon_decode", "--mesh", "test", "--out",
               str(pout)])
    res = json.loads(pout.read_text())
    assert {v["variant"] for v in res.values()} == {"baseline",
                                                    "serve_replicated"}
    assert all(v["status"] == "ok" for v in res.values())
    assert np.isfinite(res["chameleon_decode|baseline|test"]["roofline"][
        "step_s"])
