"""The zamba2-2.7b configuration's pieces on the CPU: its reference's
parameter layout against the program's, the fp8 control, the readers of
the hybrid's spans, and a profiled run of its cell in a CPU copy of the
benchmark, with the published block at a tiny size."""
import json
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tiny
from tiny import ROOT, reduced_model
from portbench import judge, weights
from portbench.harness import Bench, arch_config
from portbench.reference import zamba2_hybrid as ref
from portbench.run import run_cell
from repro_torch import obs

CELL = "zamba2-2.7b.chat"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ("model.prefill_mamba_host_us", "model.prefill_shared_host_us",
           "model.prefill_ssd_share")


def published_model(dtype: str = "float32") -> dict:
    """The configuration's model at a tiny size: every key of the file,
    the widths cut, the published relations kept (heads of 2 d / H,
    scores at (head_dim / 2)^-1/2, two blocks over four hybrid layers)."""
    conf = json.loads((ROOT / "portbench" / "configs"
                       / "zamba2-2.7b.json").read_text())
    m = dict(conf["model"], n_layers=10, d_model=64, n_heads=4, kv_heads=4,
             head_dim=32, d_ff=128, vocab=256, param_dtype=dtype,
             compute_dtype=dtype)
    m["ssm"] = dict(m["ssm"], d_state=16, head_dim=16, chunk=16)
    m["hybrid"] = dict(m["hybrid"], layer_ids=[1, 3, 5, 8], adapter_rank=8)
    return m


def published_copy(tmp) -> object:
    """A CPU copy of the benchmark whose zamba2-2.7b runs the tiny
    published model."""
    root = tiny.make(tmp)
    f = root / "portbench" / "configs" / "zamba2-2.7b.json"
    conf = json.loads(f.read_text())
    conf["model"] = published_model()
    f.write_text(json.dumps(conf))
    return root


@pytest.mark.parametrize("m", [published_model(),
                               reduced_model("zamba2-2.7b")],
                         ids=["published", "reference block"])
def test_the_draws_are_the_programs_layout(m):
    from repro_torch.models.api import build_model
    model = build_model(arch_config(m), "cpu")
    p = weights.make(ref.param_draws(m), m["param_dtype"],
                     torch.Generator().manual_seed(0), "cpu")
    weights.check_layout(p, model.abstract_params())
    assert weights.count(ref.param_draws(m)) == sum(
        t.numel() for t in weights.flat(model.abstract_params()).values())


def test_the_full_size_draws_count_the_configurations_parameters():
    conf = json.loads((ROOT / "portbench" / "configs"
                       / "zamba2-2.7b.json").read_text())
    assert weights.count(ref.param_draws(conf["model"])) == conf["params"]


def test_the_control_moves_the_logits():
    m = published_model()
    p = weights.make(ref.param_draws(m), "float32",
                     torch.Generator().manual_seed(1), "cpu")
    seq = torch.randint(0, m["vocab"], (40,),
                        generator=torch.Generator().manual_seed(2))
    rows = [torch.arange(40)]
    exact = ref.logits(p, m, [seq], rows)[0]
    low = ref.logits(p, m, [seq], rows, mm=judge.fp8_mm)[0]
    assert float((low - exact).abs().max()) > 1e-3 * float(
        exact.abs().max())


def reader(name):
    return Bench(ROOT).module("metrics", name).read


def fabricated():
    """A prefill with two Mamba layers, their SSD scans and one shared
    application, and an eager decode call with the same, microseconds."""
    us, spans, ids = 1000, [], iter(range(1, 100))

    def add(name, t0, t1, parent=None, **attrs):
        s = obs.Span(name, t0 * us, t1 * us, next(ids), parent, attrs)
        spans.append(s)
        return s.id

    p = add("executor.prefill", 0, 1000, rid=0, pool="prefill")
    for i, t in enumerate((100, 400)):
        m = add("model.mamba", t, t + 200, p, layer=i, phase="prefill")
        add("mamba2.ssd_scan", t + 50, t + 100, m, chunks=2, chunk_len=256)
    add("model.shared", 300, 380, p, application=0, block=0,
        phase="prefill")
    d = add("executor.decode", 2000, 3000, rids=[0], pool="decode")
    add("model.mamba", 2000, 2030, d, layer=0, phase="decode")
    add("model.shared", 2030, 2130, d, application=0, block=0,
        phase="decode")
    add("model.mamba", 2130, 2180, d, layer=1, phase="decode")
    return obs.Records(spans, {}, 0, 0)


def test_each_reader_on_fabricated_records():
    run = SimpleNamespace(program_spans=fabricated())
    got = {name: reader(name)(run) for name in READERS}
    assert got["model.prefill_mamba_host_us"] == pytest.approx(200.0)
    assert got["model.prefill_shared_host_us"] == pytest.approx(80.0)
    assert got["model.prefill_ssd_share"] == pytest.approx(10.0)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_gives_none(name, monkeypatch):
    obs.take()
    assert reader(name)(SimpleNamespace()) is None
    # a program that records other spans but none of the hybrid's
    rec = obs.Records([obs.Span("executor.decode", 0, 5, 1, None, {})], {},
                      0, 0)
    assert reader(name)(SimpleNamespace(program_spans=rec)) is None
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert reader(name)(SimpleNamespace()) is None


def test_the_entries_name_the_cell():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["source"] == "program_span" and m["workloads"] == [CELL]
        assert m["moves"] == "output_tokens_per_s"
    cell = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1
    conf = next(c for c in SPEC["configs"] if c["name"] == "zamba2-2.7b")
    assert conf["reduced"] == []


# accepted executor and kernel metrics whose entries the benchmark's own
# tests pin to stablelm-12b.chat; the first two read on this cell too
PINNED = ("executor.decode_sync_share", "executor.decode_graph_share",
          "kernels.flash_decode_host_us")


def _list_pinned(spec):
    for m in spec["per_layer"]:
        if m["name"] in PINNED:
            m["workloads"].append(CELL)


class StandIn:
    """A captured graph's stand-in on the CPU: each replay runs the step,
    recording no span, as a replay on the card runs no layer code on the
    host."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        with obs.paused():
            self.step()


def test_a_profiled_run_of_the_published_block_reads_its_metrics(
        tmp_path, monkeypatch):
    """The cell at a tiny size, on the slot path the card takes (each
    request's decode step the replay of its slot's graph, stood in for):
    correct, and the traced run reads the cell's metrics."""
    from repro_torch.launch import serve
    monkeypatch.setattr(serve, "graph_decode", lambda m: m.graph_decode)
    monkeypatch.setattr(serve.SlotPool, "capture",
                        lambda pool, step: StandIn(step))
    root = published_copy(tmp_path)
    tiny.edit_bench(root, _list_pinned)
    out = run_cell(CELL, 2 ** 31 + 93, 1.5, False, device="cpu", root=root,
                   log=sys.stderr)
    assert out["correct"] and set(out["metrics"]) == {
        "output_tokens_per_s", "setup_s"}
    obs.take()
    with profile(activities=[ProfilerActivity.CPU]):
        out = run_cell(CELL, 2 ** 31 + 95, 1.5, True, device="cpu",
                       root=root, log=sys.stderr)
    assert out["correct"]
    m = out["metrics"]
    for name in READERS + ("executor.decode_ms_per_token",
                           "sched.decode_batch_mean", "decode.mfu",
                           "executor.decode_sync_share"):
        assert m[name]["value"] > 0, name
    # every request-step but a slot's first (its capture) replays the
    # slot's graph: no decode step issues a layer or a flash_decode call
    # from the host
    assert 90 < m["executor.decode_graph_share"]["value"] < 100
    assert "kernels.flash_decode_host_us" not in m
    assert m["model.prefill_ssd_share"]["value"] < 100
