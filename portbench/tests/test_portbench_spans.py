"""The readers of the program's spans (``portbench/spans.py`` and the
metrics that read it): their values on fabricated records, nothing where
the recorder holds nothing or the program has none, and every one read in
its cell by a run of the CPU copy under a profiler of the host's
activity."""
import json
import sys
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

import tiny
from tiny import ROOT
from portbench.harness import Bench
from portbench.run import run_cell
from repro_torch import obs

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = {"executor.decode_sync_share": "stablelm-12b.chat",
           "model.decode_attn_host_us": "stablelm-12b.chat",
           "model.decode_ffn_host_us": "stablelm-12b.chat",
           "kernels.flash_decode_host_us": "stablelm-12b.chat",
           "sched.stolen_decode_share": "stablelm-12b.long-prompt"}


def reader(name):
    return Bench(ROOT).module("metrics", name).read


def fabricated():
    """Two decode calls (one stolen by the prefill pool) and a prefill,
    times in microseconds on perf_counter_ns."""
    us = 1000
    spans, ids = [], iter(range(1, 100))

    def add(name, t0, t1, parent=None, **attrs):
        s = obs.Span(name, t0 * us, t1 * us, next(ids), parent, attrs)
        spans.append(s)
        return s.id

    p = add("executor.prefill", 0, 400, rid=0, pool="prefill")
    add("model.attn", 10, 110, p, layer=0, phase="prefill")
    add("executor.sync", 300, 400, p)
    d = add("executor.decode", 500, 1500, rids=[0], pool="decode")
    a = add("model.attn", 510, 560, d, layer=0, phase="decode")
    add("kernels.flash_decode", 520, 540, a)
    add("model.ffn", 560, 590, d, layer=0, phase="decode")
    add("executor.sync", 1400, 1500, d)
    s = add("executor.decode", 2000, 2600, rids=[0, 1], pool="prefill")
    a = add("model.attn", 2010, 2080, s, layer=0, phase="decode")
    add("kernels.flash_decode", 2020, 2050, a)
    add("model.ffn", 2080, 2130, s, layer=0, phase="decode")
    add("executor.sync", 2500, 2600, s)
    return obs.Records(spans, {}, 0, 0)


def test_each_reader_on_fabricated_records():
    run = SimpleNamespace(program_spans=fabricated())
    got = {name: reader(name)(run) for name in READERS}
    assert got["executor.decode_sync_share"] == pytest.approx(
        100 * 200 / 1600)                  # the prefill's sync left out
    assert got["model.decode_attn_host_us"] == pytest.approx(60.0)
    assert got["model.decode_ffn_host_us"] == pytest.approx(40.0)
    assert got["kernels.flash_decode_host_us"] == pytest.approx(25.0)
    assert got["sched.stolen_decode_share"] == pytest.approx(
        100 * 600 / 1000)


def test_the_recorder_is_taken_once_a_run():
    obs.take()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.call("executor.decode", rids=[3], pool="decode"):
            with obs.call("executor.sync"):
                pass
    run = SimpleNamespace()
    first = reader("executor.decode_sync_share")(run)
    assert first is not None and run.program_spans.spans
    assert obs.take().spans == []           # taken by the first reader
    assert reader("executor.decode_sync_share")(run) == first


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_to_read_gives_none(name, monkeypatch):
    obs.take()
    assert reader(name)(SimpleNamespace()) is None   # an empty recorder
    # a program without the recorder
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert reader(name)(SimpleNamespace()) is None


def test_the_entries_name_their_cells():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name, cell in READERS.items():
        m = entries[name]
        assert m["source"] == "program_span" and m["workloads"] == [cell]


@pytest.mark.parametrize("cell", sorted(set(READERS.values())))
def test_a_profiled_run_reads_every_metric_of_its_cell(tmp_path, cell):
    root = tiny.make(tmp_path)
    obs.take()
    with profile(activities=[ProfilerActivity.CPU]):
        out = run_cell(cell, 2 ** 31 + 91, 1.5, True, device="cpu",
                       root=root, log=sys.stderr)
    assert out["correct"]
    for name, c in READERS.items():
        if c == cell:
            assert out["metrics"][name]["value"] >= 0, name
        else:
            assert name not in out["metrics"]
    if cell == "stablelm-12b.chat":
        m = out["metrics"]
        assert 0 < m["executor.decode_sync_share"]["value"] < 100
        assert m["kernels.flash_decode_host_us"]["value"] < \
            m["model.decode_attn_host_us"]["value"]
