"""The harness on the CPU, with the port's reduced configurations and its
kernels' plain versions (``device="cpu"``: the look for a card skipped):
data-driven lookup, the rules of ``BENCHMARK.json``, imports, the censored
tail, and the check of the served tokens against faults planted in the
timed path."""
import json
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

import tiny
from tiny import ROOT
from portbench import stats
from portbench.run import run_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def copy(tmp_path):
    return tiny.make(tmp_path)


def _run(root, cell, traced=False, seconds=1.5, seed=2 ** 31 + 77):
    return run_cell(cell, seed, seconds, traced, device="cpu", root=root,
                    log=sys.stderr)


def test_names_units_and_keys_keep_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 0 < len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (ROOT / "portbench" / "workloads"
                / f"{w['name']}.json").is_file()
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["layer"].strip()
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for c in m["workloads"]:
            assert c in cells and c in e2e[m["moves"]].get("workloads",
                                                           cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"
    for c in cells:
        assert any(c in m["workloads"] for m in SPEC["per_layer"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_cell_a_configuration_and_a_metric_are_found_by_name(copy):
    """Each added as files alone (and its line in BENCHMARK.json)."""
    conf = json.loads((copy / "portbench/configs/stablelm-12b.json")
                      .read_text())
    conf["name"] = "tiny-dense"
    conf["model"] = dict(conf["model"], name="tiny-dense", n_layers=3)
    (copy / "portbench/configs/tiny-dense.json").write_text(json.dumps(conf))
    mix = json.loads((copy / "portbench/workloads/stablelm-12b.chat.json")
                     .read_text())
    (copy / "portbench/workloads/tiny-dense.burst.json").write_text(
        json.dumps(dict(mix, arrivals={"kind": "mmpp", "rate_on_per_s": 9.0,
                                       "rate_off_per_s": 1.0,
                                       "mean_on_ms": 500.0,
                                       "mean_off_ms": 500.0})))
    (copy / "portbench/metrics/sched.prefills.py").write_text(
        "def read(run):\n"
        "    return sum(c.kind == 'prefill' for c in run.calls)\n")
    (copy / "portbench/metrics/sched.decodes.py").write_text(
        "def read(run):\n"
        "    return sum(c.kind == 'decode' for c in run.calls)\n")

    def add(spec):
        spec["configs"].append({"name": "tiny-dense", "source": "x",
                                "file": "portbench/configs/tiny-dense.json",
                                "reduced": [], "why": "a test"})
        spec["workloads"].append({"name": "tiny-dense.burst",
                                  "config": "tiny-dense", "traffic": "burst",
                                  "chips": 1, "why": "a test"})
        spec["per_layer"].append({"name": "sched.prefills",
                                  "unit": "requests", "better": "higher",
                                  "source": "program_counter",
                                  "layer": "scheduler",
                                  "moves": "output_tokens_per_s",
                                  "workloads": ["tiny-dense.burst"]})
        # without ``workloads``: every cell that reports what it moves
        spec["per_layer"].append({"name": "sched.decodes",
                                  "unit": "rounds", "better": "lower",
                                  "source": "program_counter",
                                  "layer": "scheduler",
                                  "moves": "output_tokens_per_s"})
        for m in spec["end_to_end"]:
            if m["name"] == "output_tokens_per_s":
                m["workloads"].append("tiny-dense.burst")
    tiny.edit_bench(copy, add)
    out = _run(copy, "tiny-dense.burst", traced=True)
    assert out["metrics"]["sched.prefills"]["value"] >= 1
    assert out["metrics"]["sched.decodes"]["value"] >= 1
    assert "executor.decode_ms_per_token" not in out["metrics"]
    assert out["correct"]
    out = _run(copy, "stablelm-12b.chat", traced=True)
    assert "sched.decodes" in out["metrics"]
    assert "sched.prefills" not in out["metrics"]
    out = _run(copy, "stablelm-12b.long-prompt", traced=True)
    assert "sched.decodes" not in out["metrics"]
    out = _run(copy, "tiny-dense.burst")
    assert set(out["metrics"]) == {"output_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_runs_and_reports_its_metrics(copy, cell):
    out = _run(copy, cell)
    want = {m["name"] for m in SPEC["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    assert out["correct"] and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    out = _run(copy, cell, traced=True)
    # on the CPU there is no device trace: its readers give nothing
    assert "device.idle_share" not in out["metrics"]
    assert out["metrics"] and "device.idle_share" not in out["metrics"]


def test_a_run_loads_no_jax(copy):
    code = ("import sys, json; sys.path[:0] = [%r, %r]\n"
            "from pathlib import Path\n"
            "from portbench.run import run_cell, forbidden_modules\n"
            "run_cell('stablelm-12b.long-prompt', 5, 1.0, True, device='cpu', "
            "root=Path(%r))\n"
            "print(json.dumps(forbidden_modules()))\n"
            % (str(ROOT), str(ROOT / "src"), str(copy)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_no_result_without_a_card(tmp_path):
    res = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"),
                          "--workload", "stablelm-12b.chat", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    root = tiny.make(tmp_path)       # BENCHMARK.json and portbench/ alone
    res = subprocess.run([sys.executable, str(root / "portbench/run.py"),
                          "--workload", "stablelm-12b.chat", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=root)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_a_request_still_waiting_raises_the_ttft_tail():
    def req(rid, arrive, ttft):
        return SimpleNamespace(rid=rid, arrive_ms=arrive, ttft_ms=ttft,
                               done_ms=None, last_token_ms=None)
    served = [req(i, 100.0 * i, 50.0) for i in range(20)]
    run = SimpleNamespace(requests=served, t_now=5000.0, prefill_ms={},
                          itl_ms=[])
    base = stats.percentile(stats.ttfts(run), 90)
    run.requests = served + [req(20 + i, 1000.0 + 100 * i, None)
                             for i in range(4)]
    assert stats.percentile(stats.ttfts(run), 90) > base
    assert max(stats.ttfts(run)) == 4000.0
    assert stats.percentile(stats.waits(run), 90) > 50.0


def test_an_open_gap_counts_at_its_length_so_far():
    r = SimpleNamespace(done_ms=None, last_token_ms=1000.0)
    run = SimpleNamespace(requests=[r], t_now=4000.0, itl_ms=[100.0] * 30)
    assert max(stats.itls(run)) == 3000.0


# ------------------------------------------------ faults in the timed path
# The sound run's fp32 tokens sit on the fp32 reference's (gap ~1e-6); the
# copy's limit is set between that and what a fault gives. The exchange
# between chips has no fault to plant: every cell runs on one chip.

def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.clone()


def _state_unchanged(mp):
    from repro_torch.models import api
    build = api.build_model

    def patched(cfg, device="cuda", *a, **k):
        model = build(cfg, device, *a, **k)
        step = model.decode_step

        def stale(params, cache, tokens, lengths, **kw):
            return step(params, _clone(cache), tokens, lengths, **kw)[0], \
                cache
        model.decode_step = stale
        return model
    mp.setattr(api, "build_model", patched)


def _half_the_batch(mp):
    from repro_torch.launch.serve import RealModelExecutor
    decode = RealModelExecutor.decode

    def half(self, batch, pool, ndev):
        keep = batch[:(len(batch) + 1) // 2]
        ms = decode(self, keep, pool, ndev)
        for req in batch[len(keep):]:      # left out: last token again
            _, tok, _ = self.state[req.rid]
            self.tokens[req.rid].append(tok)
            if req.generated + 1 >= req.max_new:
                del self.state[req.rid], self.live[req.rid]
                self.done[req.rid] = req.attempts
        return ms
    mp.setattr(RealModelExecutor, "decode", half)


def _token_altered(mp):
    from repro_torch.models import api
    build = api.build_model

    def patched(cfg, device="cuda", *a, **k):
        model = build(cfg, device, *a, **k)
        step = model.decode_step

        def altered(params, cache, tokens, lengths, **kw):
            logits, cache = step(params, cache, tokens, lengths, **kw)
            return torch.roll(logits, cfg.vocab // 2, -1), cache
        model.decode_step = altered
        return model
    mp.setattr(api, "build_model", patched)


@pytest.mark.parametrize("fault", [None, _state_unchanged, _half_the_batch,
                                   _token_altered])
@pytest.mark.parametrize("cell", ["stablelm-12b.chat",
                                  "stablelm-12b.long-prompt"])
def test_a_fault_in_the_timed_path_is_not_correct(tmp_path, monkeypatch,
                                                  fault, cell):
    root = tiny.make(tmp_path)
    f = root / "portbench" / "workloads" / f"{cell}.json"
    mix = json.loads(f.read_text())
    # a load at which decode rounds batch several requests
    mix["arrivals"] = {"kind": "poisson", "rate_per_s": 60.0}
    mix["check"]["gap_limit"] = 1e-3
    f.write_text(json.dumps(mix))
    if fault is not None:
        fault(monkeypatch)
    out = _run(root, cell, seconds=3.0)
    assert out["checks"]["tokens_judged"]["value"] > 0
    assert out["correct"] is (fault is None), out["checks"]


def test_the_window_opens_after_the_ramp(copy):
    """The ramp serves traffic unmeasured: the window reads the requests
    that arrive after it opens, the calls made in it, and counts the
    ramp's seconds as set-up."""
    from portbench import harness
    srv = harness.Serving(harness.Bench(copy), "stablelm-12b.long-prompt",
                          "cpu")
    srv.make_weights(3)
    srv.warm_up()
    mix = dict(srv.mix, ramp_s=1.0,
               arrivals={"kind": "poisson", "rate_per_s": 20.0})
    run = srv.window(3, 1.0, mix=mix, setup_s=2.0)
    assert run.ramp_s == 1.0 and run.t_open > 0
    assert run.requests and all(r.arrive_ms > run.t_open
                                for r in run.requests)
    assert harness.Bench(copy).module("metrics", "setup_s").read(run) == 3.0
    whole = srv.window(3, 1.0, mix=dict(mix, ramp_s=0))
    assert whole.t_open == 0.0 and whole.requests[0].rid == 0
    for r in (run, whole):
        # the tokens are those of the window's calls: a first token a
        # prefill, one a request in each decode round
        assert r.tokens == sum(len(c.lengths) if c.kind == "decode" else 1
                               for c in r.calls)


def _summary(names: dict):
    from portbench.trace import Summary
    return Summary(window_s=1.0, busy_s=0.5, kernels=sum(
        c for c, _ in names.values()), by_name={k: list(v) for k, v in
                                                names.items()})


def test_kernels_are_matched_by_their_function_name():
    from portbench.trace import function
    assert function("void flash_decode_kernel<__nv_bfloat16, 160, 4>"
                    "(__nv_bfloat16 const*, int)") == "flash_decode_kernel"
    assert function("flash_attention_tc_kernel<160, 160, 4>") == \
        "flash_attention_tc_kernel"
    # as the profiler names them on the card
    assert function("void (anonymous namespace)::flash_decode_kernel<__nv_"
                    "bfloat16, 160, 4>(__nv_bfloat16 const*, int const*)"
                    ) == "flash_decode_kernel"
    assert function("void (anonymous namespace)::tc::flash_attention_tc_"
                    "kernel<160, 160, 4>(__nv_bfloat16 const*)") == \
        "flash_attention_tc_kernel"
    t = _summary({"void (anonymous namespace)::flash_decode_kernel<float, 64,"
                  " 2>(float*)": (3, 1.0),
                  "void flash_decode_merge_kernel<float>(float*)": (5, 9.0),
                  "void flash_decode_kernel<float, 80, 2>(float*)": (1, 0.5)})
    assert t.kernel("flash_decode_kernel") == (4, 1.5)


@pytest.mark.parametrize("extra", [0, 1, -1])
def test_a_roofline_reads_nothing_where_the_launches_disagree(copy, extra):
    """The roofline readers count their kernel's launches against the
    calls the window made; any other number, a launch lost or one more
    kernel of the name, reads nothing rather than a share scaled to fit."""
    from portbench import harness
    bench = harness.Bench(copy)
    conf = bench.config("stablelm-12b")
    m = conf["model"]
    counts = bench.module("counts", conf["counts"])
    calls = [harness.Call("prefill", 0, 1, 100.0, (64,)),
             harness.Call("decode", 1, 2, 10.0, (65, 70)),
             harness.Call("decode", 2, 3, 10.0, (66,))]
    L = m["n_layers"]
    run = SimpleNamespace(model=m, counts=counts, prompt=64, calls=calls,
                          trace=_summary({
                              "void flash_decode_kernel<float, 16, 2>()":
                                  (3 * L + extra, 0.003),
                              "flash_attention_kernel<float, 16, 16>":
                                  (L + extra, 0.002),
                              "void at::native::copy_kernel()": (7, 1.0)}))
    dec = bench.module("metrics", "flash_decode_roofline").read(run)
    att = bench.module("metrics", "flash_attention_roofline").read(run)
    if extra:
        assert dec is None and att is None
    else:
        assert 0 < dec < 100 and 0 < att < 100
