"""The port's intermittency lint (``repro_torch.analysis.lint``) on the CPU:
the reference's lint cases give the same findings through both packages;
the layer loop's L repeats fold into one body at ``trips = L`` before
scoring, and the hybrid's nested repeats fold level by level; the committed ``lint_baseline_cuda.json`` equals a fresh run; the
three untagged ``decode_step`` findings are the recorded ones. Also the
``core/static_analysis.py`` shim and the identification example."""
import importlib
import json
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import lint as jlint
from repro.analysis.regions import Region as JRegion
from repro.analysis.regions import RegionTimeline as JTimeline
from repro_torch.analysis import calibrate, lint, regions
from repro_torch.analysis.regions import Region, RegionTimeline
from repro_torch.configs import get_arch

ROOT = Path(__file__).resolve().parents[1]
UNTAGGED = {"zoo/qwen1.5-0.5b", "zoo/codeqwen1.5-7b", "zoo/chameleon-34b"}


@pytest.fixture(scope="module")
def fresh():
    return lint.run_lint(device="cpu")


# trips of port findings at an entrypoint where the reference finds none
# at those trips, each with its cause (ROADMAP.md section 3): rwkv6-3b's
# prefill runs its WKV chunk loop over blocks of 32 positions where the
# reference's chunks of 128 overflow (models/rwkv6.py), so that loop's
# body folds to 32 layers x 64 blocks = 2,048 trips where the reference
# has 32 x 16 = 512
PORT_ONLY_TRIPS = {("zoo/rwkv6-3b", "prefill"): {2048}}

# entrypoints where the reference finds thrash and the port none, each with
# its cause: zamba2-2.7b's decode step runs each Mamba2 layer's step
# between its projections as one kernel op (``kernels.ops.mamba2_step``),
# whose products the cost model counts as tensor-class, as the plain
# path's ``bmm``s; a decode layer is then one tensor-class region from its
# input projection to its output projection, which the shared block's
# products continue at the same level, where the reference's layer has
# vector-class work between its products
REFERENCE_ONLY = {("zoo/zamba2-2.7b", "decode_step")}


def _tls(name, levels_trips_us):
    """The same timeline in both packages' types."""
    out = []
    for region_t, timeline_t in ((JRegion, JTimeline),
                                 (Region, RegionTimeline)):
        rs = [region_t(i, i, lvl, 0.0, 1.0, 1.0, est_us=us * trips,
                       trips=trips)
              for i, (lvl, trips, us) in enumerate(levels_trips_us)]
        out.append(timeline_t(name, rs, []))
    return out


def _key(f):
    d = f.to_dict()
    return (d["kind"], d["workload"], d["entrypoint"], d["severity"],
            d.get("region"))


@pytest.mark.parametrize("case", [
    [(1, 1, 5000.0), (2, 16, 100.0), (1, 1, 5000.0)],   # short sandwich
    [(1, 1, 5000.0), (2, 1, 3000.0), (1, 1, 5000.0)],   # long heavy region
    [(0, 1, 100.0), (1, 1, 100.0), (2, 1, 100.0)],      # ascending levels
    [(0, 1, 10.0), (2, 24, 1.5), (1, 1, 10.0), (2, 24, 2.0), (0, 1, 3.0)],
], ids=["sandwich", "long", "ascending", "two-bodies"])
def test_reference_lint_cases_give_the_same_findings(case):
    jtl, ttl = _tls("f", case)
    want = [_key(f) for f in jlint.lint_timeline(jtl, "wl")]
    got = [_key(f) for f in lint.lint_timeline(ttl, "wl")]
    assert got == want
    if case[1] == (2, 16, 100.0):
        assert len(got) == 1 and got[0][3] == 16 * (2000.0 - 100.0)


@pytest.mark.parametrize("fresh_tags,committed", [
    (["prefill", "decode_step"], ["prefill"]),
    (["prefill"], ["prefill", "decode_step"]),
    (["decode_step"], []),
])
def test_untagged_findings_equal_the_reference(fresh_tags, committed):
    heavy = {"decode_step": 42.0}
    want = [_key(f) for f in jlint.untagged_findings(
        "zoo/x", fresh_tags, committed, heavy)]
    got = [_key(f) for f in lint.untagged_findings(
        "zoo/x", fresh_tags, committed, heavy)]
    assert got == want


@pytest.mark.parametrize("keys,n,want", [
    (list("ABCBCBCD"), 3, (1, 2)),
    (list("XABCABCY"), 2, (1, 3)),
    (list("AAAA"), 4, (0, 1)),
    (list("ABCD"), 2, None),
    (list("ABAB"), 1, None),
])
def test_layer_run(keys, n, want):
    assert lint.layer_run(keys, n) == want


def _streams(arch, reduced=True, prompt=64):
    acfg = get_arch(arch).reduced() if reduced else get_arch(arch)
    return acfg, {name: (regions.record(fn, *args), (fn, args))
                  for name, (fn, args) in calibrate.entrypoints(
                      acfg, prompt).items()}


@pytest.mark.parametrize("entrypoint", ["prefill", "decode_step"])
def test_folding_gives_one_layer_body_at_n_layers_trips(entrypoint):
    acfg, streams = _streams("qwen1.5-0.5b")
    L = acfg.n_layers
    ops, (fn, args) = streams[entrypoint]
    start, period = lint.layer_run(ops, L)
    folded = lint.fold_layers(ops, (L,), entrypoint)
    flat = regions.segment(fn, *args, name=entrypoint)
    assert {r.trips for r in folded.regions} == {1, L}
    # the body's ops are numbered once, after the prologue's (a tiny
    # epilogue region may fold into the body's last region)
    body = [r for r in folded.regions if r.trips == L]
    assert all(start <= r.start_eqn < start + period for r in body)
    assert folded.est_us == pytest.approx(flat.est_us, rel=1e-12)
    assert folded.flops == flat.flops and folded.bytes == flat.bytes
    found = lint.lint_timeline(folded, "wl")
    unfolded = lint.lint_timeline(flat, "wl")
    assert found and all(f.region["trips"] == L for f in found)
    # each folded finding stands for L per-layer findings of the flat
    # timeline, one a layer at the same ops shifted by the period
    flat_at = {(f.region["start_eqn"], f.region["end_eqn"]): f
               for f in unfolded}
    for f in found:
        a, b = f.region["start_eqn"], f.region["end_eqn"]
        per_layer = [flat_at.get((a + k * period, b + k * period))
                     for k in range(L)]
        assert all(p is not None for p in per_layer)
        assert sum(p.severity for p in per_layer) == \
            pytest.approx(f.severity, rel=1e-9)
    if entrypoint == "prefill":
        # no region crosses a layer boundary: the same total severity,
        # the reference's structure, not L times it
        assert len(unfolded) == L * len(found)
        assert sum(f.severity for f in found) == \
            pytest.approx(sum(f.severity for f in unfolded), rel=1e-9)
    else:
        # the decode layer's down projection sits between its gated
        # activation and the residual add that fuses with the next
        # layer's norm: one extra sandwich a layer boundary in the flat
        # stream, which the reference's scan (flushed at the body's end,
        # like the fold) does not have
        assert len(unfolded) == L * len(found) + L


@pytest.fixture(scope="module")
def published_qwen():
    return _streams("qwen1.5-0.5b", reduced=False,
                    prompt=calibrate.CALIB_PROMPT)


def test_folding_at_the_published_width(published_qwen):
    """``_fold`` absorbs a region whose time (trips x per-trip time) is
    under ``FOLD_FRAC`` of the timeline's total, so a region of the body
    weighs L times what one flat copy weighs. At the published width some
    per-layer regions fall under that line flat and not folded, so the
    flat stream's finding count is no multiple of the folded one's.
    Segmented at ``FOLD_FRAC / L``, which weighs each flat copy as the
    body weighs it, prefill gives the structure of the reduced config
    exactly; decode gives L findings, one a layer boundary, as the
    layer's MLP and the next layer's projections fuse flat."""
    acfg, streams = published_qwen
    L = acfg.n_layers
    counts = {}
    for entrypoint, (ops, (fn, args)) in streams.items():
        start, period = lint.layer_run(ops, L)
        folded = lint.fold_layers(ops, (L,), entrypoint)
        found = lint.lint_timeline(folded, "wl")
        assert found and all(f.region["trips"] == L for f in found)
        flat = regions.segment(fn, *args, name=entrypoint)
        weighed = regions.segment(fn, *args, name=entrypoint,
                                  fold_frac=regions.FOLD_FRAC / L)
        unfolded = lint.lint_timeline(weighed, "wl")
        counts[entrypoint] = (len(found),
                              len(lint.lint_timeline(flat, "wl")),
                              len(unfolded))
        assert len(unfolded) == L * len(found)
        if entrypoint == "prefill":
            flat_at = {(f.region["start_eqn"], f.region["end_eqn"]): f
                       for f in unfolded}
            for f in found:
                a, b = f.region["start_eqn"], f.region["end_eqn"]
                per_layer = [flat_at[(a + k * period, b + k * period)]
                             for k in range(L)]
                assert sum(p.severity for p in per_layer) == \
                    pytest.approx(f.severity, rel=1e-9)
    # the counts PERF.md states: folded, flat, flat weighed as the body
    assert counts == {"prefill": (6, 71, 144), "decode_step": (1, 23, 24)}


def test_a_stream_without_layer_repeats_is_segmented_as_it_is():
    from repro_torch.kernels.ops import flash_attention
    q = torch.zeros((1, 2, 32, 16))
    ops = regions.record(lambda a, b, c: flash_attention(a, b, c), q, q, q)
    tl = lint.fold_layers(ops, (24,), "flash_attention")
    assert [(r.level, r.trips) for r in tl.regions] == [(2, 1)]


def test_committed_baseline_equals_a_fresh_run_and_is_ranked(fresh):
    base = json.loads(lint.BASELINE_PATH.read_text())
    assert lint._canon(fresh) == lint.BASELINE_PATH.read_text()
    assert base["n_findings"] == len(base["findings"])
    sevs = [f["severity"] for f in base["findings"]]
    assert sevs == sorted(sevs, reverse=True)
    assert lint.BASELINE_PATH.name == "lint_baseline_cuda.json"
    assert base["skipped"] == sorted(calibrate.ported_archs()[1]) == []
    assert {f["workload"] for f in base["findings"]} >= {
        "zoo/rwkv6-3b", "zoo/whisper-large-v3"}


def test_three_untagged_decode_steps(fresh):
    untagged = [f for f in fresh["findings"]
                if f["kind"] == "untagged-heavy-entrypoint"]
    assert fresh["n_untagged"] == 3
    assert {f["workload"] for f in untagged} == UNTAGGED
    assert {f["entrypoint"] for f in untagged} == {"decode_step"}


def test_zoo_findings_against_the_reference_baseline(fresh):
    """Per (workload, entrypoint): the port's thrash findings and trips
    beside the reference's ``lint_baseline.json``. The counts differ (the
    port's attention is one op where the reference scans chunks of it);
    the port finds thrash at an entrypoint where the reference does (both
    find none in the MoE archs' decode step), but for the recorded
    ``REFERENCE_ONLY``, where the reference finds some and the port none;
    every trip count the port gives is one its fold gives (L; the hybrid's
    nested counts), and one the reference gives too at that entrypoint,
    but for the recorded ``PORT_ONLY_TRIPS``."""
    ref = json.loads(jlint.BASELINE_PATH.read_text())
    ported, _ = calibrate.ported_archs()

    def table(result):
        out = {}
        for f in result["findings"]:
            if f["kind"] == "license-thrash":
                out.setdefault((f["workload"], f["entrypoint"]),
                               []).append(f["region"]["trips"])
        return out

    want, got = table(ref), table(fresh)
    for arch in ported:
        acfg = get_arch(arch)
        for ep in ("prefill", "decode_step"):
            key = (f"zoo/{arch}", ep)
            w, g = sorted(want.get(key, [])), sorted(got.get(key, []))
            print(f"{key}: reference {len(w)} {sorted(set(w))}, "
                  f"port {len(g)} {sorted(set(g))}")
            if key in REFERENCE_ONLY:
                assert w and not g
            else:
                assert bool(g) == bool(w)
            assert set(g) <= fold_trips(acfg, ep)
            assert set(g) - PORT_ONLY_TRIPS.get(key, set()) <= set(w)
    assert not [k for k in got if k[0] == "kernel"]


def fold_trips(acfg, entrypoint) -> set:
    """The trips the fold gives an entrypoint's nested bodies: L for a
    layer loop; for the hybrid the groups, groups x layers a group and, in
    prefill, that times the SSD chunks."""
    counts = lint.fold_counts(acfg, entrypoint, calibrate.CALIB_PROMPT)
    trips, out = 1, set()
    for c in counts:
        trips *= c
        out.add(trips)
    return out


def test_zamba2_folds_to_the_reference_trips(fresh):
    """zamba2-2.7b's prefill findings sit at the trips of the reference's
    nested scans: the SSD chunk loop's body at 54 x 16 = 864, a Mamba2
    layer at 54 and the shared block at 9. The reference's 36 (9 x its 4
    attention chunks) has no counterpart: the port's attention is one
    kernel op. Its decode step has none (``REFERENCE_ONLY``): each Mamba2
    layer's step is one kernel op, where the reference finds a Mamba2
    layer at 54."""
    ref = json.loads(jlint.BASELINE_PATH.read_text())

    def trips(result, ep):
        return {f["region"]["trips"] for f in result["findings"]
                if f["workload"] == "zoo/zamba2-2.7b"
                and f["entrypoint"] == ep and "region" in f}

    assert lint.fold_counts(get_arch("zamba2-2.7b"), "prefill",
                            calibrate.CALIB_PROMPT) == (9, 6, 16)
    assert trips(fresh, "prefill") == {864, 54, 9}
    assert trips(ref, "prefill") == {864, 54, 36, 9}
    assert trips(fresh, "decode_step") == set()
    assert trips(ref, "decode_step") == {54}


def test_rwkv6_and_whisper_fold_to_their_trips(fresh):
    """rwkv6-3b's prefill folds its 32 layers and, in each, its WKV loop
    of 64 blocks (2,048 prompt tokens in blocks of 32); its decode step
    only the layers. whisper-large-v3's two stacks of 32 run one after
    another (prefill: the encoder in init_cache, the cross-K/V of each
    decoder layer, the encoder again, the decoder), each folding at 32;
    the reference's 64 and 128 (its attention chunks) cannot appear."""
    rwkv, whisper = get_arch("rwkv6-3b"), get_arch("whisper-large-v3")
    P = calibrate.CALIB_PROMPT
    assert lint.fold_counts(rwkv, "prefill", P) == (32, 64)
    assert lint.fold_counts(rwkv, "decode_step", P) == (32,)
    assert lint.fold_counts(whisper, "prefill", P) == (32,)
    assert lint.fold_runs(whisper, "prefill") == 4
    assert lint.fold_runs(whisper, "decode_step") == \
        lint.fold_runs(rwkv, "prefill") == 1

    def trips(arch, ep):
        return {f["region"]["trips"] for f in fresh["findings"]
                if f["workload"] == f"zoo/{arch}" and f["entrypoint"] == ep
                and "region" in f}

    assert trips("rwkv6-3b", "prefill") == {2048, 32}
    assert trips("rwkv6-3b", "decode_step") == {32}
    assert trips("whisper-large-v3", "prefill") == {32}
    assert trips("whisper-large-v3", "decode_step") == {32}


@pytest.mark.parametrize("between", [[], ["xk", "xv"]])
def test_stacks_that_run_one_after_another_each_fold(between):
    """Two runs of 4 repeats of different bodies, with or without ops
    between them: each folds to its body at trips 4, what lies around and
    between keeps trips 1."""
    keys = ["emb"] + ["E1", "E2"] * 4 + between + ["D1", "D2", "D3"] * 4 \
        + ["out"]
    parts = [(p, t) for p, t in lint.fold_parts(keys, (4,), runs=2) if p]
    assert parts == [(["emb"], 1), (["E1", "E2"], 4)] \
        + [(between, 1)] * bool(between) \
        + [(["D1", "D2", "D3"], 4), (["out"], 1)]
    # one run a level by default: the longest period's
    assert [(p, t) for p, t in lint.fold_parts(keys, (4,)) if p] == \
        [(["emb"] + ["E1", "E2"] * 4 + between, 1),
         (["D1", "D2", "D3"], 4), (["out"], 1)]


@pytest.mark.parametrize("pro,epi", [([], []), (["emb"], ["norm", "out"])])
def test_nested_fold_of_groups_of_layers(pro, epi):
    """9 groups of (6 x a layer A, then a block B): the groups fold to
    trips 9 and the layers inside one to 54; with a chunk loop inside A
    (4 x C), that body folds to 216."""
    keys = pro + (["A"] * 6 + ["B1", "B2"]) * 9 + epi
    parts = lint.fold_parts(keys, (9, 6))
    assert [(p, t) for p, t in parts if p] == (
        [(pro, 1)] * bool(pro) + [(["A"], 54), (["B1", "B2"], 9)]
        + [(epi, 1)] * bool(epi))
    layer = ["n", "in"] + ["c1", "c2", "c3"] * 4 + ["out"]
    keys = pro + (layer * 6 + ["B1"]) * 9 + epi
    parts = [(p, t) for p, t in lint.fold_parts(keys, (9, 6, 4)) if p]
    assert (["c1", "c2", "c3"], 216) in parts
    assert (["n", "in"], 54) in parts and (["out"], 54) in parts
    assert (["B1"], 9) in parts
    assert sum(len(p) * t for p, t in parts) == len(keys)


def test_nested_fold_keeps_a_level_without_a_run():
    """A level whose run is missing leaves its stream whole, at the trips
    of the levels around it."""
    keys = (["x", "y", "z"] + ["B"]) * 9
    assert [(p, t) for p, t in lint.fold_parts(keys, (9, 6)) if p] == \
        [(["x", "y", "z", "B"], 9)]


def test_layer_run_on_a_long_stream_without_a_run_is_fast():
    """20,000 distinct keys: no run at any period, found in well under a
    second (the slices are never copied or compared whole)."""
    import time
    keys = [("op", i) for i in range(20_000)]
    t0 = time.perf_counter()
    assert lint.layer_run(keys, 2) is None
    assert lint.layer_run(keys, 9) is None
    assert lint.fold_parts(keys, (9, 6, 16)) == [(keys, 1)]
    assert time.perf_counter() - t0 < 1.0


def test_check_baseline_fails_only_on_the_untagged_findings(
        fresh, monkeypatch, capsys):
    monkeypatch.setattr(lint, "run_lint", lambda device: fresh)
    assert lint.main(["--device", "cpu", "--check-baseline"]) == 1
    err = capsys.readouterr().err
    assert "untagged heavy entrypoint" in err
    assert "drifted" not in err


def test_shim_exports():
    import repro_torch.core.static_analysis as shim
    from repro_torch.analysis import costs
    assert set(shim.__all__) == {"FunctionProfile", "analyze", "cost_tuple",
                                 "rank_functions", "report"}
    assert shim.analyze is regions.analyze
    assert shim.cost_tuple is costs.cost_tuple
    for name in ("analyze_jaxpr", "_jaxpr_cost", "_eqn_cost"):
        assert not hasattr(shim, name)
        assert name in shim.__doc__


def test_identification_example_matches_the_reference(capsys):
    from repro_torch.examples import identify_hot_code
    tls, ranked, confirmed = identify_hot_code.main(
        ["--device", "cpu", "--sim-us", "200000"])
    ours = capsys.readouterr().out
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        ref = importlib.import_module("identify_hot_code")
    finally:
        sys.path.remove(str(ROOT / "examples"))
    assert confirmed == ref.main(sim_us=200_000.0)
    theirs = capsys.readouterr().out
    assert [t.name for t in tls] == ["chacha20_avx512", "brotli",
                                     "ffn_block"]
    for marker in ("analyzer heavy tags:", "license residency:",
                   "top throttle culprits:"):
        line = lambda out: next(x for x in out.splitlines()  # noqa: E731
                                if x.startswith(marker))
        assert line(ours) == line(theirs)
    assert [p.name for p in ranked][0] == "ffn_block"
