"""The reader of ``executor.decode_graph_share``: its value on fabricated
``executor.step`` spans, nothing where the program records none (a program
before the decode graphs, an untraced run), and its entry."""
import json
from types import SimpleNamespace

import pytest

from tiny import ROOT
from portbench.harness import Bench
from repro_torch import obs

NAME = "executor.decode_graph_share"


def read(run):
    return Bench(ROOT).module("metrics", NAME).read(run)


def records(*modes):
    """A decode call with one ``executor.step`` of each of ``modes``."""
    spans = [obs.Span("executor.decode", 0, 100, 1, None,
                      {"rids": list(range(len(modes))), "pool": "decode"})]
    spans += [obs.Span("executor.step", 10 * i, 10 * i + 5, 2 + i, 1,
                       {"rid": i, "slot": i, "mode": m})
              for i, m in enumerate(modes)]
    return obs.Records(spans, {}, 0, 0)


@pytest.mark.parametrize("modes, share", [
    (("capture", "replay", "replay", "replay"), 75.0),
    (("replay",), 100.0),
    (("eager", "eager"), 0.0),
])
def test_the_share_of_steps_that_replayed(modes, share):
    assert read(SimpleNamespace(program_spans=records(*modes))) == \
        pytest.approx(share)


def test_no_step_spans_give_none():
    assert read(SimpleNamespace(program_spans=records())) is None
    assert read(SimpleNamespace(program_spans=None)) is None
    obs.take()
    assert read(SimpleNamespace()) is None      # an empty recorder


def test_the_entry():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = next(m for m in spec["per_layer"] if m["name"] == NAME)
    assert m == {"name": NAME, "unit": "%", "better": "higher",
                 "source": "program_span", "layer": "executor",
                 "moves": "output_tokens_per_s",
                 "workloads": ["stablelm-12b.chat"]}
