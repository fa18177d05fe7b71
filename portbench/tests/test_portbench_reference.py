"""The plain fp32 references against the port, on the CPU at the port's
reduced configurations: the same weights (made by the benchmark from a
seed), a prefill and decode steps through the port's cache, and the
reference's logits at the same positions of its full forward."""
import pytest
import torch

from tiny import reduced_model
from portbench import judge, weights
from portbench.reference import dense_gqa

REFS = {"stablelm-12b": dense_gqa}


def served(arch: str, S: int, steps: int, seed: int = 0):
    """(model dict, weights, prompt, the port's logits and greedy tokens
    of its prefill and ``steps`` decode steps)."""
    from repro_torch.models.api import build_model
    from portbench.harness import arch_config
    m = reduced_model(arch)
    model = build_model(arch_config(m), "cpu")
    gen = torch.Generator().manual_seed(seed)
    p = weights.make(REFS[arch].param_draws(m), m["param_dtype"], gen, "cpu")
    weights.check_layout(p, model.abstract_params())
    prompt = torch.randint(0, m["vocab"], (1, S), generator=gen)
    cache = model.init_cache(p, {"tokens": prompt}, 1, S + steps + 1)
    lg, cache = model.prefill(p, {"tokens": prompt}, cache)
    out, toks = [lg[0]], [int(lg.argmax(-1))]
    for i in range(steps):
        lg, cache = model.decode_step(
            p, cache, torch.tensor([[toks[-1]]]),
            torch.full((1,), S + i, dtype=torch.int32))
        out.append(lg[0])
        toks.append(int(lg.argmax(-1)))
    return m, p, prompt[0], torch.stack(out), toks


@pytest.mark.parametrize("arch", sorted(REFS))
@pytest.mark.parametrize("S", [32, 37])
def test_reference_matches_the_port(arch, S):
    m, p, prompt, port, toks = served(arch, S, steps=5)
    seq = torch.cat([prompt, torch.tensor(toks[:-1])])
    rows = torch.arange(S - 1, S - 1 + len(toks))
    ref = REFS[arch].logits(p, m, [seq], [rows])[0]
    scale = max(1.0, float(ref.abs().max()))
    assert float((ref - port).abs().max()) <= 1e-4 * scale
    assert ref.argmax(-1).tolist() == toks


@pytest.mark.parametrize("arch", sorted(REFS))
def test_blocks_and_padding_do_not_change_logits(arch):
    """Sequences of different lengths in one padded block, or each alone,
    give the same logits."""
    m, p, prompt, _, toks = served(arch, 20, steps=0)
    a, b = prompt[:13], prompt
    rows = [torch.arange(13), torch.arange(20)]
    ref = REFS[arch]
    both = ref.logits(p, m, [a, b], rows)
    alone = ref.logits(p, m, [a], rows[:1]) + ref.logits(p, m, [b], rows[1:])
    for x, y in zip(both, alone):
        assert torch.allclose(x, y, atol=1e-5, rtol=1e-5)
    small = ref.logits(p, m, [a, b], rows, budget=16)
    for x, y in zip(small, alone):
        assert torch.allclose(x, y, atol=1e-5, rtol=1e-5)


def test_fp8_product_rounds_to_e4m3():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(64, 256, generator=g)
    w = torch.randn(256, 128, generator=g)
    exact = x @ w
    low = judge.fp8_mm(x, w)
    rel = float((low - exact).norm() / exact.norm())
    # 3 mantissa bits: each operand off by up to 2^-4 of its value
    assert 5e-3 < rel < 6e-2


@pytest.mark.parametrize("arch", sorted(REFS))
def test_control_moves_the_logits(arch):
    m, p, prompt, _, toks = served(arch, 24, steps=0)
    rows = [torch.arange(24)]
    ref = REFS[arch].logits(p, m, [prompt], rows)[0]
    low = REFS[arch].logits(p, m, [prompt], rows, mm=judge.fp8_mm)[0]
    gap = float((low - ref).abs().max())
    assert gap > 1e-3 * float(ref.abs().max())
