"""The pieces of the port's tensor and sequence parallelism that run in one
process, on the CPU: ``flash_decode``'s log-sum-exp (its plain version,
against a direct fp64 log-sum-exp), ``merge_partials`` over sequence
shards of a cache against the whole-cache call, the sanitized-spec tests
of a head split (``dist.sharding``) and the plans of the transformer,
whisper and zamba2 on the reference's meshes (``models.tp``). The
multi-rank paths are held to the reference in
``test_torch_distributed.py`` and ``test_torch_serve_dist.py``; the
kernel's log-sum-exp to its plain
version on the card (``chip_smoke.py`` phase 3)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.dist.context import make_dist
from repro_torch.dist.sharding import P, cuts_units, keep_axes, split_ways
from repro_torch.kernels import ops
from repro_torch.models import tp as tpm
from repro_torch.models.api import build_model
from repro_torch.models.attention import _kv_heads, merge_partials
from repro_torch.models.transformer import lm_local_leaves


def _decode_inputs(seed, B, G, KVH, S, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(dtype))
                 for s in ((B, KVH * G, D), (B, KVH, S, D), (B, KVH, S, D)))


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_flash_decode_lse_plain_matches_fp64(G, dtype):
    """The plain ``flash_decode_lse``: its lse is ln sum exp(q.k/sqrt(D))
    over the positions below each row's length, against fp64 numpy within
    1e-5 (-inf where the length is 0), and its output the plain
    ``flash_decode``'s (0 at length 0, where that one averages V)."""
    B, KVH, S, D = 4, 2, 48, 16
    q, k, v = _decode_inputs(0, B, G, KVH, S, D, dtype)
    lengths = torch.tensor([0, 1, 31, 48], dtype=torch.int32)
    o, lse = ops.flash_decode_lse(q, k, v, lengths)
    assert lse.dtype == torch.float32 and lse.shape == (B, KVH * G)
    assert o.dtype == q.dtype
    s = np.einsum("bkgd,bktd->bkgt",
                  q.double().numpy().reshape(B, KVH, G, D),
                  k.double().numpy()) / math.sqrt(D)
    for b, n in enumerate(lengths.tolist()):
        if n == 0:
            assert np.all(np.isneginf(lse[b].numpy()))
            assert torch.equal(o[b], torch.zeros_like(o[b]))
            continue
        top = s[b, ..., :n].max(-1, keepdims=True)
        want = (np.log(np.exp(s[b, ..., :n] - top).sum(-1))
                + top[..., 0]).reshape(-1)
        np.testing.assert_allclose(lse[b].numpy(), want, rtol=0, atol=1e-5)
    plain = ops.flash_decode(q, k, v, lengths)
    torch.testing.assert_close(o[1:], plain[1:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_merge_partials_equals_the_whole_cache_call(shards):
    """A 64-position cache cut into 1, 2 and 4 sequence shards: each
    shard's ``flash_decode_lse`` at its local lengths (clamp(L - r S_r, 0,
    S_r)), merged by ``merge_partials``, equals the whole-cache call within
    1e-6 in fp32, output and lse, with a row of length 0 (output 0, lse
    -inf, never NaN), lengths that end on a shard's edge (16, 32) and, at 4
    shards, a shard past every length."""
    B, G, KVH, S, D = 4, 2, 2, 64, 16
    q, k, v = _decode_inputs(1, B, G, KVH, S, D)
    lengths = torch.tensor([0, 16, 32, 40], dtype=torch.int32)
    want_o, want_lse = ops.flash_decode_lse(q, k, v, lengths)
    Sr = S // shards
    parts = [ops.flash_decode_lse(q, k[:, :, r * Sr:(r + 1) * Sr],
                                  v[:, :, r * Sr:(r + 1) * Sr],
                                  (lengths - r * Sr).clamp(0, Sr))
             for r in range(shards)]
    if shards == 4:
        assert torch.isneginf(parts[3][1]).all()
    o, lse = merge_partials(torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts]))
    assert not torch.isnan(o).any() and not torch.isnan(lse).any()
    assert torch.equal(o[0], torch.zeros_like(o[0]))
    assert torch.isneginf(lse[0]).all()
    torch.testing.assert_close(o, want_o, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse[1:], want_lse[1:], rtol=0, atol=1e-6)


class FakeMesh:
    """Axis names, sizes and this rank's coordinates; no process groups."""

    def __init__(self, coords=None, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.coords = coords or {a: 0 for a in shape}

    def group(self, axes):
        return None


def test_sanitized_head_splits():
    """``split_ways`` is the axis' size where the sanitized spec keeps it;
    ``cuts_units`` tells a split inside a head (4 K/V heads of 128 over
    16, or 2 of 16 over 4) from one in whole heads; ``keep_axes`` keeps
    only the ``model`` entries of a spec."""
    m16, m4 = FakeMesh(data=16, model=16), FakeMesh(data=2, model=4)
    assert split_ways(4 * 128, "model", m16) == 16
    assert split_ways(100, "model", m16) == 1
    assert cuts_units(4, 128, "model", m16)
    assert not cuts_units(48, 128, "model", m16)
    assert cuts_units(2, 16, "model", m4)
    assert not cuts_units(4, 16, "model", m4)
    assert not cuts_units(3, 5, "model", m4)     # not split at all
    assert keep_axes(P(None, "data", "model"), ("model",)) == \
        P(None, None, "model")
    assert keep_axes(P("model", "data"), ("model",)) == P("model", None)


@pytest.mark.parametrize("arch,cut,n_q,n_kv", [
    ("qwen1.5-0.5b", False, 1, 1),
    ("codeqwen1.5-7b", False, 2, 2),
    ("stablelm-12b", True, 2, 1),
    ("starcoder2-15b", True, 3, 1),
    ("chameleon-34b", True, 4, 1),
    ("grok-1-314b", True, 3, 1),
    ("deepseek-v3-671b", False, 8, 8),
])
def test_plan_on_the_production_mesh(arch, cut, n_q, n_kv):
    """Every transformer arch on (16, 16): query heads split whole; where
    the spec cuts a K/V head, ``wk``/``wv`` come whole and rank r computes
    the one K/V head its query heads read, which ``_kv_heads`` takes from
    the first of that head's ranks; the local leaves are the split ones,
    at their ``model`` entry alone."""
    cfg = get_arch(arch)
    for r in (0, 5, 15):
        dist = make_dist(FakeMesh({"data": 0, "model": r}, data=16,
                                  model=16))
        tp = tpm.plan(cfg, dist)
        assert tp.heads and tp.kv_split == (not cut)
        assert (tp.n_q, tp.n_kv, tp.q_lo) == (n_q, n_kv, r * n_q)
        if cut:
            G = cfg.n_heads // cfg.kv_heads
            assert tp.kv_lo == r * n_q // G
        assert tp.vocab and tp.ffn == (cfg.moe is None)
    if cfg.attention == "gqa":
        # each rank's block holds its K/V heads' ids: every head once
        blocks = torch.stack([torch.arange(n_kv) + tpm.plan(cfg, make_dist(
            FakeMesh({"data": 0, "model": r}, data=16, model=16))).kv_lo
            for r in range(16)]).float()[:, :, None]
        got = _kv_heads(blocks, tp, cfg.kv_heads)[:, 0]
        assert got.tolist() == list(range(cfg.kv_heads))
    local = lm_local_leaves(cfg, dist)
    if cfg.attention == "gqa":
        assert ("layers/attn/wk/w" in local) == (not cut)
        assert local["layers/attn/wq/w"] == P(None, None, "model")
        assert local["layers/attn/wo/w"] == P(None, "model", None)
    assert local["embed"] == P("model", None)


def test_plan_cuts_a_kv_head_of_the_reduced_qwen():
    """The reduced qwen1.5-0.5b with 2 K/V heads on (2, 4): one query head
    a rank, the K/V head ``r // 2`` computed from whole ``wk``/``wv``; at a
    model axis of 1 there is no plan."""
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").reduced(),
                              kv_heads=2)
    for r in range(4):
        tp = tpm.plan(cfg, make_dist(FakeMesh({"data": 0, "model": r},
                                              data=2, model=4)))
        assert tp.heads and not tp.kv_split
        assert (tp.q_lo, tp.kv_lo, tp.n_kv) == (r, r // 2, 1)
    assert tpm.plan(cfg, make_dist(FakeMesh(data=8, model=1))) is None
    local = lm_local_leaves(cfg, make_dist(FakeMesh(data=2, model=4)))
    assert "layers/attn/wk/w" not in local and "layers/attn/wq/w" in local


ENCDEC_LEAVES = {f"{b}/{w}" for b in tpm.ENCDEC_ATTN
                 for w in ("wq", "wk", "wv", "wo")} | {
    f"{b}/{w}" for b in tpm.ENCDEC_MLP for w in ("up", "down")}


@pytest.mark.parametrize("mesh,heads", [("2x4", True), ("16x16", False)])
def test_plan_of_whisper(mesh, heads):
    """whisper-large-v3 (20 heads of 64, d_ff 5,120): every dense layer's
    output dim split over ``model``; on (2, 4) in whole heads (5 a rank),
    on (16, 16) not (80 columns a rank, 1.25 heads); the MLP's columns
    split on both; the tied embedding whole; no sequence parallelism. The
    local leaves are the split dense layers at their ``model`` entry."""
    cfg = get_arch("whisper-large-v3")
    shape = dict(data=2, model=4) if mesh == "2x4" else dict(data=16,
                                                             model=16)
    M = shape["model"]
    for r in (0, M - 1):
        dist = make_dist(FakeMesh({"data": 0, "model": r}, **shape))
        tp = build_model(cfg, "cpu", dist).plan()
        assert tp.cols == ENCDEC_LEAVES
        assert (tp.heads, tp.ffn, tp.vocab, tp.seq) == (heads, True, False,
                                                        False)
        assert tp.splits
        if heads:
            assert (tp.n_q, tp.q_lo, tp.n_kv, tp.kv_lo) == (5, 5 * r, 5,
                                                            5 * r)
    local = build_model(cfg, "cpu", dist).local_leaves
    assert set(local) == {k + "/w" for k in ENCDEC_LEAVES}
    assert local["dec_layers/self/wq/w"] == P(None, None, "model")
    assert "embed" not in local


@pytest.mark.parametrize("over,heads", [
    (dict(d_model=256, d_ff=512, n_heads=8, kv_heads=8, head_dim=32), True),
    (dict(d_model=256, d_ff=512, n_heads=2, kv_heads=2, head_dim=128),
     False),
    ({}, None),
])
def test_plan_of_the_reduced_whisper(over, heads):
    """The reduced whisper splits nothing (every leaf under 2^16 elements
    rests replicated); widened to d_model 256 it splits every dense layer,
    in whole heads at 8 heads of 32 on a ``model`` axis of 4 and cutting
    them at 2 heads of 128."""
    cfg = dataclasses.replace(get_arch("whisper-large-v3").reduced(), **over)
    tp = build_model(cfg, "cpu", make_dist(FakeMesh(data=2, model=4))).plan()
    if heads is None:
        assert not tp.cols and not tp.splits and not tp.heads
        return
    assert tp.cols == ENCDEC_LEAVES and tp.ffn and tp.heads == heads


@pytest.mark.parametrize("mesh", ["2x4", "16x16"])
def test_plan_of_zamba2_splits_nothing(mesh):
    """The hybrid rests pure FSDP: its plan carries the ``model`` group,
    size and rank for the shared block's cache and splits nothing; RWKV6
    (pure DP) has no plan."""
    shape = dict(data=2, model=4) if mesh == "2x4" else dict(data=16,
                                                             model=16)
    dist = make_dist(FakeMesh({"data": 0, "model": 3}, **shape))
    tp = tpm.plan(get_arch("zamba2-2.7b"), dist)
    assert (tp.size, tp.rank) == (shape["model"], 3)
    assert not (tp.heads or tp.ffn or tp.vocab or tp.seq or tp.cols)
    assert not tp.splits
    assert build_model(get_arch("zamba2-2.7b"), "cpu", dist).local_leaves \
        == {}
    assert tpm.plan(get_arch("rwkv6-3b"), dist) is None
