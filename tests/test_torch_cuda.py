"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU and the CUDA toolkit (marker ``cuda``); without a GPU
each test skips. This file imports no JAX, so it also runs on a machine
with the card and no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import ops, ref

TOLS = {"flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
        "flash_decode": {"float32": 2e-5, "bfloat16": 3e-2}}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = TDT[dtype]
    for B, H, KVH, S, D in [(2, 8, 2, 100, 64), (1, 4, 4, 33, 128),
                            (2, 4, 1, 64, 16)]:
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda")
                   .to(dt).transpose(1, 2) for h in (H, KVH, KVH))
        for causal in (True, False):
            got = ops.flash_attention(q, k, v, causal=causal)
            want = ref.attention_ref(q, k, v, causal=causal)
            tol = TOLS["flash_attention"][dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
        kc = torch.randn(B, S + 7, KVH, D, generator=gen, device="cuda").to(dt)
        lengths = torch.randint(1, S + 8, (B,), generator=gen, device="cuda",
                                dtype=torch.int32)
        args = (q[:, :, 0], kc.permute(0, 2, 1, 3), kc.permute(0, 2, 1, 3),
                lengths)
        tol = TOLS["flash_decode"][dtype]
        torch.testing.assert_close(ops.flash_decode(*args).float(),
                                   ref.decode_attention_ref(*args).float(),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_chacha20_matches_plain_bit_exact():
    """Bit-exact against the plain version, across the 2^32 counter wrap
    and at block counts that are no multiple of the 256-thread block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    key, nonce = (torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                                generator=gen, device="cuda")
                  .view(torch.uint32) for n in (8, 3))
    for counter0, n_blocks in [(0, 1), (1, 256), (2**32 - 3, 1000),
                               (12345, 4097)]:
        got = ops.chacha20_keystream(key, nonce, counter0, n_blocks)
        want = ref.chacha20_keystream_ref(key, nonce, counter0, n_blocks)
        assert got.shape == (n_blocks, 16) and got.dtype == torch.uint32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4, 6, 16])
def test_cuda_decode_split_edges(dtype, G):
    """Split-KV decode at chunk edges: lengths 1, 63, 64, 65 and S over a
    cache the planner cuts into 64-position chunks, chunks wholly past the
    length (which read nothing), and a length of 0, which gives 0."""
    from repro_torch.kernels import decode_attention as fd
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(G)
    dt, KVH, S, D = TDT[dtype], 2, 576, 64
    splits, chunk = fd.plan_splits(5, KVH, S, fd.sm_count(0))
    assert splits > 1 and chunk == 64
    q = torch.randn(5, KVH * G, D, generator=gen, device="cuda").to(dt)
    kc, vc = (torch.randn(5, S, KVH, D, generator=gen, device="cuda").to(dt)
              .permute(0, 2, 1, 3) for _ in range(2))
    tol = TOLS["flash_decode"][dtype]
    for lens in ([1, 63, 64, 65, S], [0, 128, 0, 129, 2]):
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = ops.flash_decode(q, kc, vc, lengths).float()
        want = ref.decode_attention_ref(q, kc, vc, lengths).float()
        split = ref.decode_attention_split_ref(q, kc, vc, lengths,
                                               chunk=chunk).float()
        for b, n in enumerate(lens):
            if n == 0:
                assert torch.equal(got[b], torch.zeros_like(got[b]))
            else:
                torch.testing.assert_close(got[b], want[b], rtol=tol,
                                           atol=tol)
        torch.testing.assert_close(got, split, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [33, 77, 500, 8192])
@pytest.mark.parametrize("D", [16, 128])
def test_cuda_attention_kernels_gqa12(dtype, S, D):
    """Both kernels at a GQA group of 12 (one KV head, twelve query heads),
    ragged S, the model's transpose and permute views."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(S + D)
    dt, B, KVH, G = TDT[dtype], 1 if S == 8192 else 2, 1, 12
    q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda")
               .to(dt).transpose(1, 2) for h in (KVH * G, KVH, KVH))
    tol = TOLS["flash_attention"][dtype]
    for causal in (True, False):
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, causal=causal).float(),
            ref.attention_ref(q, k, v, causal=causal).float(),
            rtol=tol, atol=tol)
    lengths = torch.tensor([S, max(1, S // 3)][:B], dtype=torch.int32,
                           device="cuda")
    args = (q[:, :, -1], k, v, lengths)
    tol = TOLS["flash_decode"][dtype]
    torch.testing.assert_close(ops.flash_decode(*args).float(),
                               ref.decode_attention_ref(*args).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [40, 512])
@pytest.mark.parametrize("G", [1, 2])
def test_cuda_flash_attention_mla_head_dims(dtype, S, G):
    """``flash_attention`` at MLA's head dims, q/k 192 and v 128, with the
    model's operands: q and k concatenated [B,S,H,192], v a slice of the
    decompressed [B,S,H,256] (row stride 256), all as transpose views. MLA
    has G 1; an even G takes the same one-warpgroup kernel."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(S + G)
    dt, B, H = TDT[dtype], 2, 4
    q = (torch.randn(B, S, H, 192, generator=gen, device="cuda").to(dt)
         .transpose(1, 2))
    k = (torch.randn(B, S, H // G, 192, generator=gen, device="cuda").to(dt)
         .transpose(1, 2))
    kv = torch.randn(B, S, H // G, 256, generator=gen, device="cuda").to(dt)
    v = kv[..., 128:].transpose(1, 2)
    tol = TOLS["flash_attention"][dtype]
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal)
        assert got.shape == (B, H, S, 128)
        assert got.transpose(1, 2).is_contiguous()
        torch.testing.assert_close(
            got.float(), ref.attention_ref(q, k, v, causal=causal).float(),
            rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_attention_kernels_grok_serve_shapes(dtype):
    """Both kernels at grok-1's published heads (48 query heads on 8 KV
    heads, group 6, D 128) and the shapes its serving gives them: a causal
    512-token prefill, and decode over a 528-position cache, which the
    split planner cuts into chunks with a ragged last one."""
    from repro_torch.configs import get_arch
    _needs_card()
    cfg = get_arch("grok-1-314b")
    H, KVH, D = cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    assert H // KVH == 6
    gen = torch.Generator(device="cuda").manual_seed(6)
    dt = TDT[dtype]
    q, k, v = (torch.randn(1, 512, h, D, generator=gen, device="cuda")
               .to(dt).transpose(1, 2) for h in (H, KVH, KVH))
    tol = TOLS["flash_attention"][dtype]
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=True).float(),
        ref.attention_ref(q, k, v, causal=True).float(), rtol=tol, atol=tol)
    kc, vc = (torch.randn(1, 528, KVH, D, generator=gen, device="cuda")
              .to(dt).permute(0, 2, 1, 3) for _ in range(2))
    q1 = torch.randn(1, H, D, generator=gen, device="cuda").to(dt)
    tol = TOLS["flash_decode"][dtype]
    for n in (512, 513, 520, 527):
        args = (q1, kc, vc, torch.tensor([n], dtype=torch.int32,
                                         device="cuda"))
        torch.testing.assert_close(ops.flash_decode(*args).float(),
                                   ref.decode_attention_ref(*args).float(),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [80, 160])
@pytest.mark.parametrize("G", [1, 2, 4, 16])
def test_cuda_attention_kernels_head_dims_80_160(dtype, D, G):
    """Both kernels at the head dims whose rows are no power of two of
    16-byte vectors: 80 (zamba2-2.7b's shared block, G 1) and 160
    (stablelm-12b, G 4), with one and two warpgroups a prefill block and
    decode groups up to 16 (D 160 at G 16 reuses the query heads' shared
    memory for the partials). Ragged S, the model's transpose and permute
    views; decode over a cache the split planner cuts, at lengths inside,
    at and past a chunk's edge."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(D + G)
    dt, B, KVH = TDT[dtype], 2, 2
    for S in (33, 200):
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda")
                   .to(dt).transpose(1, 2) for h in (KVH * G, KVH, KVH))
        tol = TOLS["flash_attention"][dtype]
        for causal in (True, False):
            torch.testing.assert_close(
                ops.flash_attention(q, k, v, causal=causal).float(),
                ref.attention_ref(q, k, v, causal=causal).float(),
                rtol=tol, atol=tol)
    kc, vc = (torch.randn(B, 528, KVH, D, generator=gen, device="cuda")
              .to(dt).permute(0, 2, 1, 3) for _ in range(2))
    q1 = torch.randn(B, KVH * G, D, generator=gen, device="cuda").to(dt)
    tol = TOLS["flash_decode"][dtype]
    for lengths in ((1, 64), (512, 513), (527, 0)):
        args = (q1, kc, vc, torch.tensor(lengths, dtype=torch.int32,
                                         device="cuda"))
        torch.testing.assert_close(ops.flash_decode(*args).float(),
                                   ref.decode_attention_split_ref(
                                       *args, chunk=64).float(),
                                   rtol=tol, atol=tol)


def _moe_configs():
    """1-layer MoE configs at reduced width: grok-1's (GQA, head dim 16)
    and deepseek-v3's with MLA's published head dims (nope 128, rope 64,
    v 128), which the kernel takes."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import MLAConfig
    grok = dataclasses.replace(get_arch("grok-1-314b").reduced(),
                               n_layers=1)
    ds = get_arch("deepseek-v3-671b").reduced()
    ds = dataclasses.replace(ds, n_layers=1, mla=dataclasses.replace(
        ds.mla, rope_head_dim=64, nope_head_dim=128, v_head_dim=128))
    assert isinstance(ds.mla, MLAConfig)
    return {"grok-1-314b": grok, "deepseek-v3-671b": ds}


def _greedy_on_card_and_cpu(cfg):
    """One set of weights (from the CPU model's init) in fp32 on the card
    (the kernels) and on the CPU (the plain versions): a 40-token prefill
    of 2 sequences and 4 greedy steps each. Returns (card logits, CPU
    logits, the card run's kernel launches)."""
    from repro_torch.models.api import build_model
    cpu, card = build_model(cfg, "cpu"), build_model(cfg, "cuda")
    params = cpu.init(torch.Generator().manual_seed(0))

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))

    def greedy(model, p, dev):
        t = toks.to(dev)
        cache = model.init_cache(p, {"tokens": t}, 2, 48)
        logits, cache = model.prefill(p, {"tokens": t}, cache)
        out, tok = [logits], logits.argmax(-1)[:, None]
        lengths = torch.full((2,), 40, dtype=torch.int32, device=dev)
        for _ in range(4):
            logits, cache = model.decode_step(p, cache, tok, lengths)
            out.append(logits)
            tok, lengths = logits.argmax(-1)[:, None], lengths + 1
        return torch.stack(out).cpu()

    ops.reset_launch_counts()
    got = greedy(card, to(params, "cuda"), "cuda")
    launches = ops.launch_counts()
    return got, greedy(cpu, params, "cpu"), launches


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v3-671b"])
def test_cuda_moe_model_matches_cpu(arch):
    """A 1-layer reduced-width MoE model in fp32 on the card (the kernels,
    ``index_add_`` in the card's order) against the same weights on the
    CPU (the plain versions): prefill and 4 greedy steps, logits at 1e-4
    and equal tokens."""
    _needs_card()
    got, want, launches = _greedy_on_card_and_cpu(_moe_configs()[arch])
    assert launches["flash_attention"] == 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.cuda
def test_cuda_hybrid_model_matches_cpu():
    """zamba2's reduced config with the shared block at the published head
    dim 80 (2 heads), fp32 on the card (the kernels, the SSD scan's
    products on the card) against the same weights on the CPU (the plain
    versions): a 40-token prefill (the chunk of 16 shrunk to 10) and 4
    greedy steps, logits at 1e-4 and equal tokens; one
    ``flash_attention`` launch a group in prefill, one ``flash_decode`` a
    group a step."""
    import dataclasses

    from repro_torch.configs import get_arch
    _needs_card()
    cfg = dataclasses.replace(get_arch("zamba2-2.7b").reduced(), n_heads=2,
                              kv_heads=2, head_dim=80)
    groups = cfg.n_layers // cfg.hybrid.shared_attn_every
    got, want, launches = _greedy_on_card_and_cpu(cfg)
    assert launches["flash_attention"] == groups
    assert launches["flash_decode"] == 4 * groups
    assert launches["mamba2_step"] == 4 * cfg.n_layers * 2
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


# the published Zamba2-2.7B's Mamba2 layer (80 heads of 64, d_state 64, one
# group, a 4-tap conv), and a small one with two groups of B and C heads
MAMBA2_SHAPES = {"published": dict(nh=80, hd=64, N=64, G=1, K=4),
                 "groups": dict(nh=8, hd=16, N=16, G=2, K=4)}
MAMBA2_TOLS = {"float32": 2e-5, "bfloat16": 2e-2}


def _mamba2_operands(B, nh, hd, N, G, K, dtype, gen):
    """A Mamba2 step's operands on the card: zx and the weights in
    ``dtype``, the window, the state, dt_bias, A_log and D in fp32."""
    d_in, cc = nh * hd, nh * hd + 2 * G * N

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")
                ).to(dt)

    p = {"conv_w": rnd(K, cc, scale=0.3, dt=dtype),
         "conv_b": rnd(cc, scale=0.1, dt=dtype),
         "dt_bias": rnd(nh, scale=0.5) - 2.0,
         "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device="cuda")),
         "D": rnd(nh), "out_norm": (rnd(d_in, scale=0.1) + 1).to(dtype)}
    zx = rnd(B, 2 * d_in + 2 * G * N + nh, dt=dtype)
    return zx, rnd(B, K - 1, cc, scale=0.5), rnd(B, nh, hd, N, scale=0.3), p


def _mamba2_step_pair(zx, conv, h, p, eps=1e-5):
    """(kernel's y, conv, h), (plain version's y, conv, h) from copies of
    the same window and state."""
    from repro_torch.kernels import mamba2_step as m2
    kc, kh, pc, ph = conv.clone(), h.clone(), conv.clone(), h.clone()
    got = m2.mamba2_step(zx, kc, kh, *p.values(), eps)
    want = ref.mamba2_step_ref(zx, pc, ph, *p.values(), eps)
    return (got, kc, kh), (want, pc, ph)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("shape", ["published", "groups"])
def test_cuda_mamba2_step_matches_plain(shape, B, dtype):
    """The Mamba2 step kernel against its plain version on the card: the
    window bit for bit, the fp32 state within 1e-5, y within the dtype's
    tolerance; the kernel writes the window and the state in place."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(B)
    zx, conv, h, p = _mamba2_operands(B, **MAMBA2_SHAPES[shape],
                                      dtype=TDT[dtype], gen=gen)
    (got, kc, kh), (want, pc, ph) = _mamba2_step_pair(zx, conv, h, p)
    assert got.dtype == want.dtype == TDT[dtype]
    assert not torch.equal(kh, h) and not torch.equal(kc, conv)
    assert torch.equal(kc, pc)
    torch.testing.assert_close(kh, ph, rtol=0, atol=1e-5)
    tol = MAMBA2_TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_mamba2_step_64_steps_in_place():
    """64 steps of the kernel on one window and state, in place, against
    64 of the plain version, bf16 at the published shapes (B 4): every
    step's y within 2e-2, the final state within 1e-5."""
    from repro_torch.kernels import mamba2_step as m2
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(64)
    zx, conv, h, p = _mamba2_operands(4, **MAMBA2_SHAPES["published"],
                                      dtype=torch.bfloat16, gen=gen)
    kc, kh, pc, ph = conv.clone(), h.clone(), conv.clone(), h.clone()
    for _ in range(64):
        zx = torch.randn(zx.shape, generator=gen, device="cuda").to(zx.dtype)
        got = m2.mamba2_step(zx, kc, kh, *p.values(), 1e-5)
        want = ref.mamba2_step_ref(zx, pc, ph, *p.values(), 1e-5)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
    assert torch.equal(kc, pc)
    torch.testing.assert_close(kh, ph, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_mamba2_step_replays_in_a_cuda_graph():
    """One call captured in a CUDA graph and replayed 8 times on new
    inputs gives the eager calls' outputs and state, bit for bit; the
    capture counts its two launches once, the replays none."""
    from repro_torch.kernels import mamba2_step as m2
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    zx, conv, h, p = _mamba2_operands(1, **MAMBA2_SHAPES["published"],
                                      dtype=torch.bfloat16, gen=gen)
    zxs = [torch.randn(zx.shape, generator=gen, device="cuda").to(zx.dtype)
           for _ in range(8)]
    ec, eh = conv.clone(), h.clone()
    eager = [m2.mamba2_step(z, ec, eh, *p.values(), 1e-5) for z in zxs]
    gc, gh, static = conv.clone(), h.clone(), zx.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the capture
        m2.mamba2_step(static, gc.clone(), gh.clone(), *p.values(), 1e-5)
    torch.cuda.current_stream().wait_stream(side)
    ops.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = m2.mamba2_step(static, gc, gh, *p.values(), 1e-5)
    gc.copy_(conv)
    gh.copy_(h)
    replayed = []
    for z in zxs:
        static.copy_(z)
        graph.replay()
        replayed.append(out.clone())
    torch.cuda.synchronize()
    assert ops.launch_counts()["mamba2_step"] == m2.LAUNCHES_PER_CALL
    for a, b in zip(replayed, eager):
        assert torch.equal(a, b)
    assert torch.equal(gc, ec) and torch.equal(gh, eh)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_cross_attention(dtype):
    """``flash_attention`` with queries and keys of lengths of their own,
    not causal: whisper's cross-attention (B1 H20 Sq64 Skv1500 D64) and
    encoder (Sq = Skv = 1500), and ragged lengths on either side of a tile
    (Skv 1 and 65, Sq 1 and 130), GQA groups 1 to 4 and every head dim
    class, the model's transpose views; causal at Sq != Skv is refused."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(17)
    dt = TDT[dtype]
    tol = TOLS["flash_attention"][dtype]
    for B, H, KVH, Sq, Skv, D in [(1, 20, 20, 64, 1500, 64),
                                  (1, 20, 20, 1500, 1500, 64),
                                  (2, 8, 2, 33, 100, 128), (1, 4, 4, 130, 1, 16),
                                  (2, 8, 4, 1, 65, 32), (1, 4, 1, 70, 129, 80),
                                  (1, 8, 2, 20, 200, 160)]:
        q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(B, Skv, KVH, D, generator=gen, device="cuda")
                .to(dt) for _ in range(2))
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        got = ops.flash_attention(*args, causal=False)
        assert got.shape == (B, H, Sq, D) and got.dtype == dt
        torch.testing.assert_close(
            got.float(), ref.attention_ref(*args, causal=False).float(),
            rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="causal attention needs Sq == Skv"):
        ops.flash_attention(*args, causal=True)


@pytest.mark.cuda
def test_cuda_encdec_model_matches_cpu():
    """whisper's reduced config at its published head dim 64 (2 heads)
    over 150 frames, fp32 on the card (the kernels) against the same
    weights on the CPU (the plain versions): the encoder in
    ``init_cache`` and ``prefill`` (Sq = Skv = 150, not causal), the
    decoder's prefill (causal, and cross-attention at Sq 12, Skv 150),
    then the self-KV filled step by step and 4 greedy steps; logits at
    1e-4 and equal tokens, each kernel launched once a layer a call."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.api import build_model
    _needs_card()
    base = get_arch("whisper-large-v3").reduced()
    cfg = dataclasses.replace(base, n_heads=2, kv_heads=2, head_dim=64,
                              enc_dec=dataclasses.replace(base.enc_dec,
                                                          n_frames=150))
    cpu, card = build_model(cfg, "cpu"), build_model(cfg, "cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    frames = torch.randn(2, 150, cfg.d_model, generator=gen) * 0.1

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    def run(model, p, dev):
        batch = {"tokens": toks.to(dev), "frames": frames.to(dev)}
        cache = model.init_cache(p, batch, 2, 20)
        logits, cache = model.prefill(p, batch, cache)
        out, lengths = [logits], torch.zeros((2,), dtype=torch.int32,
                                             device=dev)
        for t in range(12):
            logits, cache = model.decode_step(p, cache, batch["tokens"][
                :, t:t + 1], lengths)
            lengths = lengths + 1
        for _ in range(4):
            out.append(logits)
            logits, cache = model.decode_step(
                p, cache, logits.argmax(-1)[:, None], lengths)
            lengths = lengths + 1
        return torch.stack(out + [logits]).cpu()

    ops.reset_launch_counts()
    got = run(card, to(params, "cuda"), "cuda")
    launches = ops.launch_counts()
    want = run(cpu, params, "cpu")
    L = cfg.n_layers
    assert launches["flash_attention"] == 4 * L
    assert launches["flash_decode"] == 2 * L * 16
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_backward_matches_autograd_of_plain(dtype):
    """The registered backward behind the kernel's forward against
    autograd through the plain version, on the card: causal GQA, MLA's
    head dims, head dim 80 and cross-attention (Sq != Skv), with the
    model's transpose views. fp32 at 1e-4 of each grad's scale; bf16 at
    2e-2 (the backward's math is fp32 in both; the forward differs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    dt = TDT[dtype]
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    for B, H, KVH, Sq, Skv, D, Dv, causal in [
            (2, 16, 16, 256, 256, 64, 64, True),
            (2, 8, 2, 200, 200, 128, 128, True),
            (1, 4, 4, 130, 130, 192, 128, True),
            (1, 8, 8, 96, 96, 80, 80, True),
            (2, 4, 4, 64, 300, 64, 64, False)]:
        q = torch.randn(B, Sq, H, D, generator=gen, device="cuda")
        k = torch.randn(B, Skv, KVH, D, generator=gen, device="cuda")
        v = torch.randn(B, Skv, KVH, Dv, generator=gen, device="cuda")
        do = torch.randn(B, H, Sq, Dv, generator=gen, device="cuda").to(dt)
        grads = []
        for fn in (ops.flash_attention, ref.attention_ref):
            leaves = [t.to(dt).requires_grad_() for t in (q, k, v)]
            out = fn(*(t.transpose(1, 2) for t in leaves), causal=causal)
            grads.append(torch.autograd.grad(out, leaves, do))
        for g, w in zip(*grads):
            assert g.dtype == dt and torch.isfinite(g.float()).all()
            scale = w.float().abs().max().item()
            err = (g.float() - w.float()).abs().max().item()
            assert err <= tol * scale, (B, H, KVH, Sq, Skv, D, err, scale)


@pytest.mark.cuda
def test_cuda_bf16_unembed_backward_matches_fp32_sums():
    """The card's bf16 ``unembed`` (fp32-output matmul with its own
    autograd) gives the logits and gradients of the same bf16 operands
    widened to fp32, within bf16's rounding of the logits' gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.models.layers import unembed
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(2, 64, 256, generator=gen, device="cuda")
    w = torch.randn(1000, 256, generator=gen, device="cuda") * 0.1
    g = torch.randn(2, 64, 1000, generator=gen, device="cuda")
    grads = []
    for widen in (False, True):
        xl, wl = (t.to(torch.bfloat16).requires_grad_() for t in (x, w))
        out = (unembed(xl.float(), wl.float(), torch.float32) if widen
               else unembed(xl, wl, torch.bfloat16))
        assert out.dtype == torch.float32
        grads.append((out.detach(), *torch.autograd.grad(out, (xl, wl), g)))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.cuda
def test_cuda_world_of_one_nccl_matches_single_device(tmp_path):
    """A world-1 NCCL group on a (1, 1) mesh: the MoE's a2a body against
    ``moe_local`` (fp32, no drops), and one sharded train step of the
    reduced qwen1.5-0.5b (FSDP, then ZeRO-1) against the single-device
    step from the same state: the loss and every parameter bit for bit
    (the gathers hand the products contiguous weights, as one device
    does, so the same kernels run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL has no CPU mode)")
    import dataclasses

    import torch.distributed as tdist
    from repro_torch.bridge import flatten
    from repro_torch.configs import get_arch
    from repro_torch.dist.context import make_dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import (gather_train_state, init_train_state,
                                        make_train_step, shard_train_state)
    from repro_torch.train.optimizer import OptConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                             world_size=1, rank=0)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"))
        cfg = get_arch("grok-1-314b").reduced()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = build_model(cfg, "cuda").init(gen)["layers"]["moe"]
        p = {k: v[0] if k != "shared" else v for k, v in p.items()}
        x = torch.randn(64, cfg.d_model, generator=gen, device="cuda")
        want, _ = moe.moe_local(p, x, cfg)
        got, aux = moe._moe_a2a_body(p, x, cfg, moe.expert_layout(cfg, 1),
                                     make_dist(mesh))
        assert float(aux["drop_frac"]) == 0.0
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))

        cfg = get_arch("qwen1.5-0.5b").reduced()
        opt = OptConfig(lr=1e-3)
        batch = {k: torch.randint(0, cfg.vocab, (4, 64), generator=gen,
                                  device="cuda") for k in ("tokens",
                                                           "targets")}
        single = build_model(cfg, "cuda")
        state = init_train_state(single, torch.Generator(
            device="cuda").manual_seed(1), opt)
        s1, m1 = make_train_step(single, opt)(state, batch)
        for zero1 in (False, True):
            model = build_model(cfg, "cuda", make_dist(mesh, zero1=zero1))
            s2, m2 = make_train_step(model, opt)(
                shard_train_state(state, model, opt), batch)
            assert float(m1["loss"]) == float(m2["loss"])
            full = flatten(gather_train_state(s2, model, opt)["params"])
            for k, w in flatten(s1["params"]).items():
                assert torch.equal(full[k], w.detach()), (zero1, k)
    finally:
        tdist.destroy_process_group()
