"""The port's analysis (``repro_torch.analysis``) against the reference's
(``repro.analysis``): cost-model properties, the custom ops as single
leaves, region segmentation invariants, the kernel and model timelines
against the reference's at reduced and full width, the static-vs-counter
differential, and the calibration entry point.

Everything runs on the CPU: models at full width on the meta device,
where nothing is allocated; the kernels' plain versions stand in for the
kernels because the tensors lie on the CPU.
"""
import hashlib
import json

import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.analysis import calibrate as jcal
from repro.analysis.regions import segment as jsegment
from repro.analysis.regions import tag_heavy as jtag_heavy
from repro.kernels.chacha20 import _keystream
from repro_torch.analysis import calibrate
from repro_torch.analysis.costs import op_cost
from repro_torch.analysis.differential import differential
from repro_torch.analysis.regions import (LEVEL_NAMES, MachineModel, Region,
                                          RegionTimeline, fn_cost,
                                          rank_functions, record, report,
                                          segment, tag_heavy)
from repro_torch.kernels import library, ops

pallas_keystream_body = _keystream.__wrapped__
PORTED = ["qwen1.5-0.5b", "codeqwen1.5-7b", "stablelm-12b",
          "starcoder2-15b", "chameleon-34b", "grok-1-314b",
          "deepseek-v3-671b", "zamba2-2.7b", "rwkv6-3b", "whisper-large-v3"]


def _u32_zeros(n, device="cpu"):
    return torch.zeros(n, dtype=torch.int32, device=device).view(torch.uint32)


# --------------------------------------------------- cost-model properties


def test_cost_additivity_over_composition():
    x, w = torch.zeros(8, 32), torch.zeros(32, 32)

    def four(x):
        for _ in range(4):
            x = x @ w
        return x

    c1, c4 = fn_cost(lambda x: x @ w, x), fn_cost(four, x)
    assert c4.mxu_flops == pytest.approx(4 * c1.mxu_flops)
    assert c4.flops == pytest.approx(4 * c1.flops)
    assert c4.bytes == pytest.approx(4 * c1.bytes)


@pytest.mark.parametrize("name,fn,args,mnk", [
    ("mm", torch.mm, (torch.zeros(8, 32), torch.zeros(32, 16)), (8, 16, 32)),
    ("addmm", torch.addmm,
     (torch.zeros(16), torch.zeros(8, 32), torch.zeros(32, 16)), (8, 16, 32)),
    ("bmm", torch.bmm, (torch.zeros(3, 8, 32), torch.zeros(3, 32, 16)),
     (24, 16, 32)),
    ("baddbmm", torch.baddbmm,
     (torch.zeros(3, 8, 16), torch.zeros(3, 8, 32), torch.zeros(3, 32, 16)),
     (24, 16, 32)),
    ("convolution", torch.nn.functional.conv1d,
     (torch.zeros(2, 4, 10), torch.zeros(6, 4, 3)), (2 * 8, 6, 4 * 3)),
])
def test_matrix_product_flops_are_2mnk(name, fn, args, mnk):
    leaves = record(fn, *args)
    assert [n for n, _ in leaves] == [name]
    c = leaves[0][1]
    M, N, K = mnk
    assert c.mxu_flops == c.flops == 2 * M * N * K
    nbytes = sum(4 * a.numel() for a in args) + 4 * M * N
    assert c.bytes == nbytes


def test_dtype_aware_bytes():
    def f(x):
        return x * 2.0 + 1.0

    b32 = fn_cost(f, torch.zeros(64, 64)).bytes
    b16 = fn_cost(f, torch.zeros(64, 64, dtype=torch.bfloat16)).bytes
    assert b32 == pytest.approx(2 * b16)


def test_views_cost_nothing():
    x = torch.zeros(4, 8, 16)
    for fn in (lambda x: x.view(32, 16), lambda x: x.transpose(0, 1),
               lambda x: x.permute(2, 0, 1), lambda x: x[1:3, 2],
               lambda x: x.unsqueeze(0).expand(2, 4, 8, 16),
               lambda x: x.reshape(4, 128), lambda x: x.t() if x.dim() == 2
               else x[0].t()):
        leaves = record(fn, x)
        assert leaves == [], leaves
    c = op_cost(torch.ops.aten.transpose.int, (x, 0, 1), {},
                x.transpose(0, 1))
    assert c.flops == c.bytes == c.mxu_flops == 0.0


def test_copies_count_bytes_not_flops():
    x = torch.zeros(4, 8)
    leaves = record(lambda x: x.clone(), x)
    assert leaves[0][0] == "clone"
    assert leaves[0][1].flops == 0 and leaves[0][1].bytes == 2 * 4 * 32


# ------------------------------------------------------------ custom ops


def _kernel_args(device):
    dev = torch.device(device)
    q = torch.zeros(1, 2, 16, 16, device=dev)
    kv = torch.zeros(1, 2, 24, 16, device=dev)
    return {
        "flash_attention": (ops.flash_attention, (q, q, q), (1, 2, 16, 16),
                            torch.float32),
        "flash_decode": (ops.flash_decode,
                         (q[:, :, 0], kv, kv,
                          torch.full((1,), 5, dtype=torch.int32, device=dev)),
                         (1, 2, 16), torch.float32),
        "chacha20_keystream": (
            lambda k, n: ops.chacha20_keystream(k, n, 3, 10),
            (_u32_zeros(8, dev), _u32_zeros(3, dev)), (10, 16),
            torch.uint32),
    }


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("op", ["flash_attention", "flash_decode",
                                "chacha20_keystream"])
def test_custom_op_is_one_op_with_the_right_output(op, device):
    """On the CPU the op runs the plain version and launches nothing; on
    meta it only allocates; a dispatch mode sees it as one op."""
    fn, args, shape, dtype = _kernel_args(device)[op]

    class Seen(TorchDispatchMode):
        names = []

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            self.names.append(func._schema.name)
            return func(*a, **(kw or {}))

    ops.reset_launch_counts()
    with Seen() as seen:
        out = fn(*args)
    assert seen.names == [f"repro_torch::{op}"]
    assert out.shape == shape and out.dtype == dtype
    assert out.device.type == device
    assert set(ops.launch_counts().values()) == {0}
    assert f"repro_torch::{op}" in library.KERNEL_FLOPS


# ------------------------------------------------- region segmentation


def test_region_totals_equal_summed_costs():
    """Segmentation is a partition: region sums reproduce the summed op
    costs exactly."""
    x, w = torch.zeros(8, 32), torch.zeros(32, 32)

    def f(x):
        for _ in range(4):
            x = torch.tanh(x @ w)
        return (x @ w).sum()

    tl = segment(f, x, name="f", fold_frac=0.0)
    c = fn_cost(f, x)
    assert tl.mxu_flops == pytest.approx(c.mxu_flops)
    assert tl.flops == pytest.approx(c.flops)
    assert tl.bytes == pytest.approx(c.bytes)
    assert [r.unit for r in tl.regions][:3] == ["tensor", "vector", "tensor"]
    assert all(r.trips == 1 for r in tl.regions)


def test_fold_absorbs_sub_permille_regions():
    x, w = torch.zeros(256, 256), torch.zeros(256, 256)

    def f(x):
        y = x @ w
        s = y[0, 0] + 1.0        # tiny scalar bookkeeping between products
        return (y @ w) * s

    raw = segment(f, x, fold_frac=0.0)
    folded = segment(f, x)
    assert [r.unit for r in raw.regions] == ["tensor", "scalar", "tensor",
                                             "vector"]
    assert [r.unit for r in folded.regions] == ["tensor", "vector"]
    assert folded.flops == pytest.approx(raw.flops)


def test_tag_heavy_duty_criterion():
    """Tagging needs BOTH a heavy time share and a non-trivial share of
    the cohort's heavy time (copied from the reference's test)."""
    big = RegionTimeline("prefill", [Region(0, 0, 2, 1e9, 1e9, 1e6,
                                            est_us=1000.0)], [])
    tiny = RegionTimeline("decode", [Region(0, 0, 2, 1e3, 1e3, 1e3,
                                            est_us=0.5)], [])
    cold = RegionTimeline("embed", [Region(0, 0, 0, 0.0, 1e3, 1e6,
                                           est_us=500.0)], [])
    assert tag_heavy([big, tiny, cold]) == ["prefill"]


def test_rank_functions_orders_by_heavy_ratio():
    """The reference's whole-function report: matmul-heavy first."""
    x, w = torch.zeros(64, 64), torch.zeros(64, 64)
    profs = rank_functions([("pointwise", lambda x: x * 2.0 + 1.0, (x,)),
                            ("matmul", lambda x: torch.tanh(x @ w), (x,))])
    assert [p.name for p in profs] == ["matmul", "pointwise"]
    assert profs[1].heavy_ratio == 0.0
    assert profs[0].heavy_ratio == pytest.approx(
        2 * 64 ** 3 / (2 * 64 ** 3 + 64 * 64))
    assert report(profs).splitlines()[1].startswith("matmul")


def test_machine_model_is_the_h100_data_sheet():
    m = MachineModel()
    assert (m.tensor_flops_per_s, m.vector_flops_per_s,
            m.hbm_bytes_per_s) == (989e12, 67e12, 3.35e12)
    assert LEVEL_NAMES == ("scalar", "vector", "tensor")


# ------------------------------------------------------- kernel timelines


@pytest.fixture(scope="module")
def kernel_tls():
    return {t.name: t for t in calibrate.kernel_timelines(device="cpu")}


def test_chacha20_timeline_is_vector_class_like_the_reference(kernel_tls):
    """Level 1, no tensor-core flops, tagged heavy; flops within 5% of the
    reference's static count at 256 blocks (430,352: 1,681 a block with
    its state set-up, against the port's 1,616 a block from the kernel's
    arithmetic, 3.9% fewer)."""
    tl = kernel_tls["chacha20"]
    assert [r.level for r in tl.regions] == [1]
    assert tl.mxu_flops == 0.0
    assert tl.flops == 256 * library.CHACHA20_OPS_PER_BLOCK == 413_696
    key = jnp.zeros((8,), jnp.uint32)
    nonce = jnp.zeros((3,), jnp.uint32)
    ctr = jnp.asarray([1], jnp.uint32)
    # traced below the kernel's jit wrapper: jax 0.9 calls the jit
    # primitive `jit`, which the reference's walker (written for `pjit`)
    # does not descend (its failing test_scan_multiplies_through_nested_pjit)
    ref = jsegment(lambda k, n: pallas_keystream_body(
        k, n, ctr, n_blocks=256, tile=256, interpret=True), key, nonce)
    assert ref.flops == 430_352
    assert tl.flops == pytest.approx(ref.flops, rel=0.05)
    assert tag_heavy([tl]) == ["chacha20"]


def test_attention_timelines_match_the_reference_tensor_flops(kernel_tls):
    """The reference's artifact: 536,870,912 MXU flops for flash_attention
    at (1,8,512,64) and 2,097,152 for flash_decode over a 1,024-position
    cache; both tensor class and tagged."""
    ref = json.loads(jcal.DERIVED_PATH.read_text())["kernels"]
    for name in ("flash_attention", "flash_decode"):
        tl = kernel_tls[name]
        assert tl.mxu_flops == ref[name]["mxu_flops"]
        assert [r.unit for r in tl.regions] == ["tensor"]
        assert tag_heavy([tl]) == [name]


# ------------------------------------------------- models vs the reference


@pytest.mark.parametrize("arch", PORTED)
def test_reduced_model_timelines_match_the_reference(arch):
    """Reduced configs, the port's meta trace against the reference's
    abstract trace. Tensor-core flops agree exactly (within 1% asked);
    total flops within 25%. Measured gap: prefill 9.4-9.8% (the
    reference's pure-JAX attention counts its S^2 softmax and masks, the
    port's kernel op counts its products only), decode 6.3-6.5%."""
    j = jcal.model_timelines(arch, reduced=True)
    t = calibrate.model_timelines(arch, reduced=True)
    for k in ("prefill", "decode_step"):
        assert t[k].mxu_flops == pytest.approx(j[k].mxu_flops, rel=0.01)
        assert t[k].flops == pytest.approx(j[k].flops, rel=0.25)
    assert "prefill" in tag_heavy([t["prefill"], t["decode_step"]])
    assert "prefill" in jtag_heavy([j["prefill"], j["decode_step"]])


@pytest.fixture(scope="module")
def full_qwen():
    return calibrate.model_timelines("qwen1.5-0.5b")


def test_full_qwen_on_meta_matches_the_committed_artifact(full_qwen):
    """Full published qwen1.5-0.5b, 2,048-token prompt, on meta: tensor
    flops of prefill (1.675e12) and decode_step (1.142e9) within 1% of the
    reference's derived.json (they are equal). prefill is tagged. The
    decode step is tagged too, where the reference leaves it untagged:
    with H100 constants its heavy time is 0.102 of prefill's (564 us
    against 5,518 us), just above tag_heavy's rel_duration of 0.10, while
    the TPU model's S^2 attention intermediates put it at 0.014
    (PERF.md, Findings). The static pass is deterministic, so the tag is
    pinned as found."""
    ref = json.loads(jcal.DERIVED_PATH.read_text())["workloads"][
        "qwen1.5-0.5b"]
    pre, dec = full_qwen["prefill"], full_qwen["decode_step"]
    assert pre.mxu_flops == pytest.approx(ref["prefill"]["mxu_flops"],
                                          rel=0.01)
    assert dec.mxu_flops == pytest.approx(ref["decode_step"]["mxu_flops"],
                                          rel=0.01)
    assert dec.heavy_us / pre.heavy_us == pytest.approx(0.1022, abs=5e-4)
    assert tag_heavy([pre, dec]) == ["prefill", "decode_step"]
    assert ref["tags"] == ["prefill"]


# ----------------------------------------------------------- differential


def test_differential_reduced_qwen_prefill_agrees():
    d = calibrate._model_differential("qwen1.5-0.5b", tol=0.25,
                                      device="cpu")
    assert d["agrees"] and d["rel_err"] <= 0.25, d
    assert d["static_mxu_flops"] > 0


def test_differential_reduced_rwkv6_prefill_agrees():
    """The reference's third differential arch: the static count of the
    reduced RWKV6 prefill (its chunk loop's products, the decay LoRA, the
    mixes) against FlopCounterMode's, within the tolerance."""
    assert calibrate.DIFFERENTIAL_ARCHS == jcal.DIFFERENTIAL_ARCHS
    d = calibrate._model_differential("rwkv6-3b", calibrate.FLOPS_REL_TOL,
                                      "cpu")
    assert d["agrees"] and d["counter_flops"] > 0
    assert d["static_mxu_flops"] == d["counter_flops"]


def test_differential_chacha20_diverges_and_is_known():
    d = differential(lambda k, n: ops.chacha20_keystream(k, n, 1, 64),
                     _u32_zeros(8), _u32_zeros(3), name="chacha20")
    assert d.counter_flops == 0 and d.static_mxu_flops == 0
    assert d.static_flops == 64 * library.CHACHA20_OPS_PER_BLOCK
    assert not d.agrees
    assert "chacha20" in calibrate.KNOWN_DIVERGENT


def test_differential_counts_the_attention_kernels():
    q = torch.zeros(1, 4, 32, 16)
    d = differential(lambda a, b, c: ops.flash_attention(a, b, c), q, q, q)
    assert d.counter_flops == d.static_flops == 4 * 4 * 32 * 32 * 16
    kv = torch.zeros(1, 2, 40, 16)
    d = differential(ops.flash_decode, torch.zeros(1, 4, 16), kv, kv,
                     torch.full((1,), 7, dtype=torch.int32))
    assert d.counter_flops == d.static_flops == 4 * 4 * 40 * 16


# ----------------------------------------------------------- entry point


def _digest(path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_main_on_cpu_writes_the_port_artifact(tmp_path, monkeypatch):
    """The entry point end to end on the CPU, with the model timelines at
    reduced configs to keep the test short (full width: the next test for
    qwen1.5-0.5b, chip_smoke.py phase 6 for all ten). Every arch is
    calibrated: nothing is skipped."""
    from repro_torch.analysis import derived
    full = calibrate.model_timelines
    monkeypatch.setattr(calibrate, "model_timelines",
                        lambda arch, **kw: full(arch, reduced=True, **kw))
    before = _digest(derived.DERIVED_PATH), _digest(jcal.DERIVED_PATH)
    out = tmp_path / "derived_cuda.json"
    assert calibrate.main(["--device", "cpu", "--no-differential", "--out",
                           str(out)]) == 0
    data = json.loads(out.read_text())
    assert sorted(data["workloads"]) == sorted(PORTED)
    assert data["skipped"] == {}
    for arch, w in data["workloads"].items():
        assert "prefill" in w["tags"], arch
        f0, f1, f2 = w["freq"]["levels_ghz"]
        assert f0 > f1 > f2 > 0
    assert sorted(data["kernels"]) == ["chacha20", "flash_attention",
                                       "flash_decode"]
    assert all(k["tags"] == [n] for n, k in data["kernels"].items())
    assert (_digest(derived.DERIVED_PATH), _digest(jcal.DERIVED_PATH)) \
        == before


def test_committed_artifact_is_current_for_qwen(full_qwen, monkeypatch):
    """derived_cuda.json's kernels and its qwen1.5-0.5b workload (the
    reference arch, traced once at full width and shared with the test
    above it) equal a fresh calibration, the differentials aside. The
    other four archs' full-width entries are held to the artifact on the
    card (chip_smoke.py phase 6)."""
    monkeypatch.setattr(calibrate, "model_timelines",
                        lambda arch, **kw: full_qwen)
    data = calibrate.run_calibration(archs=[calibrate.REF_ARCH],
                                     with_differential=False, device="cpu")
    committed = json.loads(calibrate.DERIVED_CUDA_PATH.read_text())
    for entry in (*committed["kernels"].values(),
                  *committed["workloads"].values()):
        entry.pop("differential", None)
    committed["workloads"] = {
        calibrate.REF_ARCH: committed["workloads"][calibrate.REF_ARCH]}
    assert json.loads(json.dumps(data)) == committed


def test_main_without_gpu_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.main(["--no-differential"])
