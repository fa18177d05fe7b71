"""The port's roofline (``repro_torch.roofline``) against the reference's
``repro.roofline``: the analytic floor and model flops over all 40 cells,
the H100 terms and bottleneck, and the op-stream counter's rules, the
counterparts of ``tests/test_hlo_cost.py`` (trips counted, in-place
writes and slices costed by what they touch, each collective's wire
bytes on a fake world of 8)."""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import all_cells as jall_cells, get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.roofline import analysis as jra
from repro_torch.analysis.regions import MachineModel
from repro_torch.configs import get_arch, get_shape
from repro_torch.dist import collectives as coll
from repro_torch.launch.mesh import fake_world, make_test_mesh
from repro_torch.roofline import analysis as ra
from repro_torch.roofline.op_cost import CostCounter


def count(fn, *args):
    """``(fn(*args), counter)``: the call under a fresh ``CostCounter``."""
    with CostCounter() as counter:
        out = fn(*args)
    return out, counter


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in jall_cells()])
def test_floor_and_model_flops_equal_the_reference(arch, shape):
    """``memory_floor_bytes`` (both optimizer widths, both meshes) and
    ``model_flops`` equal the reference's over all 40 cells."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    sh, jsh = get_shape(shape), jget_shape(shape)
    for chips in (256, 512):
        for opt_b in (4, 8):
            assert ra.memory_floor_bytes(cfg, sh, chips, chips, opt_b) == \
                jra.memory_floor_bytes(jcfg, jsh, chips, chips, opt_b)
    assert ra.model_flops(cfg, sh) == jra.model_flops(jcfg, jsh)


def test_peaks_come_from_the_machine_model():
    m = MachineModel()
    assert ra.PEAK_FLOPS == m.tensor_flops_per_s == 989e12
    assert ra.HBM_BW == m.hbm_bytes_per_s == 3.35e12


def test_roofline_terms_and_bottleneck():
    """The reference's case at the H100's constants: 1 s of compute, a
    0.1 s floor, and 2 s of collectives, 1 s on NVLink and 1 s on the
    network."""
    r = ra.Roofline(arch="x", shape="train_4k", mesh="single", chips=256,
                    hlo_gflops=989_000.0,      # exactly 1 s of compute
                    hlo_gbytes=3350.0,         # 1 s of HBM
                    floor_gbytes=335.0,        # 0.1 s floor
                    wire_gbytes=500.0,         # 450 GB NVLink + 50 GB NIC
                    nvlink_gbytes=450.0,
                    model_gflops_total=989_000.0 * 256).finalize()
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.memory_floor_s == pytest.approx(0.1)
    assert r.collective_s == pytest.approx(2.0)
    assert r.bottleneck == "collective"
    assert r.useful_flops_ratio == pytest.approx(1.0)
    assert r.mfu == pytest.approx(0.5)      # 1 s ideal / 2 s step
    assert r.step_s == pytest.approx(2.0)
    keys = set(jra.Roofline(arch="x", shape="s", mesh="m", chips=1,
                            hlo_gflops=1, hlo_gbytes=1, floor_gbytes=1,
                            wire_gbytes=1, model_gflops_total=1)
               .finalize().to_dict())
    assert keys <= set(r.to_dict())


def test_links_by_node():
    assert ra.link_of(range(8)) == "nvlink"
    assert ra.link_of([8, 9, 15]) == "nvlink"
    assert ra.link_of(range(0, 256, 16)) == "network"
    assert ra.link_of([7, 8]) == "network"


def test_model_flops_shapes():
    cfg = get_arch("qwen1.5-0.5b")
    n = cfg.active_param_count()
    assert ra.model_flops(cfg, get_shape("train_4k")) == \
        pytest.approx(6 * n * 4096 * 256)
    assert ra.model_flops(cfg, get_shape("prefill_32k")) == \
        pytest.approx(2 * n * 32768 * 32)
    assert ra.model_flops(cfg, get_shape("decode_32k")) == \
        pytest.approx(2 * n * 128)


def test_a_python_loop_counts_every_trip():
    w = torch.zeros(128, 128)

    def f(x):
        for _ in range(12):
            x = torch.tanh(x @ w)
        return x.sum()

    _, c = count(f, torch.zeros(128, 128))
    mm = 2 * 128 ** 3
    assert c.totals.flops == pytest.approx(12 * (mm + 128 * 128) + 1)


def test_nested_loops_multiply():
    w = torch.zeros(64, 64)

    def f(x):
        for _ in range(3):
            for _ in range(5):
                x = x @ w
        return x

    _, c = count(f, torch.zeros(64, 64))
    assert c.totals.flops == 2 * 64 ** 3 * 15


def test_one_row_cache_write_costs_the_row():
    """A one-row write into a 16 MB buffer, as the decode step's indexed
    cache write and the prefill's slice copy do it, costs the row."""
    buf = torch.zeros(4096, 1024)               # 16 MB
    upd = torch.ones(1, 1024)
    for write in (lambda: buf.__setitem__(torch.tensor([7]), upd),
                  lambda: buf[7:8].copy_(upd),
                  lambda: buf.index_copy_(0, torch.tensor([7]), upd)):
        _, c = count(write)
        assert 0 < c.totals.bytes < 2e6, c.totals.bytes


def test_slice_costs_what_it_reads():
    buf = torch.zeros(4096, 1024)
    _, c = count(lambda: buf[:2] * 2.0)
    assert c.totals.bytes == 2 * 2 * 1024 * 4
    _, c = count(lambda: buf[torch.tensor([3, 5])])
    assert c.totals.bytes == 2 * 2 * 1024 * 4 + 2 * 8


def test_casts_count_in_bytes_and_cast_bytes():
    x = torch.zeros(256, 256, dtype=torch.bfloat16)
    _, c = count(lambda: x.float())
    assert c.totals.cast_bytes == c.totals.bytes == 256 * 256 * 6
    _, c = count(lambda: x.clone())
    assert c.totals.cast_bytes == 0 and c.totals.bytes == 256 * 256 * 4


def test_peak_follows_live_storages():
    def f(x):
        y = x * 2                      # 1 MB
        z = y + 1                      # 2 MB live
        del y
        return z.sum()                 # one element more
    _, c = count(f, torch.zeros(512, 512))
    assert c.peak_bytes == 2 * 512 * 512 * 4


def test_collective_wire_bytes_on_a_fake_world_of_eight():
    """Each collective of ``dist.collectives`` on (2, 4): the reference's
    wire formulas at the group's size, kept by group size and link."""
    with fake_world(8):
        mesh = make_test_mesh(device="cpu")
        model, data = mesh.group("model"), mesh.group("data")
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = torch.empty(4, 256)                  # 4 KiB
            cases = {
                "all-gather": (lambda: coll.all_gather(x, model, 0),
                               4096 * 4 - 4096),
                "all-reduce": (lambda: coll.psum(x, data), 2 * 4096 / 2),
                "reduce-scatter": (lambda: coll.reduce_scatter(x, model, 0),
                                   4096 - 1024),
                "all-to-all": (lambda: coll.all_to_all(x, model),
                               4096 * 3 / 4),
            }
            for kind, (fn, wire) in cases.items():
                _, c = count(fn)
                t = c.totals
                assert t.coll_counts == {kind: 1}, kind
                assert t.coll_wire[kind] == pytest.approx(wire), kind
                n = 2 if kind == "all-reduce" else 4
                assert t.wire_by_group == {n: pytest.approx(wire)}
                assert t.wire_by_link == {"nvlink": pytest.approx(wire)}
                assert t.to_dict()["total_wire"] == pytest.approx(wire)


def test_pool_model_reads_the_ports_dry_run():
    """The copied engine's ``pool_model_from_dryrun`` turns the port's
    prefill and decode cells into a non-default ``PoolModel``."""
    from repro_torch.launch import dryrun
    from repro_torch.sched.engine import PoolModel, pool_model_from_dryrun
    results = {}
    for shape in ("prefill_32k", "decode_32k"):
        res = dryrun.run_cell("qwen1.5-0.5b", shape, "test",
                              overrides={"n_layers": 2})
        assert res["status"] == "ok", res.get("error")
        results[f"qwen1.5-0.5b|{shape}|test"] = res
    pm = pool_model_from_dryrun(results, "qwen1.5-0.5b", mesh="test")
    assert pm != PoolModel()
    assert pm.prefill_ms_per_ktok > 0 and pm.decode_fixed_ms > 0
