"""The port's distribution layer in one process, against the reference's
(``repro.dist``, ``train.loop``, ``models.api``): spec sanitation over
drawn shapes, meshes and specs; the axis roles of ``make_dist`` and
``no_dist``; every family's parameter, train-state and batch specs on a
(2, 4) mesh with and without ZeRO-1; and ``shard``/``gather`` round trips.

A duck-typed mesh stands in for both packages' meshes where only axis
names and sizes are read (the reference's ``jax.make_mesh`` would need 8
devices); ``shard``/``gather`` through a process group run on a world of
one gloo rank."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as JP

from repro.configs import arch_ids, get_arch as jget_arch
from repro.configs.base import ShapeConfig
from repro.dist.context import make_dist as jmake_dist, no_dist as jno_dist
from repro.dist.sharding import sanitize_spec as jsanitize_spec
from repro.dist.sharding import sanitize_specs as jsanitize_specs
from repro.models.api import build_model as jbuild_model
from repro.train import loop as jloop
from repro_torch.bridge import flatten
from repro_torch.configs import get_arch
from repro_torch.dist.context import make_dist, no_dist
from repro_torch.dist.sharding import (P, Placement, gather, sanitize_spec,
                                       sanitize_specs, shard, tree_shardings)
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models.api import build_model
from repro_torch.train import loop


class FakeMesh:
    """Axis names and sizes (and a rank's coordinates), nothing else."""

    def __init__(self, coords=None, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.coords = coords or {}


AXES = ("pod", "data", "model", "stage")


def _entries():
    name = st.sampled_from(AXES + ("expert",))
    return st.one_of(st.none(), name,
                     st.lists(name, min_size=1, max_size=3).map(tuple))


@settings(max_examples=300, deadline=None)
@given(sizes=st.dictionaries(st.sampled_from(AXES),
                             st.integers(1, 4), max_size=4),
       shape=st.lists(st.integers(1, 24), max_size=4),
       entries=st.lists(_entries(), max_size=6))
def test_sanitize_spec_equals_reference(sizes, shape, entries):
    """Missing axes, tuple entries, non-dividing sizes (innermost dropped
    first), padding and truncation: entry for entry the reference's."""
    mesh = FakeMesh(**sizes)
    want = jsanitize_spec(JP(*entries), tuple(shape), mesh)
    got = sanitize_spec(P(*entries), tuple(shape), mesh)
    assert tuple(got) == tuple(want)
    assert tuple(sanitize_spec(P(*entries), tuple(shape), None)) == \
        tuple(jsanitize_spec(JP(*entries), tuple(shape), None))


def test_p_normalises_entries_as_the_reference():
    for entries in [(("data",), None), (["data", "model"],), (), (None,),
                    (("data", "model"), "pod")]:
        assert tuple(P(*entries)) == tuple(JP(*entries))
    assert P("data") != P("data", None) and P() != P(None)


def _jtree(specs):
    return {"/".join(str(k.key) for k in path): tuple(s)
            for path, s in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, JP))}


def _ttree(specs):
    return {k: tuple(s) for k, s in flatten(specs).items()}


def test_no_dist_invariants():
    d = no_dist()
    assert d.active is False and d.mesh is None
    assert d.dp_axes == () and d.ep_axes == () and d.model_axis is None
    assert d.dp_size == d.model_size == d.ep_size == 1
    assert not (d.fsdp or d.zero1 or d.ep_over_dp)
    x = torch.arange(6.0).reshape(2, 3)
    assert d.constrain(x, P("data", None)) is x
    assert tree_shardings(d, {"w": x}, {"w": P()}) is None


@pytest.mark.parametrize("shape,axes,kw", [
    ((2, 4), ("data", "model"), {}),
    ((2, 4), ("data", "model"), dict(ep_over_dp=True, fsdp=False,
                                     zero1=True)),
    ((2, 2, 4), ("pod", "data", "model"), dict(fsdp=False)),
    ((8,), ("data",), {}),
    ((4, 2), ("stage", "model"), {}),
])
def test_make_dist_roles_match_reference(shape, axes, kw):
    mesh = FakeMesh(**dict(zip(axes, shape)))
    j, t = jmake_dist(mesh, **kw), make_dist(mesh, **kw)
    for f in ("active", "dp_axes", "model_axis", "ep_axes", "ep_over_dp",
              "fsdp", "zero1", "dp_size", "model_size",
              "ep_size"):
        assert getattr(t, f) == getattr(j, f), f
    assert jno_dist().ep_size == no_dist().ep_size == 1


def test_make_dist_refuses_seq_parallel():
    """The port computes no layer sequence-parallel, so a context that
    asks for it is refused rather than silently run unsharded."""
    with pytest.raises(NotImplementedError, match="seq_parallel"):
        make_dist(FakeMesh(data=2, model=4), seq_parallel=True)


def test_constrain_is_the_identity():
    """An unknown axis and a spec longer than the rank must not raise (the
    reference's ``test_constrain_sanitizes_against_shape``, which fails
    under jax 0.9's Explicit mesh axes); the tensor comes back as it was."""
    d = make_dist(FakeMesh(data=2, model=4))
    x = torch.zeros(5, 3)
    assert d.constrain(x, P(("data", "pod"), "model")) is x


def _shape(kind):
    return ShapeConfig(f"t_{kind}", 64, 8, kind)


@pytest.mark.parametrize("zero1", [False, True], ids=["fsdp", "zero1"])
@pytest.mark.parametrize("arch", arch_ids())
def test_state_and_batch_specs_match_reference(arch, zero1):
    """Every family's reduced config on a (2, 4) mesh: param specs,
    ``train_state_specs`` (ZeRO-1's strip and ``add_dp``), the same
    sanitized against the leaves' shapes, and the batch specs of a train,
    prefill and decode shape, entry for entry the reference's."""
    mesh = FakeMesh(data=2, model=4)
    jm = jbuild_model(jget_arch(arch).reduced(), jmake_dist(mesh, zero1=zero1))
    tm = build_model(get_arch(arch).reduced(), "cpu",
                     make_dist(mesh, zero1=zero1))
    assert tm.pure_dp == jm.pure_dp
    want, got = jloop.train_state_specs(jm), loop.train_state_specs(tm)
    assert _ttree(got) == _jtree(want)
    jabs, tabs = jm.abstract_params(), tm.abstract_params()
    assert _ttree(sanitize_specs(tabs, got["opt"]["m"], mesh)) == \
        _jtree(jsanitize_specs(jabs, want["opt"]["m"], mesh))
    for kind in ("train", "prefill", "decode"):
        _, jsp = jm.input_specs(_shape(kind))
        assert {k: tuple(v) for k, v in tm.batch_specs(_shape(kind)).items()} \
            == {k: tuple(v) for k, v in jsp.items()}, kind


def test_zero1_shards_optimizer_state_of_big_leaves():
    """At a vocab of 1,024 the tied embedding (65,536 elements) reaches
    ZeRO-1's threshold: its parameter is replicated over 'data' and its
    moments add 'data' on the largest free dim, as the reference's."""
    mesh = FakeMesh(data=2, model=4)
    jcfg = dataclasses.replace(jget_arch("qwen1.5-0.5b").reduced(), vocab=1024)
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").reduced(), vocab=1024)
    specs = loop.train_state_specs(
        build_model(cfg, "cpu", make_dist(mesh, zero1=True)))
    assert _ttree(specs) == _jtree(jloop.train_state_specs(
        jbuild_model(jcfg, jmake_dist(mesh, zero1=True))))
    assert tuple(specs["params"]["embed"]) == ("model", None)
    assert tuple(specs["opt"]["m"]["embed"]) == ("model", "data")


@pytest.mark.parametrize("spec", [P(("data", "model"), None),
                                  P("data", "model"), P(None, "model"),
                                  P("model", "data"), P()])
def test_shards_tile_the_tensor_first_axis_major(spec):
    """The blocks of every rank of a (2, 4) mesh cover the tensor, each
    element as many times as ranks share its block, each block the shape
    its placement says."""
    x = torch.arange(16 * 8).reshape(16, 8)
    seen = torch.zeros_like(x)
    for i in range(2):
        for j in range(4):
            mesh = FakeMesh({"data": i, "model": j}, data=2, model=4)
            pl = Placement(mesh, sanitize_spec(spec, x.shape, mesh))
            block = shard(x, pl)
            want = list(x.shape)
            for d, axes in pl.dims:
                want[d] //= int(np.prod([mesh.shape[a] for a in axes]))
            assert block.shape == tuple(want)
            seen.view(-1)[block.reshape(-1)] += 1
    reps = 8 * block.numel() // x.numel()       # ranks holding a block
    assert torch.equal(seen, torch.full_like(x, reps))


@pytest.fixture
def world_of_one(tmp_path):
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                             world_size=1, rank=0)
    try:
        yield make_test_mesh((1, 1), ("data", "model"))
    finally:
        tdist.destroy_process_group()


def test_shard_gather_round_trip_and_gradient(world_of_one):
    """On a world of one: ``gather(shard(x))`` is ``x``; gather's backward
    (the reduce-scatter) hands the gradient back; a group is named by
    axes in mesh order; the production mesh needs 256 ranks."""
    mesh = world_of_one
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.group(("data", "model")) is not None
    with pytest.raises(ValueError, match="mesh order"):
        mesh.group(("model", "data"))
    with pytest.raises(ValueError, match="does not cover"):
        make_production_mesh()
    x = torch.randn(4, 6, requires_grad=True)
    pl = Placement(mesh, P("data", "model"))
    y = gather(shard(x, pl), pl)
    assert torch.equal(y, x)
    (y * 3).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 3.0))


@pytest.mark.parametrize("zero1", [False, True])
def test_train_step_on_a_world_of_one_is_one_device_s(world_of_one, zero1):
    """The one train-step body on a (1, 1) gloo mesh (placed, gathered,
    summed over its replicas) and without a mesh (every placement empty)
    gives the same losses, gradient norms and parameters, bit for bit."""
    cfg = get_arch("qwen1.5-0.5b").reduced()
    opt = loop.OptConfig(lr=1e-3)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (4, 16), generator=gen)
             for k in ("tokens", "targets")}
    single = build_model(cfg, "cpu")
    state = loop.init_train_state(single, torch.Generator().manual_seed(1),
                                  opt)
    model = build_model(cfg, "cpu", make_dist(world_of_one, zero1=zero1))
    sharded = loop.shard_train_state(state, model, opt)
    steps = (loop.make_train_step(single, opt, grad_accum=2),
             loop.make_train_step(model, opt, grad_accum=2))
    for _ in range(2):
        state, m1 = steps[0](state, batch)
        sharded, m2 = steps[1](sharded, batch)
        for k in ("loss", "grad_norm"):
            assert torch.equal(m1[k], m2[k]), k
    full = flatten(loop.gather_train_state(sharded, model, opt)["params"])
    for k, w in flatten(state["params"]).items():
        assert torch.equal(full[k], w.detach()), k


def test_elastic_restore_needs_a_device_without_a_mesh(tmp_path):
    """Without a mesh the state goes where the caller says, never to the
    host by default."""
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.elastic import elastic_restore
    with pytest.raises(ValueError, match="device"):
        elastic_restore(CheckpointManager(tmp_path), {}, no_dist())
