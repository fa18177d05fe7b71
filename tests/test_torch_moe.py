"""The port's single-device MoE (``repro_torch.models.moe``) against the JAX
reference (``repro.models.moe``): the same numpy inputs and the
reference's own ``moe_init`` weights through both, in fp32, at 1e-5, with
drops (capacity factor 0.5) and without; and the full-width init, which
fills preallocated tensors expert by expert."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import moe as jmoe
from repro_torch.configs import get_arch
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe
from repro_torch.models.layers import materialize

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["grok-1-314b", "deepseek-v3-671b"]


def configs(arch, **moe_over):
    """The reduced config of ``arch`` in both packages, with ``moe_over``
    replacing fields of its ``MoEConfig``."""
    j, t = jget_arch(arch).reduced(), get_arch(arch).reduced()
    return (dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe_over)),
            dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe_over)))


def weights(jcfg, seed=0):
    """The reference's ``moe_init`` weights in both packages' types."""
    jp = jmoe.moe_init(jax.random.key(seed), jcfg, jnp.float32, 1)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def tokens(T, d, seed=1):
    return (np.random.default_rng(seed).standard_normal((T, d))
            .astype(np.float32))


@pytest.mark.parametrize("E,M", [(8, 1), (8, 16), (256, 1), (256, 16),
                                 (4, 2)])
def test_expert_layout_matches_reference(E, M):
    jcfg, tcfg = configs("grok-1-314b", n_experts=E)
    want = jmoe.expert_layout(jcfg, M)
    assert dataclasses.asdict(moe.expert_layout(tcfg, M)) == \
        dataclasses.asdict(want)


def test_expert_layout_refuses_what_the_reference_refuses():
    jcfg, tcfg = configs("grok-1-314b", n_experts=8, d_ff=60)
    for layout, cfg in ((jmoe.expert_layout, jcfg),
                        (moe.expert_layout, tcfg)):
        with pytest.raises(ValueError, match="not divisible"):
            layout(cfg, 128)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_match_reference(arch):
    jcfg, tcfg = configs(arch)
    jp = jmoe.moe_init(jax.random.key(0), jcfg, jnp.float32, 1)
    tp = materialize(moe.moe_init(tcfg), None, torch.float32, "meta")
    want = {"/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    got = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_leaves_with_path(
               tp, is_leaf=lambda x: isinstance(x, torch.Tensor))}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = weights(jcfg)
    x = tokens(40, jcfg.d_model)
    jw, jids, jaux = jmoe._route(jnp.asarray(x), jp["router"], jcfg)
    tw, tids, taux = moe._route(torch.from_numpy(x), tp["router"], tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    assert bool((tw[:, :-1] >= tw[:, 1:]).all())            # descending
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [2.0, 1.25, 0.5])
def test_moe_local_matches_reference(arch, cf):
    """At capacity factor 0.5 a quarter or more of the (token, choice)
    pairs drop: the same ones, by the token-major cumulative count."""
    jcfg, tcfg = configs(arch, capacity_factor=cf)
    jp, tp = weights(jcfg)
    x = tokens(48, jcfg.d_model, seed=2)
    jy, jaux = jmoe.moe_local(jp, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_local(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert taux["drop_frac"].item() == float(jaux["drop_frac"])
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), **TOL)
    if cf == 0.5:
        assert taux["drop_frac"].item() >= 0.25


def test_moe_local_capacity_one_token_per_expert():
    """Decode at batch 1: C = 1, and a second choice of an expert drops."""
    jcfg, tcfg = configs("deepseek-v3-671b", capacity_factor=1.25,
                         n_experts=4, top_k=2)
    jp, tp = weights(jcfg, seed=3)
    for T in (1, 3):
        x = tokens(T, jcfg.d_model, seed=T)
        jy, jaux = jmoe.moe_local(jp, jnp.asarray(x), jcfg)
        ty, taux = moe.moe_local(tp, torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        assert taux["drop_frac"].item() == float(jaux["drop_frac"])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_runs_the_batch_as_one_token_set(arch):
    jcfg, tcfg = configs(arch, capacity_factor=0.5)
    jp, tp = weights(jcfg)
    x = tokens(2 * 9, jcfg.d_model, seed=4).reshape(2, 9, -1)
    from repro.dist.context import no_dist
    jy, jaux = jmoe.moe_block(jp, jnp.asarray(x), jcfg, no_dist())
    ty, taux = moe.moe_block(tp, torch.from_numpy(x), tcfg)
    assert ty.shape == (2, 9, jcfg.d_model)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert taux["drop_frac"].item() == float(jaux["drop_frac"])


def test_moe_local_traces_on_meta_at_full_width():
    """Every shape is static: deepseek-v3's published MoE runs on the meta
    device, where no value exists to index by."""
    cfg = get_arch("deepseek-v3-671b")
    p = materialize(moe.moe_init(cfg), None, torch.bfloat16, "meta")
    x = torch.empty((512, cfg.d_model), dtype=torch.bfloat16, device="meta")
    y, aux = moe.moe_local(p, x, cfg)
    assert y.shape == x.shape and y.device.type == "meta"
    assert p["up"].shape == (1, 256, 7168, 2048)
    assert set(aux) == {"lb_loss", "z_loss", "drop_frac"}


def test_init_fills_each_expert_in_its_final_dtype():
    """``materialize`` allocates every stacked tensor once, in its dtype,
    and draws the experts one at a time: the same seed gives the same
    weights, a different one other weights, and each expert's matrix has
    its own draw with the reference's standard deviation."""
    cfg = dataclasses.replace(
        get_arch("grok-1-314b").reduced(),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=256))
    spec = moe.moe_init(cfg)

    def draw(seed):
        return materialize(spec, torch.Generator().manual_seed(seed),
                           torch.bfloat16, "cpu", layers=3)

    a, b, c = draw(0), draw(0), draw(1)
    assert a["up"].shape == (3, 1, 4, 64, 256)
    assert a["up"].dtype == torch.bfloat16
    assert all(torch.equal(a[k], b[k]) for k in ("router", "up", "down"))
    assert not torch.equal(a["up"], c["up"])
    up = a["up"].float()
    assert not torch.equal(up[0, 0, 0], up[0, 0, 1])
    assert not torch.equal(up[0], up[1])
    np.testing.assert_allclose(up.std().item(), 1 / np.sqrt(64), rtol=0.02)
    down = a["down"].float()
    np.testing.assert_allclose(down.std().item(), 1 / np.sqrt(256), rtol=0.02)


def test_init_on_meta_allocates_nothing():
    from repro_torch.models.api import build_model
    for arch in ARCHS:
        params = build_model(get_arch(arch), "cpu").abstract_params()
        leaves = jax.tree_util.tree_leaves(
            params, is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert all(t.device.type == "meta" for t in leaves)
        n = sum(t.numel() for t in leaves)
        assert n == pytest.approx(get_arch(arch).param_count(), rel=1e-4)
