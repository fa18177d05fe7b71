"""The port's serving on a mesh against the reference's: every family's
``Model.cache_specs`` spec for spec, and the sharded prefill and decode
steps (``train.loop.make_serve_steps``) on a (2, 4) gloo CPU mesh against
the reference's jitted ``model.prefill`` / ``model.decode_step`` with
``in_shardings`` on its Auto (2, 4) mesh, as its dry-run lowers them.

The reference runs in a subprocess with 8 fake XLA devices
(``helpers.run_with_devices``) and writes its parameters, prompts,
logits and final caches as numpy; the port runs as 8 gloo ranks
(``torch_dist_ranks.launch``) from those parameters and prompts."""

import json

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from helpers import run_with_devices
from repro.configs import arch_ids, get_arch as jget_arch
from repro.dist.context import make_dist as jmake_dist
from repro.models.api import build_model as jbuild_model
from repro_torch.bridge import flatten
from repro_torch.configs import get_arch
from repro_torch.dist.context import make_dist, no_dist
from repro_torch.models.api import build_model
from torch_dist_ranks import launch


class FakeMesh:
    """Axis names and sizes, nothing else."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"2x4": dict(data=2, model=4), "16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16)}


def _jtree(specs):
    return {"/".join(str(k.key) for k in path): tuple(s)
            for path, s in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, JP))}


def _ttree(specs):
    return {k: tuple(s) for k, s in flatten(specs).items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", arch_ids())
def test_cache_specs_equal_the_reference(arch, mesh):
    """Every arch's cache specs on the (2, 4) test mesh and the two
    production meshes, entry for entry the reference's."""
    m = FakeMesh(**MESHES[mesh])
    jm = jbuild_model(jget_arch(arch), jmake_dist(m))
    tm = build_model(get_arch(arch), "cpu", make_dist(m))
    assert _ttree(tm.cache_specs()) == _jtree(jm.cache_specs())


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-2.7b",
                                  "rwkv6-3b", "whisper-large-v3"])
def test_cache_specs_without_a_mesh_replicate(arch):
    tm = build_model(get_arch(arch).reduced(), "cpu", no_dist())
    assert all(all(e is None or e == () for e in s)
               for s in _ttree(tm.cache_specs()).values())


# one run a family: dense, moe (MLA and the sharded MoE dispatch), the
# hybrid, and the audio encoder-decoder (whose prefill leaves the cache
# unfilled, so its decode starts at length 0); and the dense one with 2
# K/V heads, which the spec cuts on a 'model' axis of 4, decoding across
# the edge of the first sequence shard (positions 0-7 of 32). Then the
# runs whose cache the ranks make from their shards (``sharded_init``,
# ``train.loop.make_init_cache``: whisper's encoder and cross K/V
# tensor-parallel): the hybrid (one prefill row a rank, its rows split
# over 'model' too) decoding across that edge, and whisper widened to
# d_model 256, as the reduced one splits nothing (every leaf under 2^16
# elements), with 8 heads of 32 (whole on a 'model' axis of 4; from
# length 0) and 2 heads of 128 (cut; from length 6, over the edge)
WIDE = dict(d_model=256, d_ff=512, n_heads=8, kv_heads=8, head_dim=32)
CUT = dict(d_model=256, d_ff=512, n_heads=2, kv_heads=2, head_dim=128)
RUNS = {
    "dense": {"arch": "qwen1.5-0.5b", "over": {}, "start": 16},
    "dense-kv2": {"arch": "qwen1.5-0.5b", "over": {"kv_heads": 2},
                  "start": 6, "prompt": 6},
    "moe": {"arch": "deepseek-v3-671b", "over": {}, "start": 16},
    "hybrid": {"arch": "zamba2-2.7b", "over": {}, "start": 16},
    "audio": {"arch": "whisper-large-v3", "over": {}, "start": 0},
    "hybrid-edge": {"arch": "zamba2-2.7b", "over": {}, "start": 6,
                    "prompt": 6, "sharded_init": True},
    "audio-heads": {"arch": "whisper-large-v3", "over": WIDE, "start": 0,
                    "sharded_init": True},
    "audio-cut": {"arch": "whisper-large-v3", "over": CUT, "start": 6,
                  "sharded_init": True},
}
for _r in RUNS.values():
    _r.update(B=8, S=32, steps=4)
    _r.setdefault("prompt", 16)
# the sequence-sharded cache leaves of the hybrid and the audio runs, read
# and written in place by the sharded steps
SEQ_LEAVES = {"hybrid": ("kv/k", "kv/v"), "hybrid-edge": ("kv/k", "kv/v"),
              "audio": ("self/k", "self/v"),
              "audio-heads": ("self/k", "self/v"),
              "audio-cut": ("self/k", "self/v")}

SERVE = """
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_arch
from repro.configs.base import ShapeConfig
from repro.dist.context import make_dist
from repro.dist.sharding import sanitize_specs, tree_shardings
from repro.models.api import build_model
mesh = jax.make_mesh((2, 4), ('data', 'model'),
                     axis_types=(AxisType.Auto,) * 2)

def flat(tree, prefix=''):
    return {prefix + '/'.join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}

out = {}
for name, run in RUNS.items():
    cfg = dataclasses.replace(get_arch(run['arch']).reduced(), **run['over'])
    dist = make_dist(mesh)
    model = build_model(cfg, dist)
    B, S, pre = run['B'], run['S'], name + '/'
    params = model.init(jax.random.key(0))
    out.update(flat(params, pre + 'params/'))
    batch = {'tokens': jax.random.randint(jax.random.key(1),
                                          (B, run['prompt']), 0, cfg.vocab)}
    if cfg.enc_dec is not None:
        batch['frames'] = jax.random.normal(
            jax.random.key(2), (B, cfg.enc_dec.n_frames, cfg.d_model)) * 0.5
    out.update({pre + k: np.asarray(v) for k, v in batch.items()})
    with mesh:
        p_sh = tree_shardings(dist, params, model.param_specs())
        cache = model.init_cache(params, batch, B, S)
        c_sh = tree_shardings(dist, cache, model.cache_specs())
        cache = jax.device_put(cache, c_sh)
        st, sp = model.input_specs(ShapeConfig('p', run['prompt'], B,
                                               'prefill'))
        b_sh = tree_shardings(dist, batch, {k: sp[k] for k in batch})
        params = jax.device_put(params, p_sh)
        logits, cache = jax.jit(model.prefill, in_shardings=(
            p_sh, b_sh, c_sh))(params, jax.device_put(batch, b_sh), cache)
        out[pre + 'prefill'] = np.asarray(logits)
        st, sp = model.input_specs(ShapeConfig('d', S, B, 'decode'))
        sp = sanitize_specs(st, sp, mesh)
        t_sh, l_sh = dist.sharding(sp['tokens']), dist.sharding(sp['lengths'])
        step = jax.jit(model.decode_step,
                       in_shardings=(p_sh, c_sh, t_sh, l_sh))
        lengths = jnp.full((B,), run['start'], jnp.int32)
        for i in range(run['steps']):
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            cache = jax.device_put(cache, c_sh)
            logits, cache = step(params, cache, jax.device_put(tok, t_sh),
                                 jax.device_put(lengths, l_sh))
            out[f'{pre}decode/{i}'] = np.asarray(logits)
            lengths = lengths + 1
        out.update(flat(cache, pre + 'cache/'))
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def serve_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_ref") / "ref.npz"
    run_with_devices(f"OUT = {str(out)!r}\nRUNS = {RUNS!r}\n" + SERVE,
                     n_devices=8, timeout=600)
    return out


@pytest.fixture(scope="module")
def serve_ranks(serve_ref, tmp_path_factory):
    """Every rank's results of ``RUNS`` on (2, 4), from one launch."""
    return launch("serve", 8, tmp_path_factory.mktemp("serve_ranks"),
                  timeout=360, ref=str(serve_ref), runs=RUNS)


def test_sharded_prefill_and_decode_match_the_reference(serve_ref,
                                                        serve_ranks):
    """For each family: the last logits of the prefill and of 4 greedy
    decode steps within 1e-4 of the reference's, the greedy tokens
    equal, and the final cache (gathered from the shards) within 1e-5 of
    its scale."""
    ranks = serve_ranks
    ref = np.load(serve_ref)
    for r, got in enumerate(ranks):
        for name, run in RUNS.items():
            pre = name + "/"
            calls = ["prefill"] + [f"decode/{i}" for i in range(run["steps"])]
            for call in calls:
                a, b = got[pre + call], ref[pre + call]
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=0,
                                           err_msg=f"{name} {call} rank {r}")
                assert (a.argmax(-1) == b.argmax(-1)).all(), (name, call)
            keys = [k for k in ref.files if k.startswith(pre + "cache/")]
            assert keys and {k for k in got if k.startswith(pre + "cache/")} \
                == set(keys)
            for k in keys:
                scale = max(np.abs(ref[k]).max(), 1e-30)
                assert np.abs(got[k] - ref[k]).max() <= 1e-5 * scale, k


def test_sharded_prefill_and_decode_read_the_cache_in_place(serve_ref,
                                                            serve_ranks):
    """The shared block's ``kv`` cache of the hybrid and whisper's
    ``self`` cache are never relaid by the sharded steps (no relayout of
    a shard of theirs, whisper's heads whole or cut), while the hybrid's
    prefill does relay its Mamba2 states (its rows split over
    ``model``); the values are held to the reference by
    ``test_sharded_prefill_and_decode_match_the_reference``."""
    ref = np.load(serve_ref)
    for got in serve_ranks:
        for name, leaves in SEQ_LEAVES.items():
            pre = name + "/"
            relaid = {tuple(s) for s in json.loads(str(got[pre + "relaid"]))}

            def shard(leaf, dims):   # [stack, B/2, S/4 or S, ...]
                a = ref[pre + "cache/" + leaf]
                return (a.shape[0], a.shape[1] // 2,
                        a.shape[2] // dims) + a.shape[3:]
            for leaf in leaves:
                assert shard(leaf, 4) not in relaid, (name, leaf)
            if name.startswith("hybrid"):
                assert shard("mamba/conv", 1) in relaid


def test_hybrid_prefill_sends_rows_to_their_positions(tmp_path):
    """The hybrid's prefill rows split over ``data`` and ``model`` (1 and
    2 rows a rank), a 13-position prompt written into a 16-position cache
    resting with its rows over ``data`` and its sequence over ``model``
    (``attention._write_prefill``): each rank's shard is its rows' block
    of positions, zero past the prompt."""
    rng = np.random.default_rng(0)
    arrays = {f"k{n}": rng.standard_normal((8 * n, 13, 2, 4)).astype(
        np.float32) for n in (1, 2)}
    np.savez(tmp_path / "rows.npz", **arrays)
    ranks = launch("rows_to_seq", 8, tmp_path, timeout=120,
                   ref=str(tmp_path / "rows.npz"), names=list(arrays),
                   smax=16)
    for name, k in arrays.items():
        full = np.zeros((k.shape[0], 16) + k.shape[2:], np.float32)
        full[:, :13] = k
        Bd = k.shape[0] // 2
        for r, got in enumerate(ranks):
            d, j = divmod(r, 4)
            np.testing.assert_array_equal(
                got[name], full[d * Bd:(d + 1) * Bd, j * 4:(j + 1) * 4],
                err_msg=(name, r))
