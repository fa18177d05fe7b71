"""The port's distribution (``repro_torch.dist``, the sharded MoE dispatch,
the sharded train step, ``elastic_restore`` onto a mesh) against the
reference on multi-rank CPU meshes.

The reference runs in a subprocess with 8 fake XLA devices
(``helpers.run_with_devices``) on meshes the snippet builds itself with
Auto axes (jax 0.9's ``jax.make_mesh`` makes Explicit ones, which
``with_sharding_constraint`` refuses), and writes its inputs and results
as numpy to ``tmp``; the port runs as gloo ranks
(``torch_dist_ranks.launch``, a ``file://`` rendezvous) on the same
numbers, weights from the reference's own ``init`` through the bridge.
Each case has its own timeouts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro.configs import get_arch as jget_arch
from repro.models import moe as jmoe
from repro_torch.bridge import flatten, params_from_jax
from repro_torch.configs import get_arch
from repro_torch.dist.context import make_dist, no_dist
from repro_torch.dist.sharding import P, Placement, shard
from repro_torch.models import moe
from repro_torch.models.api import build_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import elastic_restore
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptConfig, init_opt_state
from test_torch_serve_dist import FakeMesh
from torch_dist_ranks import launch, moe_variant_cfg

pytestmark = pytest.mark.slow

PRELUDE = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

def mesh_of(shape, axes, n=None):
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                         devices=jax.devices()[:n or int(np.prod(shape))])

def flat(tree, prefix=''):
    return {prefix + '/'.join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
"""

COLLECTIVES = PRELUDE + """
from repro.dist.collectives import compressed_allreduce, hierarchical_allreduce
from repro.dist.pipeline import gpipe_apply
out = {}
mesh = mesh_of((8,), ('data',))
g = jax.random.normal(jax.random.key(0), (8, 256)) * 0.1
def body(g, e):
    m, e2 = compressed_allreduce(g[0], e[0], 'data')
    return m[None], e2[None]
with mesh:
    f = jax.shard_map(body, mesh=mesh, in_specs=(P('data', None),) * 2,
                      out_specs=(P('data', None),) * 2, check_vma=False)
    mean, err = f(g, jnp.zeros_like(g))
out.update(g=np.asarray(g), mean=np.asarray(mean), err=np.asarray(err))
pods = mesh_of((2, 4), ('pod', 'data'))
x = jax.random.normal(jax.random.key(0), (8, 64))
with pods:
    f = jax.shard_map(
        lambda xl: hierarchical_allreduce(xl[0], 'pod', 'data')[None],
        mesh=pods, in_specs=P(('pod', 'data'), None),
        out_specs=P(('pod', 'data'), None), check_vma=False)
    out.update(x=np.asarray(x), hier=np.asarray(f(x)))
stages = mesh_of((4,), ('stage',))
ws = jax.random.normal(jax.random.key(0), (8, 16, 16)) * (1.0 / 16 ** 0.5)
xp = jax.random.normal(jax.random.key(1), (6, 2, 4, 16))
with stages:
    pipe = gpipe_apply(lambda w, h: jnp.tanh(h @ w), ws, xp, mesh=stages,
                       layers_per_stage=2)
out.update(ws=np.asarray(ws), xp=np.asarray(xp), pipe=np.asarray(pipe))
# which block of a [24, 3] tensor each device of a (2, 4) mesh holds
grid = mesh_of((2, 4), ('data', 'model'))
for name, spec in (('tuple', P(('data', 'model'), None)),
                   ('both', P('data', 'model')), ('model', P(None, 'model'))):
    shape = (24, 8)
    idx = NamedSharding(grid, spec).devices_indices_map(shape)
    for (i, j), dev in np.ndenumerate(grid.devices):
        out[f'order/{name}/{i}/{j}'] = np.array(
            [[s.start or 0, s.stop or n] for s, n in zip(idx[dev], shape)])
np.savez(OUT, **out)
"""

MOE = PRELUDE + """
import dataclasses
from repro.configs import get_arch
from repro.dist.context import make_dist, no_dist
from repro.models.moe import moe_block, moe_init
mesh = mesh_of((2, 4), ('data', 'model'))
out = {}
for name, v in VARIANTS.items():
    cfg = get_arch(v['arch']).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **v['moe']))
    p = moe_init(jax.random.key(0), cfg, jnp.float32, 1)        # [1, E, ...]
    x = jax.random.normal(jax.random.key(1), (4, 16, cfg.d_model)) * 0.5
    out['x/' + v['arch']] = np.asarray(x)
    y0, aux0 = moe_block(p, x, cfg, no_dist())
    out.update({f'{name}/local/y': np.asarray(y0),
                **{f'{name}/local/{k}': np.asarray(a) for k, a in aux0.items()}})
    dist = make_dist(mesh, ep_over_dp=v['ep_over_dp'])
    E, M = cfg.moe.n_experts, dist.ep_size
    ep = int(np.gcd(E, M))
    tpe = M // ep

    def device_major(w, ax):      # [E, ...], ff at ax -> [ep*tpe, E/ep, ...]
        w = w.reshape(*w.shape[:ax], tpe, w.shape[ax] // tpe, *w.shape[ax + 1:])
        w = jnp.moveaxis(w, ax, 1)                   # [E, tpe, ...]
        w = w.reshape(ep, E // ep, *w.shape[1:])     # [ep, epg, tpe, ...]
        w = jnp.swapaxes(w, 1, 2)                    # [ep, tpe, epg, ...]
        return w.reshape(ep * tpe, E // ep, *w.shape[3:])
    ps = dict(p)
    for k, ax in (('up', 2), ('gate', 2), ('down', 1)):
        if k in p:
            ps[k] = device_major(p[k][0], ax)
    out.update(flat(ps, name + '/'))
    with mesh:
        y, aux = jax.jit(lambda p_, x_: moe_block(p_, x_, cfg, dist,
                                                  dispatch=v['dispatch']))(ps, x)
    out[f'{name}/ref/y'] = np.asarray(y)
    out.update({f'{name}/ref/{k}': np.asarray(a) for k, a in aux.items()})
np.savez(OUT, **out)
"""

TRAIN = PRELUDE + """
import dataclasses
from repro.configs import get_arch
from repro.dist.context import make_dist
from repro.models.api import build_model
from repro.train.checkpoint import CheckpointManager
from repro.train.loop import init_train_state, jit_train_step
from repro.train.optimizer import OptConfig
mesh = mesh_of((2, 4), ('data', 'model'))
out = {}
for name, run in RUNS.items():
    cfg = dataclasses.replace(get_arch(run['arch']).reduced(), **run['over'])
    model = build_model(cfg, make_dist(mesh, zero1=run['zero1'],
                                       seq_parallel=run['seq_parallel']))
    opt = OptConfig(lr=1e-3)
    S = run.get('seq', 64)
    batch = {'tokens': jax.random.randint(jax.random.key(1), (8, S), 0, cfg.vocab),
             'targets': jax.random.randint(jax.random.key(2), (8, S), 0, cfg.vocab)}
    specs = {'tokens': P('data', None), 'targets': P('data', None)}
    if cfg.enc_dec is not None:     # the encoder-decoder's frames
        batch['frames'] = jax.random.normal(
            jax.random.key(3), (8, cfg.enc_dec.n_frames, cfg.d_model)) * 0.5
        specs['frames'] = P('data', None, None)
    with mesh:
        state = init_train_state(model, jax.random.key(0), opt)
        out.update(flat(state['params'], name + '/init/'))
        step = jit_train_step(model, opt, grad_accum=2, batch_specs=specs)
        losses, gnorms = [], []
        for _ in range(4):
            state, m = step(state, batch)
            losses.append(float(m['loss']))
            gnorms.append(float(m['grad_norm']))
    out[name + '/losses'] = np.array(losses)
    out[name + '/gnorms'] = np.array(gnorms)
    out.update(flat(state['params'], name + '/final/'))
    out.update(flat(state['opt']['m'], name + '/m/'))
    out.update(flat(state['opt']['v'], name + '/v/'))
    out.update({f'{name}/{k}': np.asarray(v) for k, v in batch.items()})
    if name == 'qwen-fsdp':
        CheckpointManager(CKPT, async_save=False).save(4, state, {'data': {'cursor': 8}})
np.savez(OUT, **out)
"""

# the sharded train step's runs: FSDP and ZeRO-1, dense and MoE, each
# tensor-parallel over 'model'. The ZeRO-1 qwen has a vocab of 1,024 so
# that its embedding (65,536 elements) reaches the 2^16 at which ZeRO-1
# shards optimizer state; the ZeRO-1 grok slices its dp-replicated experts
# for the MoE body on use. qwen and grok under seq_parallel (the residual
# between blocks sequence-sharded over 'model', the MoE reading the
# gathered sequence), and qwen with 2 K/V heads on a
# 'model' axis of 4, where the spec cuts a K/V head (wk/wv whole on use).
TRAIN_RUNS = {
    "qwen-fsdp": dict(arch="qwen1.5-0.5b", over={}, zero1=False),
    "qwen-zero1": dict(arch="qwen1.5-0.5b", over=dict(vocab=1024),
                       zero1=True),
    "grok-fsdp": dict(arch="grok-1-314b", over={}, zero1=False),
    "grok-zero1": dict(arch="grok-1-314b", over={}, zero1=True),
    "qwen-seqpar": dict(arch="qwen1.5-0.5b", over={}, zero1=False,
                        seq_parallel=True),
    "grok-seqpar": dict(arch="grok-1-314b", over={}, zero1=False,
                        seq_parallel=True),
    "qwen-kv2": dict(arch="qwen1.5-0.5b", over=dict(kv_heads=2),
                     zero1=False),
}
# whisper's sharded train step, its dense layers computed on their
# 'model' columns: the reduced whisper splits nothing (every leaf under
# 2^16 elements rests replicated), so it runs widened to d_model 256, 8
# heads of 32, which a 'model' axis of 4 splits in whole heads (FSDP and
# ZeRO-1), and 2 heads of 128, which it cuts (FSDP; the (16, 16) case of
# whisper-large-v3's 20 heads)
WIDE = dict(d_model=256, d_ff=512, n_heads=8, kv_heads=8, head_dim=32)
CUT = dict(d_model=256, d_ff=512, n_heads=2, kv_heads=2, head_dim=128)
WHISPER_RUNS = {f"whisper-{h}-{z}": dict(arch="whisper-large-v3", over=over,
                                         zero1=z == "zero1", seq=16)
                for h, over, z in (("heads", WIDE, "fsdp"),
                                   ("heads", WIDE, "zero1"),
                                   ("cut", CUT, "fsdp"))}
for _run in (*TRAIN_RUNS.values(), *WHISPER_RUNS.values()):
    _run.setdefault("seq_parallel", False)

# name -> the reference's moe_block settings: reduced deepseek-v3 at 8
# experts top-2 and reduced grok (4 experts), at a capacity factor where
# nothing drops and at the config's own factor (2.0)
MOE_VARIANTS = {}
for _arch, _moe in (("deepseek-v3-671b", dict(n_experts=8, top_k=2)),
                    ("grok-1-314b", {})):
    for _cf in (8.0, 2.0):
        for _disp, _eod in (("a2a", False), ("replicated", False),
                            ("a2a", True)):
            MOE_VARIANTS[f"{_arch}-{_cf}-{_disp}{'-eod' if _eod else ''}"] = \
                dict(arch=_arch, moe=dict(_moe, capacity_factor=_cf),
                     dispatch=_disp, ep_over_dp=_eod)


def _reference(code: str, out, timeout=300, **values):
    header = "".join(f"{k} = {v!r}\n" for k, v in values.items())
    run_with_devices(f"OUT = {str(out)!r}\n" + header + code,
                     timeout=timeout)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def collectives_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives") / "ref.npz"
    return out, _reference(COLLECTIVES, out)


@pytest.fixture(scope="module")
def moe_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe") / "ref.npz"
    return out, _reference(MOE, out, VARIANTS=MOE_VARIANTS)


@pytest.fixture(scope="module")
def train_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    return d / "ref.npz", _reference(
        TRAIN, d / "ref.npz", timeout=420,
        RUNS={**TRAIN_RUNS, **WHISPER_RUNS},
        CKPT=str(d / "ckpt")), d / "ckpt"


class _Coords:
    def __init__(self, shape, coords):
        self.shape, self.coords = shape, coords


def test_shard_order_is_the_reference_s(collectives_ref):
    """A rank's block under a tuple entry, two sharded dims and one, on a
    (2, 4) mesh: the block the reference gives the device at the same
    coordinates (the first axis of a tuple major)."""
    _, ref = collectives_ref
    x = torch.arange(24 * 8).reshape(24, 8)
    for name, spec in (("tuple", P(("data", "model"), None)),
                       ("both", P("data", "model")),
                       ("model", P(None, "model"))):
        for i in range(2):
            for j in range(4):
                mesh = _Coords({"data": 2, "model": 4},
                               {"data": i, "model": j})
                (a, b), (c, d) = ref[f"order/{name}/{i}/{j}"]
                assert torch.equal(shard(x, Placement(mesh, spec)),
                                   x[a:b, c:d]), (name, i, j)


def test_compressed_and_hierarchical_allreduce_match_reference(
        collectives_ref, tmp_path):
    """compressed_allreduce on 8 ranks: the mean within 1e-6 of the
    reference's, the int8 payload equal to the one the reference's
    residual implies, the residual equal; hierarchical_allreduce on (2, 4)
    ('pod', 'data') within 1e-5 of the sum and of the reference's."""
    path, ref = collectives_ref
    ranks = launch("collectives", 8, tmp_path, timeout=120, ref=str(path))
    g = ref["g"]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["mean"], ref["mean"][r], rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["err"], ref["err"][r])
        scale = np.float32(np.abs(g[r]).max()) / np.float32(127.0)
        payload = np.rint((g[r] - ref["err"][r]) / scale).astype(np.int8)
        np.testing.assert_array_equal(got["q"], payload)
        np.testing.assert_allclose(got["hier"], ref["x"].sum(0), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["hier"], ref["hier"][r], rtol=0,
                                   atol=1e-5)
    # every rank holds (about) the true mean
    true = g.mean(0)
    assert np.abs(ranks[0]["mean"] - true).max() <= np.abs(g).max() / 127


def test_gpipe_matches_sequential_and_reference(collectives_ref, tmp_path):
    path, ref = collectives_ref
    ranks = launch("gpipe", 4, tmp_path, timeout=120, ref=str(path))
    seq = ref["xp"]
    for w in ref["ws"]:
        seq = np.tanh(seq @ w)
    for got in ranks:
        np.testing.assert_allclose(got["pipe"], seq, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["pipe"], ref["pipe"], rtol=0,
                                   atol=1e-5)


def _port_local(ref, v):
    """The port's moe_local on the whole batch, with the reference's
    unsharded weights, and its routing."""
    cfg = moe_variant_cfg(v["arch"], v)
    jcfg = jget_arch(v["arch"]).reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **v["moe"]))
    jp = jmoe.moe_init(jax.random.key(0), jcfg, jnp.float32, 1)
    p = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = torch.from_numpy(ref["x/" + v["arch"]])
    routes = []
    route = moe._route

    def recording(*a):
        out = route(*a)
        routes.append(out[1])
        return out
    moe._route = recording
    try:
        y, aux = moe.moe_block(p, x, cfg)
    finally:
        moe._route = route
    return y.numpy(), aux, routes[0].numpy()


def test_sharded_moe_matches_local_and_reference(moe_ref, tmp_path):
    """a2a and replicated on (2, 4), and a2a over the whole mesh
    (ep_over_dp), for reduced deepseek-v3 (8 experts) and grok: outputs
    within 1e-5 of scale of the port's moe_local and of the reference's
    sharded moe_block, the same routing as moe_local, the aux losses and
    drop_frac equal to the reference's (at the config's own factor too,
    where tokens drop), and none dropped at factor 8."""
    path, ref = moe_ref
    ranks = launch("moe", 8, tmp_path, timeout=180, ref=str(path),
                   variants=MOE_VARIANTS)
    for name, v in MOE_VARIANTS.items():
        y_loc, aux_loc, ids_loc = _port_local(ref, v)
        # rank (d, m) holds dp block d's outputs; model ranks agree
        y = np.concatenate([ranks[4 * d][f"{name}/y"] for d in range(2)])
        for r in range(8):
            np.testing.assert_array_equal(ranks[r][f"{name}/y"],
                                          ranks[r - r % 4][f"{name}/y"])
        scale = max(np.abs(ref[f"{name}/ref/y"]).max(), 1.0)
        np.testing.assert_allclose(y, ref[f"{name}/ref/y"], rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
        for k in ("lb_loss", "z_loss", "drop_frac"):
            for r in range(8):
                np.testing.assert_allclose(ranks[r][f"{name}/{k}"],
                                           ref[f"{name}/ref/{k}"], rtol=1e-5,
                                           atol=1e-6, err_msg=(name, k))
        # the dispatch routes each token as moe_local does
        T = ids_loc.shape[0]
        if v["dispatch"] == "a2a":
            ids = np.concatenate([ranks[r][f"{name}/ids"] for r in range(8)])
        else:
            ids = np.concatenate([ranks[4 * d][f"{name}/ids"]
                                  for d in range(2)])
        assert ids.shape == ids_loc.shape == (T, 2)
        np.testing.assert_array_equal(ids, ids_loc, err_msg=name)
        if v["moe"]["capacity_factor"] == 8.0:
            assert float(ref[f"{name}/ref/drop_frac"]) == 0.0
            assert float(aux_loc["drop_frac"]) == 0.0
            np.testing.assert_allclose(y, y_loc.reshape(y.shape), rtol=0,
                                       atol=1e-5 * scale, err_msg=name)
    assert any(float(ref[f"{n}/ref/drop_frac"]) > 0
               for n in MOE_VARIANTS if "-2.0-" in n)


def _single_device_run(ref, name, rows=None, runs=TRAIN_RUNS):
    """The port's single-device step from the same weights and batch (its
    first ``rows`` rows): (losses, grad norms)."""
    run = runs[name]
    model = build_model(dataclasses.replace(
        get_arch(run["arch"]).reduced(), **run["over"]), "cpu")
    opt = OptConfig(lr=1e-3)
    pre = name + "/init/"
    params = params_from_jax({k[len(pre):]: ref[k] for k in ref
                              if k.startswith(pre)}, "cpu")
    for p in flatten(params).values():
        p.requires_grad_(True)
    state = {"params": params, "opt": init_opt_state(params, opt)}
    step = make_train_step(model, opt, grad_accum=2)
    batch = {k: torch.from_numpy(ref[f"{name}/{k}"][:rows].astype(np.int64))
             for k in ("tokens", "targets")}
    if f"{name}/frames" in ref:
        batch["frames"] = torch.from_numpy(ref[f"{name}/frames"][:rows])
    losses, gnorms = [], []
    for _ in range(4):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return losses, gnorms


@pytest.mark.parametrize("name", list(TRAIN_RUNS))
def test_sharded_train_step_matches_reference(train_ref, tmp_path, name):
    """Reduced qwen1.5-0.5b and the moe family's grok on (2, 4) with
    grad_accum=2, FSDP and ZeRO-1 (and both under seq_parallel, and qwen
    with 2 K/V heads), each tensor-parallel over 'model', against the
    reference's Auto-mesh run of the same settings: the 4 losses within 1e-4 relative and the 4
    gradient norms within 1e-5 relative; after step 4, each leaf's update
    (final minus initial) within 1e-3 of the reference's in norm, Adam's
    two moments within 1e-5 of each leaf's largest (they scale with the
    gradient, which the update does not: a leaf's gradient summed over
    its replicas instead of averaged shows there), and every parameter
    that does not start at zero within 1e-4 of its leaf's scale. qwen's losses also within 1e-5 of
    the port's single-device step and its gradient norms within 1e-5
    relative; grok's are not held to one device: the reference's sharded
    MoE buckets each model rank's tokens at its own capacity and averages
    each rank's aux losses, as one device does not."""
    path, ref, _ = train_ref
    ranks = launch("train", 8, tmp_path, timeout=180, ref=str(path),
                   name=name, **TRAIN_RUNS[name])
    single = _single_device_run(ref, name) \
        if TRAIN_RUNS[name]["arch"] == "qwen1.5-0.5b" else None
    check_train_run(ref, ranks, name, single)


@pytest.mark.parametrize("name", list(WHISPER_RUNS))
def test_whisper_sharded_train_step_matches_reference(train_ref, tmp_path,
                                                      name):
    """The widened whisper on (2, 4), grad_accum 2, its dense layers on
    this rank's columns (the local leaves are the 16 split dense layers):
    FSDP and ZeRO-1 with heads whole, FSDP with a cut head; against the
    reference's Auto-mesh run at the tolerances of
    ``test_sharded_train_step_matches_reference``, and the losses within
    1e-5 and the gradient norms within 1e-5 relative of the port's single
    device."""
    path, ref, _ = train_ref
    run = WHISPER_RUNS[name]
    local = build_model(dataclasses.replace(
        get_arch(run["arch"]).reduced(), **run["over"]), "cpu", make_dist(
        FakeMesh(data=2, model=4), zero1=run["zero1"])).local_leaves
    assert len(local) == 16 and "dec_layers/cross/wq/w" in local
    ranks = launch("train", 8, tmp_path, timeout=240, ref=str(path),
                   name=name, **run)
    check_train_run(ref, ranks, name,
                    _single_device_run(ref, name, runs=WHISPER_RUNS))


def check_train_run(ref, ranks, name, single=None):
    """A sharded train run's ranks against the reference's run ``name``
    (and the port's single device's (losses, grad norms) where given), at
    ``test_sharded_train_step_matches_reference``'s tolerances."""
    for got in ranks:
        np.testing.assert_allclose(got["losses"], ref[name + "/losses"],
                                   rtol=1e-4, atol=0)
        np.testing.assert_allclose(got["gnorms"], ref[name + "/gnorms"],
                                   rtol=1e-5, atol=0)
        if single is not None:
            np.testing.assert_allclose(got["losses"], single[0], rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(got["gnorms"], single[1], rtol=1e-5,
                                       atol=0)
    pre = name + "/final/"
    for k in (k[len(pre):] for k in ref if k.startswith(pre)):
        w, port = ref[pre + k], ranks[0]["params/" + k]
        init = ref[f"{name}/init/{k}"]
        if np.any(init):
            # a leaf that starts at zero (the biases) has its update for
            # its scale: the update's check below holds it
            np.testing.assert_allclose(port, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)
        moved = np.linalg.norm(w - init)
        assert moved > 0, k
        # Adam divides a gradient by its own root mean square, so on the
        # elements of smallest gradient (k's bias) rounding moves the
        # update by about 1e-4 of it in norm; a fault moves it by its size
        assert np.linalg.norm((port - init) - (w - init)) <= 1e-3 * moved, k
        for part in ("m", "v"):
            want = ref[f"{name}/{part}/{k}"]
            np.testing.assert_allclose(ranks[0][f"{part}/{k}"], want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=(part, k))


def test_sharded_step_weights_uneven_shares(train_ref, tmp_path):
    """Microbatches of 3 rows over 2 dp ranks (2 rows and 1): each rank's
    loss weighted by its share, so the losses are the single-device
    step's mean over the whole batch (1e-5)."""
    path, ref, _ = train_ref
    ranks = launch("train", 2, tmp_path, timeout=120, ref=str(path),
                   name="qwen-fsdp", mesh=[2, 1], rows=6,
                   **TRAIN_RUNS["qwen-fsdp"])
    single, _ = _single_device_run(ref, "qwen-fsdp", rows=6)
    for got in ranks:
        np.testing.assert_allclose(got["losses"], single, rtol=0, atol=1e-5)


def test_elastic_restore_onto_other_meshes(train_ref, tmp_path):
    """The reference's checkpoint of its (2, 4) state restored onto (4, 2)
    and (8, 1) meshes (each rank keeping only its shards) and onto one
    device: gathered back, every leaf equal to the file's bit for bit;
    saved again from the (4, 2) and (8, 1) shards, the same arrays."""
    _, _, ckpt = train_ref
    with np.load(ckpt / "step_4" / "arrays.npz") as z:
        saved = {k: z[k] for k in z.files}
    ranks = launch("elastic", 8, tmp_path, timeout=120, ckpt=str(ckpt),
                   arch="qwen1.5-0.5b", meshes=[[4, 2], [8, 1]],
                   out=str(tmp_path / "saved"))
    total = sum(a.size for a in saved.values())
    for tag in ("4x2", "8x1"):
        for got in ranks:
            assert int(got[f"{tag}/step"]) == 4
            assert int(got[f"{tag}/local_numel"]) < total
            for k, a in saved.items():
                np.testing.assert_array_equal(got[f"{tag}/{k}"], a,
                                              err_msg=(tag, k))
        # saved again from the shards: the same file contents
        with np.load(tmp_path / "saved" / tag / "step_4" / "arrays.npz") as z:
            assert sorted(z.files) == sorted(saved)
            for k, a in saved.items():
                assert z[k].dtype == a.dtype
                np.testing.assert_array_equal(z[k], a, err_msg=(tag, k))
    model = build_model(get_arch("qwen1.5-0.5b").reduced(), "cpu")
    abstract = model.abstract_params()
    like = {"params": abstract,
            "opt": init_opt_state(abstract, OptConfig(lr=1e-3))}
    one, meta = elastic_restore(CheckpointManager(ckpt), like, no_dist(),
                                device="cpu")
    assert meta["step"] == 4
    for k, t in flatten(one).items():
        np.testing.assert_array_equal(t.detach().numpy(), saved[k])
