"""The port's training path against the reference's: one AdamW step, the
reduced ``launch.train`` loss curve, gradient accumulation, determinism
and a bit-exact checkpoint resume on the CPU.

AdamW runs on identical parameters and gradients in both packages (numpy
from a seed) and agrees at 1e-6, weight decay included: as in the
reference it applies to every leaf of two or more dims, so a norm scale
stacked on the layer axis ([L, d]) is decayed and ``final_norm`` ([d]) is
not. The 5-step ``--reduced`` curves of both launchers start from one
checkpoint that the reference writes, so both train the same weights on
the same batches, and agree at 1e-4."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch.train import main as jtrain_main
from repro.models.api import build_model as jbuild_model
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.bridge import flatten
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, DataState, Pipeline
from repro_torch.launch.train import main as train_main
from repro_torch.models.api import build_model
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import init_train_state, make_train_step
from test_torch_model import flatten_jax


def _tree(seed, L=3, d=8, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa
    return {"layers": {"norm1": {"scale": f(L, d)}, "w": f(L, d, d)},
            "final_norm": {"scale": f(d)}, "embed": f(16, d)}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_steps_match_reference(state_dtype):
    """Three steps with fresh grads each, the second's large enough that
    clipping acts; params, moments, step, grad norm and lr at 1e-6."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10,
               state_dtype=state_dtype)
    jc, tc = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    jp, tp = _jax(_tree(0)), _torch(_tree(0))
    js, ts = jopt.init_opt_state(jp, jc), topt.init_opt_state(tp, tc)
    for i, scale in enumerate((0.1, 10.0, 0.01)):
        g = _tree(10 + i, scale=scale)
        jp, js, jstats = jopt.adamw_update(jp, _jax(g), js, jc)
        tp, ts, tstats = topt.adamw_update(tp, _torch(g), ts, tc)
        for name, j, t in (("params", jp, tp), ("m", js["m"], ts["m"]),
                           ("v", js["v"], ts["v"])):
            for k, w in flatten_jax(j).items():
                got = flatten(t)[k]
                assert str(got.dtype).endswith(state_dtype) or name == \
                    "params", (name, k, got.dtype)
                np.testing.assert_allclose(got.float().numpy(),
                                           np.asarray(w, np.float32),
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"{name}/{k} step {i}")
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for k in ("grad_norm", "lr"):
            assert float(tstats[k]) == pytest.approx(float(jstats[k]),
                                                     rel=1e-6)


def test_weight_decay_follows_ndim_like_the_reference():
    """Zero grads: only weight decay moves a leaf. Leaves of two or more
    dims move (the stacked norm scale [L, d] among them), the [d]
    ``final_norm`` does not, in both packages."""
    c = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    jc, tc = jopt.OptConfig(**c), topt.OptConfig(**c)
    p, zero = _tree(0), _tree(0, scale=0.0)
    jp, _, _ = jopt.adamw_update(_jax(p), _jax(zero),
                                 jopt.init_opt_state(_jax(p), jc), jc)
    tp, _, _ = topt.adamw_update(_torch(p), _torch(zero),
                                 topt.init_opt_state(_torch(p), tc), tc)
    for k, before in flatten_jax(p).items():
        moved_t = not np.array_equal(flatten(tp)[k].numpy(), before)
        moved_j = not np.array_equal(np.asarray(flatten_jax(jp)[k]), before)
        assert moved_t == moved_j == (before.ndim >= 2), k


def test_reduced_loss_curve_matches_reference(tmp_path):
    """Both launchers resume from one checkpoint the reference writes at
    step 0 and train 5 steps on the same pipeline."""
    cfg = jget_arch("qwen1.5-0.5b").reduced()
    state = jloop.init_train_state(jbuild_model(cfg), jax.random.key(0),
                                   jopt.OptConfig())
    JCheckpointManager(tmp_path / "seed", async_save=False).save(
        0, state, {"data": {"cursor": 0}})
    for name in ("ref", "port"):
        shutil.copytree(tmp_path / "seed", tmp_path / name)
    argv = ["--reduced", "--steps", "5", "--batch", "4", "--seq", "32"]
    want = jtrain_main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    got = train_main(argv + ["--ckpt-dir", str(tmp_path / "port"),
                             "--device", "cpu"])
    assert got.start_step == 0 and len(got.losses) == 5
    np.testing.assert_allclose(got.losses, want, rtol=0, atol=1e-4)
    assert CheckpointManager(tmp_path / "port").latest_step() == 5


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "grok-1-314b",
                                  "zamba2-2.7b", "rwkv6-3b",
                                  "whisper-large-v3"])
def test_launcher_trains_every_family(arch):
    out = train_main(["--arch", arch, "--reduced", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert len(out.losses) == 2 and np.isfinite(out.losses).all()
    assert all(p.requires_grad for p in flatten(out.state["params"]).values())


def _setup(lr=3e-3, steps=60):
    cfg = get_arch("qwen1.5-0.5b").reduced()
    model = build_model(cfg, "cpu")
    opt = topt.OptConfig(lr=lr, warmup_steps=5, total_steps=steps)
    return cfg, model, opt


def _random_batch(cfg, B, S):
    rng = np.random.default_rng(1)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                .astype(np.int32))
            for k in ("tokens", "targets")}


def test_train_step_deterministic():
    cfg, model, opt = _setup()
    batch = _random_batch(cfg, 4, 32)
    outs = []
    for _ in range(2):
        step = make_train_step(model, opt)
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 opt)
        state, m = step(state, batch)
        outs.append((float(m["loss"]),
                     next(iter(flatten(state["params"]).values()))))
    assert outs[0][0] == outs[1][0]
    assert torch.equal(outs[0][1], outs[1][1])


def test_grad_accum_matches_full_batch():
    """The reference's own bounds (tests/test_system.py): 2e-5 on the
    loss, 5e-5 on the weights."""
    cfg, model, opt = _setup(lr=1e-3)
    batch = _random_batch(cfg, 8, 32)
    s1, m1 = make_train_step(model, opt, grad_accum=1)(
        init_train_state(model, torch.Generator().manual_seed(0), opt),
        batch)
    s4, m4 = make_train_step(model, opt, grad_accum=4)(
        init_train_state(model, torch.Generator().manual_seed(0), opt),
        batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 2e-5
    for k, w1 in flatten(s1["params"]).items():
        w4 = flatten(s4["params"])[k]
        np.testing.assert_allclose(w1.detach().double().numpy(),
                                   w4.detach().double().numpy(), rtol=0,
                                   atol=5e-5, err_msg=k)


def test_checkpoint_resume_bit_exact(tmp_path):
    cfg, model, opt = _setup()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    pipe = Pipeline(dcfg)
    step = make_train_step(model, opt)
    state = init_train_state(model, torch.Generator().manual_seed(0), opt)
    cm = CheckpointManager(tmp_path, async_save=False)

    def batch_of(p):
        return {k: torch.from_numpy(v) for k, v in p.next_batch().items()}

    for _ in range(3):
        state, _ = step(state, batch_of(pipe))
    cm.save(3, state, {"data": pipe.state.to_dict()})
    batch4 = batch_of(pipe)
    direct, m_direct = step(state, batch4)

    restored, meta = cm.restore(state)
    for p in flatten(restored["params"]).values():
        p.requires_grad_(True)
    pipe2 = Pipeline(dcfg, state=DataState.from_dict(meta["data"]))
    batch4b = batch_of(pipe2)
    assert torch.equal(batch4["tokens"], batch4b["tokens"])
    resumed, m_resumed = step(restored, batch4b)
    assert float(m_direct["loss"]) == float(m_resumed["loss"])
    for k, a in flatten(direct).items():
        assert torch.equal(a, flatten(resumed)[k]), k


def test_launcher_resumes_where_it_stopped(tmp_path):
    """A 10-step run that checkpoints every 5 steps, resumed from its
    step-5 checkpoint alone, retraces its losses bit for bit. As in the
    reference, the checkpoint labelled 5 is taken after step 5's update
    (6 updates, data cursor 6), so the resumed run's first 4 losses are
    the whole run's steps 6-9."""
    argv = ["--reduced", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--steps", "10", "--ckpt-every", "5"]
    whole = train_main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    assert CheckpointManager(tmp_path / "a").steps() == [5, 10]
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_5", tmp_path / "b" / "step_5")
    rest = train_main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert rest.start_step == 5 and len(rest.losses) == 5
    assert rest.losses[:4] == whole.losses[6:10]


def test_launcher_dtype_flag_sets_params_and_compute():
    argv = ["--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
            "--device", "cpu"]
    plain = train_main(argv)
    half = train_main(argv + ["--dtype", "bfloat16"])
    assert {p.dtype for p in flatten(plain.state["params"]).values()} == {
        torch.float32}
    assert torch.bfloat16 in {
        p.dtype for p in flatten(half.state["params"]).values()}
    assert np.isfinite(half.losses).all()
    assert half.losses != plain.losses


def test_launcher_profiles_one_step_in_the_loop_ranges():
    """``--profile-step`` runs that step of the loop under the profiler
    and changes no loss; the step's parts are the loop's named ranges."""
    argv = ["--reduced", "--steps", "3", "--batch", "2", "--seq", "16",
            "--device", "cpu"]
    plain = train_main(argv)
    traced = train_main(argv + ["--profile-step", "1"])
    assert plain.profile is None and traced.losses == plain.losses
    names = [e.name for e in traced.profile.events()]
    for part in ("forward", "backward", "optimizer",
                 "flash_attention backward"):
        assert part in names, part
    assert names.count("forward") == 1
