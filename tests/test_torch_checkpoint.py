"""The port's checkpoint manager: the reference's own cases (atomic
roundtrip, async save, keep-N GC, crash recovery, shape mismatch, a
specific step) and checkpoints across the two packages. An fp32 state
written by either restores in the other; a bf16 file written by the
reference's ``CheckpointManager`` restores in the port bit for bit, which
the reference's own restore cannot do (ROADMAP §3)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.bridge import flatten
from repro_torch.train.checkpoint import CheckpointManager


def _state(seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=gen).to(dtype),
                       "b": torch.zeros(8, dtype=dtype)},
            "opt": {"m": torch.ones(8, 8) * 0.5,
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _jstate(seed=0, dtype=jnp.float32):
    k = jax.random.key(seed)
    return {"params": {"w": jax.random.normal(k, (8, 8)).astype(dtype),
                       "b": jnp.zeros((8,), dtype)},
            "opt": {"m": jnp.ones((8, 8)) * 0.5,
                    "step": jnp.asarray(7, jnp.int32)}}


def _assert_equal(got, want):
    for k, w in flatten(want).items():
        g = flatten(got)[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


def test_roundtrip(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=False)
    st = _state()
    cm.save(10, st, {"data": {"cursor": 42}})
    got, meta = cm.restore(st)
    assert meta["step"] == 10 and meta["data"]["cursor"] == 42
    _assert_equal(got, st)


def test_bf16_roundtrip_keeps_the_bits(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=False)
    st = _state(dtype=torch.bfloat16)
    cm.save(1, st)
    with np.load(tmp_path / "step_1" / "arrays.npz") as z:
        assert z["params/w"].dtype.str == "|V2"
    got, _ = cm.restore(st)
    _assert_equal(got, st)


def test_async_save_and_wait(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=True)
    cm.save(1, _state())
    cm.wait()
    assert cm.latest_step() == 1


def test_keep_n_gc(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        cm.save(s, _state())
    assert cm.steps() == [3, 4]


def test_stale_tmp_cleanup(tmp_path):
    stale = Path(tmp_path) / "step_9.tmp.999"
    stale.mkdir(parents=True)
    cm = CheckpointManager(tmp_path, async_save=False)
    assert cm.latest_step() is None
    cm.save(10, _state())
    assert not stale.exists()
    assert cm.steps() == [10]


def test_restore_shape_mismatch_raises(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=False)
    cm.save(1, _state())
    bad = _state()
    bad["params"]["w"] = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        cm.restore(bad)


def test_restore_specific_step(tmp_path):
    cm = CheckpointManager(tmp_path, keep=5, async_save=False)
    for s in (1, 2, 3):
        cm.save(s, _state(seed=s))
    got, meta = cm.restore(_state(), step=2)
    assert meta["step"] == 2
    _assert_equal(got, _state(seed=2))


def test_reference_fp32_checkpoint_restores_in_the_port(tmp_path):
    st = _jstate()
    JCheckpointManager(tmp_path, async_save=False).save(
        3, st, {"data": {"cursor": 5}})
    got, meta = CheckpointManager(tmp_path).restore(_state())
    assert meta["step"] == 3 and meta["data"] == {"cursor": 5}
    for path, leaf in jax.tree_util.tree_leaves_with_path(st):
        key = "/".join(str(k.key) for k in path)
        np.testing.assert_array_equal(flatten(got)[key].numpy(),
                                      np.asarray(leaf))


def test_port_fp32_checkpoint_restores_in_the_reference(tmp_path):
    st = _state()
    CheckpointManager(tmp_path, async_save=False).save(
        3, st, {"data": {"cursor": 5}})
    got, meta = JCheckpointManager(tmp_path).restore(
        jax.eval_shape(lambda: _jstate()))
    assert meta["step"] == 3 and meta["data"] == {"cursor": 5}
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        key = "/".join(str(k.key) for k in path)
        want = flatten(st)[key].numpy()
        assert np.asarray(leaf).dtype == want.dtype, key
        np.testing.assert_array_equal(np.asarray(leaf), want)


def test_reference_bf16_checkpoint_restores_in_the_port_bit_for_bit(
        tmp_path):
    st = _jstate(dtype=jnp.bfloat16)
    JCheckpointManager(tmp_path, async_save=False).save(1, st)
    got, _ = CheckpointManager(tmp_path).restore(
        _state(dtype=torch.bfloat16))
    for path, leaf in jax.tree_util.tree_leaves_with_path(st):
        key = "/".join(str(k.key) for k in path)
        g = flatten(got)[key]
        want = np.asarray(leaf)
        if want.dtype.itemsize == 2:
            assert g.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), want)


def test_the_reference_cannot_restore_its_own_bf16_checkpoint(tmp_path):
    """A difference of the reference, not of the port: ``np.savez``
    writes a bf16 leaf as raw ``|V2``, and its restore's ``astype`` has no
    cast from it (ROADMAP §3). When this starts to pass, the reference was
    fixed and §3 is out of date."""
    st = _jstate(dtype=jnp.bfloat16)
    cm = JCheckpointManager(tmp_path, async_save=False)
    cm.save(1, st)
    with pytest.raises((TypeError, ValueError)):
        cm.restore(jax.eval_shape(lambda: st))
