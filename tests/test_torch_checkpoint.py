"""Port parity: the checkpoint manager (``repro_torch.checkpoint.manager``)
and the elastic restart plan, case for case as ``tests/test_checkpoint.py``
on the CPU, plus the cross-format check: a checkpoint written by the JAX
package restores in the port by ``like=``, and one written by the port
restores in the JAX package, with equal leaves and identical manifest
paths, dtypes and sha1s (a dict, a NamedTuple, an int32 scalar and a
bfloat16 leaf).  The reference's elastic case restores an LM train
state, not ported yet; here it restores a detector train state."""
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.distributed.fault_tolerance import plan_restart as jax_plan_restart
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import reduced_snn
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     plan_restart)
from repro_torch.optim.adamw import tree_leaves, tree_unflatten


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.tensor(rng.normal(0, 1, (8, 4)).astype(np.float32)),
            "b": {"c": torch.tensor(rng.integers(0, 10, (3,))),
                  "d": torch.tensor(1.5)}}


def _leaves(tree):
    return [x for _, x in tree_leaves(tree)]


def _assert_trees_equal(want, got):
    a, b = _leaves(want), _leaves(got)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    t = _tree()
    cm.save(10, t)
    _assert_trees_equal(t, cm.restore(like=t))


def test_async_save_with_wait(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=True)
    cm.save(1, _tree())
    cm.wait()
    assert cm.latest_step() == 1


def test_retention(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree(s))
    assert cm.all_steps() == [3, 4]


def test_async_write_failure_surfaces(tmp_path):
    """A failed background write raises on the next wait()/save, and the
    manager is usable again after the raise."""
    cm = CheckpointManager(str(tmp_path), async_write=True)

    def boom(*a, **k):
        raise IOError("disk full")
    cm._write = boom
    cm.save(1, _tree())
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        cm.wait()
    cm._write = boom
    cm.save(2, _tree())
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        cm.save(3, _tree())
    del cm.__dict__["_write"]
    cm.save(4, _tree())
    cm.wait()
    assert cm.latest_step() == 4


def test_corruption_detected(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    t = _tree()
    cm.save(5, t)
    fn = os.path.join(str(tmp_path), "step_000000005", "leaf_00000.npy")
    arr = np.load(fn)
    arr.flat[0] += 1
    np.save(fn, arr)
    with pytest.raises(IOError, match="corruption"):
        cm.restore(like=t)


def test_truncated_leaf_detected(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    t = _tree()
    cm.save(5, t)
    fn = os.path.join(str(tmp_path), "step_000000005", "leaf_00000.npy")
    blob = open(fn, "rb").read()
    with open(fn, "wb") as f:
        f.write(blob[:len(blob) // 2])
    with pytest.raises(IOError, match="corruption"):
        cm.restore(like=t)


def test_restore_falls_back_to_newest_intact(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(10, _tree(1))
    cm.save(20, _tree(2))
    fn = os.path.join(str(tmp_path), "step_000000020", "leaf_00000.npy")
    blob = open(fn, "rb").read()
    with open(fn, "wb") as f:
        f.write(blob[:10])
    _assert_trees_equal(_tree(1), cm.restore(like=_tree()))
    # an explicit step is never silently substituted
    with pytest.raises(IOError, match="corruption"):
        cm.restore(step=20, like=_tree())
    cm.restore(step=10, like=_tree())


def test_torn_manifest_falls_back(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, _tree(1))
    cm.save(2, _tree(2))
    mf = os.path.join(str(tmp_path), "step_000000002", "manifest.json")
    with open(mf, "w") as f:
        f.write('{"step": 2, "leaves": [')      # torn mid-write
    _assert_trees_equal(_tree(1), cm.restore(like=_tree()))


def test_checksum_file_written_and_verified(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(7, _tree())
    d = os.path.join(str(tmp_path), "step_000000007")
    assert os.path.exists(os.path.join(d, "CHECKSUM"))
    mf = os.path.join(d, "manifest.json")
    manifest = json.load(open(mf))
    manifest["step"] = 999
    with open(mf, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(IOError, match="corruption"):
        cm.restore(like=_tree())


def test_no_tmp_dir_published_on_crash(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    os.makedirs(os.path.join(str(tmp_path), "step_000000099.tmp"))
    assert cm.latest_step() is None


def test_heartbeat_dead_and_straggler():
    clock = [0.0]
    mon = HeartbeatMonitor(["w0", "w1", "w2"], timeout_s=10,
                           straggler_factor=2.0, patience=3,
                           clock=lambda: clock[0])
    for _ in range(5):
        clock[0] += 1.0
        mon.heartbeat("w0", step_time_s=1.0)
        mon.heartbeat("w1", step_time_s=1.0)
        mon.heartbeat("w2", step_time_s=5.0)   # straggler
    assert mon.stragglers() == {"w2"}
    assert mon.dead_workers() == set()
    clock[0] += 20.0
    mon.heartbeat("w0")
    mon.heartbeat("w2")
    assert mon.dead_workers() == {"w1"}


def test_plan_restart_elastic_mesh():
    plan = plan_restart(n_devices_alive=192, ckpt_latest=730,
                        model_parallel=16, steps_per_checkpoint=100)
    assert plan.new_mesh_shape == (12, 16)
    assert plan.restore_step == 730
    assert plan.dropped_batches == 30
    plan = plan_restart(n_devices_alive=24, ckpt_latest=None)
    dp, mp = plan.new_mesh_shape
    assert dp * mp == 24


@pytest.mark.parametrize("args", [
    (256, 500, {}), (192, 500, {}), (200, 500, {}),
    (6, 500, {"model_parallel": 4}), (7, 500, {}), (64, None, {}),
    (64, 700, {"steps_per_checkpoint": 100, "failed_step": 773}),
    (64, 700, {"failed_step": 700}),
    (64, 730, {"steps_per_checkpoint": 100}),
    (0, 500, {}), (-8, 500, {}), (64, 700, {"failed_step": 650})])
def test_plan_restart_matches_reference(args):
    n, latest, kw = args
    try:
        want = jax_plan_restart(n, latest, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            plan_restart(n, latest, **kw)
        return
    got = plan_restart(n, latest, **kw)
    assert (got.survivors, got.new_mesh_shape, got.restore_step,
            got.dropped_batches) == (want.survivors, want.new_mesh_shape,
                                     want.restore_step, want.dropped_batches)


def test_elastic_restore_onto_smaller_state(tmp_path):
    """A whole detector train state (params, AdamW moments, the int32
    step) round-trips, and restores onto a freshly initialised one."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.detector import init_detector_state
    cfg = reduced_snn("spiking_yolo")
    st = init_detector_state(torch.Generator().manual_seed(0), cfg,
                             AdamWConfig(), device="cpu")
    st = st._replace(step=st.step + 3)
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(3, st)
    fresh = init_detector_state(torch.Generator().manual_seed(1), cfg,
                                AdamWConfig(), device="cpu")
    got = cm.restore(like=fresh)
    assert type(got) is type(st) and int(got.step) == 3
    _assert_trees_equal(st, got)


def test_trainer_resume(tmp_path):
    """Kill-and-restart: the trainer resumes from the checkpoint and
    reaches the uninterrupted run's final state, bit for bit."""
    from repro_torch.core.npu import init_npu
    from repro_torch.core.train import init_snn_state, make_snn_train_step
    from repro_torch.data.synthetic import make_scene_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer

    cfg = reduced_snn("spiking_yolo")
    opt = AdamWConfig(lr=1e-3)

    def mk_state():
        return init_snn_state(init_npu(torch.Generator().manual_seed(0), cfg,
                                       device="cpu"), opt)

    step = make_snn_train_step(cfg, opt)

    def data(s):
        return make_scene_batch(torch.Generator().manual_seed(s), batch=2,
                                height=cfg.height, width=cfg.width,
                                time_steps=cfg.time_steps, device="cpu")

    quiet = dict(log_fn=lambda *_: None)
    ref = Trainer(step, mk_state(), data, **quiet).run(6)
    cm = CheckpointManager(str(tmp_path), async_write=False)
    Trainer(step, mk_state(), data, ckpt=cm, ckpt_every=2, **quiet).run(4)
    cm2 = CheckpointManager(str(tmp_path), async_write=False)
    tr2 = Trainer(step, mk_state(), data, ckpt=cm2, ckpt_every=2, **quiet)
    resumed = tr2.run(6)
    assert [h["step"] for h in tr2.history] == [4, 5]
    _assert_trees_equal(ref, resumed)


# ---------------------------------------------------------------------------
# one format: the JAX package's checkpoints restore in the port, and back
# ---------------------------------------------------------------------------

class Pair(NamedTuple):
    first: object
    second: object


def _cross_trees():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (3, 5)).astype(np.float32)
    h = rng.normal(0, 1, (4,)).astype(np.float32)
    bf = rng.normal(0, 1, (2, 3)).astype(np.float32)
    jtree = {"w": jnp.asarray(w),
             "pair": Pair(jnp.asarray(h), jnp.asarray(7, jnp.int32)),
             "z": {"bf": jnp.asarray(bf, jnp.bfloat16)}}
    ttree = {"w": torch.tensor(w),
             "pair": Pair(torch.tensor(h), torch.tensor(7, dtype=torch.int32)),
             "z": {"bf": torch.tensor(bf).to(torch.bfloat16)}}
    return jtree, ttree


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
        return [(r["path"], r["dtype"], r["shape"], r["sha1"])
                for r in json.load(f)["leaves"]]


def _as_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def test_reference_checkpoint_restores_in_port(tmp_path):
    jtree, ttree = _cross_trees()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    JaxCheckpointManager(jdir, async_write=False).save(4, jtree)
    CheckpointManager(tdir, async_write=False).save(4, ttree)
    assert _manifest(jdir, 4) == _manifest(tdir, 4)
    got = CheckpointManager(jdir).restore(like=ttree)
    assert isinstance(got["pair"], Pair)
    _assert_trees_equal(ttree, got)
    assert got["z"]["bf"].dtype == torch.bfloat16
    assert got["pair"].second.dtype == torch.int32 and \
        got["pair"].second.shape == ()


def test_port_checkpoint_restores_in_reference(tmp_path):
    jtree, ttree = _cross_trees()
    CheckpointManager(str(tmp_path), async_write=False).save(9, ttree)
    got = JaxCheckpointManager(str(tmp_path)).restore(like=jtree)
    assert isinstance(got["pair"], Pair)
    want = jax.tree_util.tree_leaves(jtree)
    have = jax.tree_util.tree_leaves(got)
    assert len(want) == len(have)
    for a, b in zip(want, have):
        assert str(np.asarray(a).dtype) == str(np.asarray(b).dtype)
        np.testing.assert_array_equal(np.asarray(a).astype(np.float64),
                                      np.asarray(b).astype(np.float64))
    for t, b in zip(_leaves(ttree), have):
        np.testing.assert_array_equal(_as_numpy(t),
                                      np.asarray(b).astype(np.float32))


def test_tree_leaves_is_jax_order():
    """Paths and leaf order are JAX's (``tree_flatten_with_path``)."""
    from repro.checkpoint.manager import _tree_paths
    jtree, ttree = _cross_trees()
    jtree["list"] = [jnp.zeros(1), (jnp.ones(2), None)]
    ttree["list"] = [torch.zeros(1), (torch.ones(2), None)]
    assert [p for p, _ in tree_leaves(ttree)] == _tree_paths(jtree)
    rebuilt = tree_unflatten(ttree, [x + 0 for x in _leaves(ttree)])
    _assert_trees_equal(ttree, rebuilt)
    assert rebuilt["list"][1][1] is None and isinstance(rebuilt["pair"], Pair)
