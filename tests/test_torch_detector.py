"""Port parity: end-to-end spiking-YOLO detector training
(``repro_torch.train.detector``), the cases of
``tests/test_detector_training.py`` on the CPU, and the port held to the
JAX package's ``repro.train.detector``:

- the loss falls over 30 steps; the ``"torch"`` and ``"cuda"`` configs
  take the same step (on the CPU the ``"cuda"`` wrappers run their plain
  versions); kill-and-resume is bit-exact; the AP and NMS fixtures;
- one ``make_detector_train_step`` step on the reference's scene and
  parameters (carried across as numpy) within 1e-5 (loss, relative) and
  1e-4 (parameters, max |diff| over max |want| per leaf) of the
  reference's jitted step;
- ``make_detector_train_step`` bit-equal to ``make_snn_train_step``'s
  detect step;
- the port's eval on the reference's eval scenes, parameters and forward
  outputs: AP and sparsity within 1e-6 of the reference's
  ``evaluate_detector``; the port's forward there held to the
  reference's layer by layer (the near-threshold rule), and its own
  forward-plus-eval AP within 1e-6 of the reference's on the batches
  where no spike flipped;
- ``TRAIN_CONFIGS`` field by field against the reference's (backend
  names mapped); the launcher on the CPU through ``train_detector`` on
  the kernel backend, as a module with a resume, an LM arch refused, a
  mesh refused; the trainer's heartbeats.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import TRAIN_CONFIGS as JAX_TRAIN_CONFIGS
from repro.core import layers as jax_layers
from repro.core.encoding import voxel_batch as jax_voxel_batch
from repro.core.npu import npu_forward as jax_npu_forward
from repro.data.synthetic import make_scene_batch as jax_make_scene_batch
from repro.distributed.sharding import MeshAxes
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro.train import detector as jdet
from repro_torch import convert
from repro_torch.configs.registry import TRAIN_CONFIGS, get_train_config
from repro_torch.core import layers as tlayers
from repro_torch.core.npu import NPUOutput, npu_forward
from repro_torch.core.train import SNNTrainState, make_snn_train_step
from repro_torch.core.yolo import average_precision, nms_greedy
from repro_torch.launch import train as launch_train
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train import detector as det
from repro_torch.testing import spike_mismatch
from repro_torch.train.detector import (DetectorTrainState,
                                        init_detector_state, make_data_fn,
                                        make_detector_train_step,
                                        resolve_snn_config, resume_from,
                                        train_detector)
from repro_torch.train.trainer import Trainer

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# its layer walk of a backbone, held to the backbones' code elsewhere
import chip_smoke  # noqa: E402

EVAL = dict(eval_seed=1000, batches=2, batch=4, max_boxes=4, n_events=2048)


def _opt(tc):
    return AdamWConfig(lr=tc.lr, weight_decay=tc.weight_decay,
                       grad_clip=tc.grad_clip)


def _maxrel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def _smoke(**kw):
    return dataclasses.replace(TRAIN_CONFIGS["detector_smoke"], shard=False,
                               **kw)


def _quiet(*a, **k):
    return None


# ---------------------------------------------------------------------------
# training dynamics (test_detector_training.py:45-96)
# ---------------------------------------------------------------------------

def test_detector_loss_decreases():
    tc = _smoke(batch=4)
    cfg = resolve_snn_config(tc)
    state = init_detector_state(torch.Generator().manual_seed(0), cfg,
                                _opt(tc), device="cpu")
    step = make_detector_train_step(cfg, _opt(tc))
    data = make_data_fn(tc, cfg, device="cpu")
    losses = []
    for s in range(30):
        state, m = step(state, data(s))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5]), losses
    assert int(state.step) == 30


def test_detector_step_backend_parity():
    """The same AdamW step through the "torch" and "cuda" spike paths
    lands on matching parameters."""
    tc = _smoke(batch=2)
    scene = make_data_fn(tc, resolve_snn_config(tc), device="cpu")(0)
    outs = {}
    for backend in ("torch", "cuda"):
        cfg = resolve_snn_config(dataclasses.replace(tc, backend=backend))
        state = init_detector_state(torch.Generator().manual_seed(0), cfg,
                                    _opt(tc), device="cpu")
        state, m = make_detector_train_step(cfg, _opt(tc))(state, scene)
        assert np.isfinite(float(m["loss"]))
        outs[backend] = (dict(tree_leaves(state.params)), float(m["loss"]))
    assert outs["cuda"][1] == pytest.approx(outs["torch"][1], rel=1e-5)
    for k, v in outs["torch"][0].items():
        assert _maxrel(outs["cuda"][0][k], v) <= 1e-4, k


def test_train_detector_resume_bitexact(tmp_path):
    """Kill-and-resume: the mid-run checkpoint replayed lands on the
    uninterrupted run's parameters, moments and step, bit for bit."""
    tc = _smoke(steps=6, batch=2, ckpt_every=2, eval_batches=1,
                eval_batch=2, log_every=10 ** 9)
    report = train_detector(tc, ckpt_dir=str(tmp_path), log=_quiet,
                            device="cpu")
    assert len(report.history) == 6 and report.step_time_s > 0
    assert 0.0 <= report.ap_after <= 1.0 and 0.0 < report.sparsity < 1.0
    resumed = resume_from(tc, str(tmp_path), at_step=4, log=_quiet,
                          device="cpu")
    a, b = tree_leaves(report.state), tree_leaves(resumed)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), path


def test_train_detector_refuses_a_mesh(monkeypatch):
    """With several cards visible and ``shard`` on, the run raises (the
    sharded path is not ported); one card or ``shard=False`` trains."""
    tc = TRAIN_CONFIGS["detector_smoke"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        det._check_one_device(tc, torch.device("cuda"))
    det._check_one_device(dataclasses.replace(tc, shard=False),
                          torch.device("cuda"))
    det._check_one_device(tc, torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    det._check_one_device(tc, torch.device("cuda"))


# ---------------------------------------------------------------------------
# eval metric fixtures (test_detector_training.py:103-142)
# ---------------------------------------------------------------------------

def test_average_precision_hand_computed():
    gt = np.array([[0.0, 0.0, 1.0, 1.0]])
    tp = np.array([[0.0, 0.0, 1.0, 1.0]])
    fp = np.array([[2.0, 2.0, 3.0, 3.0]])
    ap = average_precision([np.concatenate([fp, tp])],
                           [np.array([0.9, 0.8])], [gt])
    assert ap == pytest.approx(0.5)
    assert average_precision([tp], [np.array([0.9])], [gt]) \
        == pytest.approx(1.0)
    empty_b, empty_s = np.zeros((0, 4)), np.zeros((0,))
    assert average_precision([empty_b], [empty_s], [gt]) == 0.0
    assert average_precision([fp], [np.array([0.9])],
                             [np.zeros((0, 4))]) == 0.0


def test_average_precision_duplicate_detections_penalised():
    gt = np.array([[0.0, 0.0, 1.0, 1.0], [3.0, 0.0, 4.0, 1.0]])
    p1 = np.array([0.0, 0.0, 1.0, 0.7])
    p2 = np.array([0.0, 0.35, 1.0, 1.0])
    p3 = np.array([3.0, 0.0, 4.0, 1.0])
    ap = average_precision([np.stack([p1, p2, p3])],
                           [np.array([0.9, 0.8, 0.7])], [gt])
    assert ap == pytest.approx(0.5 + 0.5 * 2 / 3)


def test_nms_greedy_chain():
    boxes = np.array([[0.0, 0.0, 1.0, 1.0],
                      [0.3, 0.0, 1.3, 1.0],
                      [0.6, 0.0, 1.6, 1.0]])
    np.testing.assert_array_equal(nms_greedy(boxes), [0, 2])
    assert nms_greedy(np.zeros((0, 4))).shape == (0,)


# ---------------------------------------------------------------------------
# against the reference's step and eval
# ---------------------------------------------------------------------------

def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """The reference's "detector_smoke" state (its jitted init), its
    first training batch (batch 2), one jitted step, and its eval."""
    jtc = dataclasses.replace(JAX_TRAIN_CONFIGS["detector_smoke"], batch=2,
                              shard=False)
    jcfg = jdet.resolve_snn_config(jtc)
    jopt = JaxAdamWConfig(lr=jtc.lr, weight_decay=jtc.weight_decay,
                          grad_clip=jtc.grad_clip)
    sched = jax_warmup_cosine(jtc.lr, warmup=jtc.warmup, total=jtc.steps,
                              min_ratio=jtc.min_lr_ratio)
    state = jax.jit(lambda k: jdet.init_detector_state(k, jcfg, jopt))(
        jax.random.PRNGKey(0))
    scene = jdet.make_data_fn(jtc, jcfg, MeshAxes())(0)
    new, metrics = jdet.make_detector_train_step(jcfg, jopt, sched)(
        state, scene)
    ap, sp = jdet.evaluate_detector(state.params, jcfg, **EVAL)
    return dict(jtc=jtc, jcfg=jcfg, state=_numpy(state), scene=_numpy(scene),
                new=_numpy(new), metrics=_numpy(metrics), ap=ap, sp=sp)


def _port_state(st) -> DetectorTrainState:
    return DetectorTrainState(
        params=convert.params_from_numpy(st.params, "cpu"),
        opt=convert.opt_state_from_numpy(st.opt, "cpu"),
        step=torch.tensor(int(st.step), dtype=torch.int32))


@pytest.mark.parametrize("backend", ("torch", "cuda"))
def test_detector_step_matches_reference(ref, backend):
    tc = dataclasses.replace(convert.train_config(ref["jtc"]),
                             backend=backend)
    cfg = resolve_snn_config(tc)
    assert cfg == dataclasses.replace(convert.snn_config(ref["jcfg"]),
                                      backend=backend)
    sched = warmup_cosine(tc.lr, warmup=tc.warmup, total=tc.steps,
                          min_ratio=tc.min_lr_ratio)
    step = make_detector_train_step(cfg, _opt(tc), sched)
    new, m = step(_port_state(ref["state"]),
                  convert.scene_from_numpy(ref["scene"], "cpu"))
    want = ref["metrics"]
    assert float(m["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)
    for k in ("xy", "wh", "obj", "cls", "sparsity", "grad_norm", "lr"):
        assert float(m[k]) == pytest.approx(float(want[k]), rel=1e-5,
                                            abs=1e-7), k
    jp = dict(tree_leaves(ref["new"].params))
    for path, p in tree_leaves(new.params):
        assert _maxrel(p.numpy(), jp[path]) <= 1e-4, path
    assert int(new.step) == int(ref["new"].step) == 1
    assert int(new.opt["count"]) == int(ref["new"].opt["count"])


@pytest.mark.parametrize("backend", ("torch", "cuda"))
def test_detector_step_is_the_snn_detect_step(backend):
    """``make_detector_train_step`` is ``make_snn_train_step(mode=
    "detect")`` under the same schedule: equal states and metrics."""
    tc = _smoke(batch=2, backend=backend)
    cfg = resolve_snn_config(tc)
    sched = warmup_cosine(tc.lr, warmup=tc.warmup, total=tc.steps,
                          min_ratio=tc.min_lr_ratio)
    state = init_detector_state(torch.Generator().manual_seed(3), cfg,
                                _opt(tc), device="cpu")
    data = make_data_fn(tc, cfg, device="cpu")
    det_step = make_detector_train_step(cfg, _opt(tc), sched)
    snn_step = make_snn_train_step(cfg, _opt(tc), "detect", sched)
    a, b = state, SNNTrainState(*state)
    for s in range(2):
        a, ma = det_step(a, data(s))
        b, mb = snn_step(b, data(s))
        assert isinstance(a, DetectorTrainState)
        assert list(ma) == list(mb)
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for (pa, x), (pb, y) in zip(tree_leaves(a), tree_leaves(b)):
        assert pa == pb and torch.equal(x, y), pa


def _eval_scenes(jcfg):
    """The reference's eval batches: ``fold_in(eval_seed, i)`` scenes
    (its generator jitted: the events are the eager run's)."""
    make = jax.jit(functools.partial(
        jax_make_scene_batch, batch=EVAL["batch"], height=jcfg.height,
        width=jcfg.width, time_steps=jcfg.time_steps,
        max_boxes=EVAL["max_boxes"], n_events=EVAL["n_events"]))
    root = jax.random.PRNGKey(EVAL["eval_seed"])
    return [_numpy(make(jax.random.fold_in(root, i)))
            for i in range(EVAL["batches"])]


def test_evaluate_detector_matches_reference(ref):
    """AP@0.5 and sparsity of the reference's parameters on the
    reference's eval scenes: the port's eval (voxels, decode, ground
    truth, AP) on the reference's forward outputs equals the
    reference's ``evaluate_detector`` within 1e-6; the port's own
    forward on those scenes agrees with the reference's layer by layer
    under the near-threshold rule, and where no spike flipped whole
    (raw_pred within 1e-4), with its own forward-plus-eval AP and
    sparsity within 1e-6 of the reference's there.  (A neuron of one
    eval batch sits exactly on threshold in the reference, so the port's
    forward there may flip it and carry the flip to the head.)"""
    jcfg = ref["jcfg"]
    cfg = convert.snn_config(jcfg)
    jparams = ref["state"].params
    params = convert.params_from_numpy(jparams, "cpu")
    fwd = jax.jit(lambda p, v: jax_npu_forward(p, v, jcfg))
    scenes, outs = [], []
    for sc in _eval_scenes(jcfg):
        vox = np.asarray(jax_voxel_batch(
            sc.events, time_steps=jcfg.time_steps, height=jcfg.height,
            width=jcfg.width))
        o = fwd(jparams, vox)
        scenes.append(convert.scene_from_numpy(sc, "cpu"))
        outs.append((vox, np.asarray(o.raw_pred), float(o.sparsity)))

    def reference_forward(outs):
        it = iter(outs)

        def forward(p, v):
            vox, raw, sp = next(it)
            np.testing.assert_array_equal(v.numpy(), vox)
            return NPUOutput(raw_pred=torch.tensor(raw), control=None,
                             sparsity=torch.tensor(sp), tile_skip=None)
        return forward
    ap, sp = det._evaluate_scenes(params, cfg, scenes,
                                  reference_forward(outs))
    assert ap == pytest.approx(ref["ap"], abs=1e-6)
    assert sp == pytest.approx(ref["sp"], abs=1e-6)
    assert ap > 0.0

    unflipped = []
    for i, (scene, (vox, raw, _)) in enumerate(zip(scenes, outs)):
        flipped = 0

        def conv(name, p, x, stride, depthwise):
            nonlocal flipped
            z = np.asarray(jax_layers.apply_spiking_conv(
                p, x, jcfg, fire=False, stride=stride, depthwise=depthwise))
            got = tlayers.apply_spiking_conv(
                params["backbone"][name], torch.tensor(x), cfg,
                stride=stride, depthwise=depthwise)
            res = spike_mismatch(z, got, tol=1e-5)
            assert res["far"] == 0, (name, res)
            flipped += res["flipped"]
            return np.asarray(jax_layers._fire(z, jcfg))
        chip_smoke.backbone_walk(cfg, jparams["backbone"], vox, conv,
                                 None, None)
        with torch.no_grad():
            got = npu_forward(params, torch.tensor(vox), cfg)
        if not flipped:
            unflipped.append(i)
            np.testing.assert_allclose(got.raw_pred.numpy(), raw,
                                       atol=1e-4, rtol=0)
    # the port's own forward and eval where no spike flipped
    assert unflipped
    sub = [scenes[i] for i in unflipped]
    ap_ref, sp_ref = det._evaluate_scenes(
        params, cfg, sub, reference_forward([outs[i] for i in unflipped]))
    ap_own, sp_own = det._evaluate_scenes(params, cfg, sub)
    assert ap_own == pytest.approx(ap_ref, abs=1e-6)
    assert sp_own == pytest.approx(sp_ref, abs=1e-6)
    # the port's own eval stream on the same parameters
    ap2, sp2 = det.evaluate_detector(params, cfg, **EVAL)
    assert 0.0 <= ap2 <= 1.0 and 0.0 < sp2 < 1.0


# ---------------------------------------------------------------------------
# configs and the launcher
# ---------------------------------------------------------------------------

def test_train_configs_match_reference():
    names = {n.replace("pallas", "cuda"): n for n in JAX_TRAIN_CONFIGS}
    assert sorted(names) == sorted(TRAIN_CONFIGS)
    for name, jname in names.items():
        mapped = convert.train_config(JAX_TRAIN_CONFIGS[jname])
        assert dataclasses.replace(mapped, name=name) == TRAIN_CONFIGS[name]
        assert get_train_config(name) is TRAIN_CONFIGS[name]
    assert TRAIN_CONFIGS["detector_smoke_cuda"].backend == "cuda"
    assert TRAIN_CONFIGS["detector"].backend == "torch"


def test_launch_train_snn_on_the_cpu(capsys, monkeypatch):
    """The launcher trains through ``train_detector`` on the kernel
    backend (its wrappers' plain versions on the CPU)."""
    runs = []

    def spy(tc, **kw):
        runs.append((tc, kw))
        return train_detector(tc, **kw)
    monkeypatch.setattr(launch_train, "train_detector", spy)
    state = launch_train.main(["--arch", "spiking_yolo", "--device", "cpu",
                               "--reduced", "--steps", "3", "--batch", "2"])
    assert int(state.step) == 3
    assert all(bool(torch.isfinite(p).all())
               for _, p in tree_leaves(state.params))
    out = capsys.readouterr().out
    assert "final: step=2 loss=" in out and "AP@0.5" in out
    (tc, kw), = runs
    assert (tc.arch, tc.backend, tc.reduced, tc.steps, tc.batch) == \
        ("spiking_yolo", "cuda", True, 3, 2)
    assert kw == {"ckpt_dir": None, "device": "cpu"}


def test_launch_train_runs_as_a_module(tmp_path):
    """``python -m repro_torch.launch.train`` trains, checkpoints, and a
    second run with more steps resumes from the first's checkpoint."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))

    def run(steps):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
             "--device", "cpu", "--batch", "2", "--steps", str(steps),
             "--ckpt-dir", str(tmp_path)],
            capture_output=True, text=True, timeout=300, env=env)
        assert out.returncode == 0, out.stderr
        return out.stdout
    first = run(2)
    assert "final: step=1 loss=" in first and "resumed" not in first
    second = run(4)
    assert "[trainer] resumed from step 2" in second
    assert "final: step=3 loss=" in second


def test_trainer_beats_its_heartbeat_monitor():
    """Each step beats the trainer's own monitor with its host seconds;
    metrics stay tensors until drained at log points and the end."""
    def step_fn(state, batch):
        return state + batch, {"loss": torch.tensor(float(batch))}
    tr = Trainer(step_fn, 0, lambda s: s, log_every=4, log_fn=_quiet)
    assert tr.run(20) == sum(range(20))
    beats = tr.monitor.workers["worker0"].step_times
    assert len(beats) == 16 and all(t >= 0.0 for t in beats)
    assert tr.monitor.dead_workers() == set()
    assert [h["step"] for h in tr.history] == list(range(20))
    assert [h["loss"] for h in tr.history] == [float(s) for s in range(20)]


def test_launch_train_lm_arch_raises():
    with pytest.raises(NotImplementedError, match="item 5.5"):
        launch_train.main(["--arch", "qwen2-7b", "--device", "cpu"])
