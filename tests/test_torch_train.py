"""Port parity: SNN training (surrogate-gradient BPTT + AdamW) against the
JAX package's ``repro.core.train`` on the jnp path, on the CPU.

The LIF and AP cases mirror ``tests/test_snn.py``; the losses, their
gradients and the train step mirror ``tests/test_lif_backend.py:208``.
Weights come from the port's init carried to JAX as numpy, scenes from
the reference's ``make_scene_batch`` carried to the port as numpy
(``convert.scene_from_numpy``).  Bars: a loss within 1e-5 relative,
every gradient leaf within 1e-5 relative (max |diff| over max |want|),
the parameters after a step within 1e-4 relative, the losses of three
steps in a row within 1e-4 relative.  Both port backends run ("torch":
autograd through the surrogate spike; "cuda": the kernel ops' own
backwards, on CPU tensors their kernels' plain versions forward).

The reference's cognitive step compiles its whole ISP's backward (~45 s
on this CPU), so one jitted ``value_and_grad`` of ``cognitive_loss``
serves every cognitive case, and its step is that gradient and the
reference's ``adamw_update``: the body of ``make_snn_train_step``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_snn as jax_reduced_snn
from repro.core import train as jtrain
from repro.core.yolo import _assign_targets as jax_assign_targets
from repro.core.yolo import average_precision as jax_average_precision
from repro.core.yolo import nms_greedy as jax_nms_greedy
from repro.core.yolo import yolo_loss as jax_yolo_loss
from repro.data.synthetic import make_scene_batch
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro_torch import convert
from repro_torch.core import train as ttrain
from repro_torch.core.encoding import EventStream
from repro_torch.core.lif import lif_scan, lif_step, spike
from repro_torch.core.npu import init_npu, npu_forward
from repro_torch.core.yolo import (_assign_targets, average_precision,
                                   nms_greedy, yolo_loss)
from repro_torch.isp.pipeline import control_vector_pipeline_batch
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.serve.engine_core import EngineCore

B = 2
MODES = ("detect", "cognitive")
BACKENDS = ("torch", "cuda")
# the reference's "detector" recipe (configs/base.py:355-391,
# configs/registry.py:277-278)
RECIPE = dict(lr=4e-3, weight_decay=1e-4, grad_clip=1.0)
SCHEDULE = dict(warmup=100, total=2000, min_ratio=0.3)


def _maxrel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _leaves(jtree):
    return dict(tree_leaves(jax.tree_util.tree_map(np.asarray, jtree)))


# ---------------------------------------------------------------------------
# the LIF and the surrogate (test_snn.py:18-50)
# ---------------------------------------------------------------------------

def test_lif_integrates_and_fires():
    T = 20
    s = lif_scan(torch.full((T, 1), 0.5), tau=2.0, v_th=1.0)
    assert 1 <= float(s.sum()) < T


def test_lif_silent_below_leak_equilibrium():
    assert float(lif_scan(torch.full((50, 4), 0.05)).sum()) == 0.0


def test_lif_reset_after_spike():
    u, s = lif_step(torch.tensor(2.0), torch.tensor(0.0), decay=0.5,
                    v_th=1.0, v_reset=0.0, beta=4.0)
    assert float(s) == 1.0 and float(u) == 0.0


def test_surrogate_gradient_nonzero_near_threshold():
    x = torch.tensor(0.0, requires_grad=True)
    spike(x, 4.0).backward()
    assert float(x.grad) == pytest.approx(1.0)    # beta * sigma'(0)
    x = torch.tensor(10.0, requires_grad=True)
    spike(x, 4.0).backward()
    assert float(x.grad) < 1e-3
    c = torch.full((5, 8), 0.8, requires_grad=True)
    lif_scan(c).sum().backward()
    assert torch.isfinite(c.grad).all() and float(c.grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# AP@0.5 and NMS (test_snn.py:97), against the reference's numpy
# ---------------------------------------------------------------------------

def test_average_precision_perfect_and_chance():
    gt = [np.array([[0.1, 0.1, 0.4, 0.4]])]
    assert average_precision([gt[0]], [np.array([0.9])], gt) == \
        pytest.approx(1.0)
    assert average_precision([np.array([[0.6, 0.6, 0.9, 0.9]])],
                             [np.array([0.9])], gt) == 0.0


def _random_boxes(rng, n):
    xy = rng.uniform(0, 0.8, (n, 2))
    wh = rng.uniform(0.05, 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_nms_and_average_precision_match_reference(seed):
    rng = np.random.default_rng(seed)
    boxes = _random_boxes(rng, 40)
    np.testing.assert_array_equal(nms_greedy(boxes, 0.3),
                                  jax_nms_greedy(boxes, 0.3))
    preds = [_random_boxes(rng, int(rng.integers(0, 30))) for _ in range(5)]
    scores = [rng.random(len(p)).astype(np.float32) for p in preds]
    gts = [_random_boxes(rng, int(rng.integers(0, 4))) for _ in range(5)]
    gts = [np.concatenate([g, p[:2] + 0.01]) for g, p in zip(gts, preds)]
    assert average_precision(preds, scores, gts) == \
        jax_average_precision(preds, scores, gts)


# ---------------------------------------------------------------------------
# targets and the YOLO loss
# ---------------------------------------------------------------------------

def _gt(rng, Bn=3, M=6):
    boxes = np.stack([rng.integers(0, 2, (Bn, M)).astype(np.float32),
                      rng.uniform(0, 1, (Bn, M)), rng.uniform(0, 1, (Bn, M)),
                      rng.uniform(0.05, 0.6, (Bn, M)),
                      rng.uniform(0.05, 0.6, (Bn, M))],
                     axis=-1).astype(np.float32)
    # two valid boxes in one cell and anchor (the later one wins), one
    # invalid box on top of a valid one (it writes nothing), a box on the
    # frame's far edge (cx = cy = 1: the clipped cell), an unknown class
    boxes[0, 1] = boxes[0, 0] * np.array([1, 1, 1, 1.01, 0.99], np.float32)
    boxes[1, 3] = boxes[1, 2]
    boxes[2, 4, 1:3] = 1.0
    boxes[2, 5, 0] = 7.0
    valid = rng.random((Bn, M)) < 0.8
    valid[0, :2] = True
    valid[1, 2], valid[1, 3] = True, False
    return boxes, valid


@pytest.mark.parametrize("hw", [(4, 4), (8, 6)])
def test_assign_targets_match_reference(hw):
    h, w = hw
    boxes, valid = _gt(np.random.default_rng(h * w))
    jcfg = jax_reduced_snn("spiking_yolo")
    cfg = convert.snn_config(jcfg)
    tgt, msk = _assign_targets(torch.tensor(boxes), torch.tensor(valid), h,
                               w, cfg)
    jt, jm = jax.vmap(lambda b, v: jax_assign_targets(b, v, h, w, jcfg))(
        boxes, valid)
    np.testing.assert_array_equal(msk.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jt), rtol=1e-6,
                               atol=1e-7)
    assert msk.any()


@pytest.mark.parametrize("seed", range(3))
def test_yolo_loss_and_grads_match_reference(seed):
    rng = np.random.default_rng(seed)
    jcfg = jax_reduced_snn("spiking_yolo")
    cfg = convert.snn_config(jcfg)
    boxes, valid = _gt(rng)
    raw = rng.normal(0, 2, (3, 4, 4, cfg.num_anchors,
                            5 + cfg.num_classes)).astype(np.float32)
    t = torch.tensor(raw, requires_grad=True)
    loss, parts = yolo_loss(t, torch.tensor(boxes), torch.tensor(valid), cfg)
    (g,) = torch.autograd.grad(loss, [t])
    (jl, jp), jg = jax.value_and_grad(
        lambda r: jax_yolo_loss(r, boxes, valid, jcfg), has_aux=True)(raw)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-6)
    for k, v in parts.items():
        assert float(v.detach()) == pytest.approx(float(jp[k]), rel=1e-5,
                                                  abs=1e-7)
    assert _maxrel(g.numpy(), jg) <= 1e-5


# ---------------------------------------------------------------------------
# the losses and the train step on reduced spiking-YOLO
# ---------------------------------------------------------------------------

def _saturated(scene):
    """The scene with saturated and black Bayer pixels: a bright band, a
    black block and scattered hot/dead pixels."""
    bayer = np.array(scene.bayer)
    bayer[:, :3] = 1.0
    bayer[:, -6:, :5] = 0.0
    hot = np.random.default_rng(0).random(bayer.shape) < 0.05
    bayer[hot] = np.where(np.random.default_rng(1).random(int(hot.sum()))
                          < 0.5, 0.0, 1.0)
    return scene._replace(bayer=bayer)


@pytest.fixture(scope="module")
def ref():
    jcfg = jax_reduced_snn("spiking_yolo")
    params = _numpy_tree(init_npu(torch.Generator().manual_seed(1),
                                  convert.snn_config(jcfg), device="cpu"))
    scene = jax.tree_util.tree_map(np.asarray, make_scene_batch(
        jax.random.PRNGKey(5), batch=B, height=jcfg.height,
        width=jcfg.width, time_steps=jcfg.time_steps))
    jopt = JaxAdamWConfig(**RECIPE)
    jsched = jax_warmup_cosine(RECIPE["lr"], **SCHEDULE)
    vg = {m: jax.jit(jax.value_and_grad(
        lambda p, s, f=f: f(p, s, jcfg), has_aux=True))
        for m, f in (("detect", jtrain.detection_loss),
                     ("cognitive", jtrain.cognitive_loss))}
    update = jax.jit(lambda p, g, o: jax_adamw_update(p, g, o, jopt, jsched))
    return dict(jcfg=jcfg, params=params, scene=scene, vg=vg, update=update,
                jopt=jopt, jsched=jsched, memo={})


def _jax_vg(ref, mode, params, scene, tag):
    """The reference's (loss, parts, grads) at ``params``, memoised by
    ``tag`` (the cases of both backends share it)."""
    key = (mode, tag)
    if key not in ref["memo"]:
        (loss, parts), grads = ref["vg"][mode](params, scene)
        ref["memo"][key] = (float(loss), {k: float(v)
                                          for k, v in parts.items()}, grads)
    return ref["memo"][key]


def _cfg(ref, backend):
    return dataclasses.replace(convert.snn_config(ref["jcfg"]),
                               backend=backend)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode,saturated", [("detect", False),
                                            ("cognitive", False),
                                            ("cognitive", True)])
def test_loss_and_grads_match_reference(ref, backend, mode, saturated):
    """detection_loss / cognitive_loss: the value, every part and every
    parameter leaf's gradient; the cognitive case also on a batch with
    saturated and zero Bayer pixels (the ISP's clips at their bounds)."""
    scene = _saturated(ref["scene"]) if saturated else ref["scene"]
    jl, jp, jg = _jax_vg(ref, mode, ref["params"], scene, saturated)
    loss, parts, grads = ttrain.value_and_grad(
        ttrain.LOSSES[mode], convert.params_from_numpy(ref["params"], "cpu"),
        convert.scene_from_numpy(scene, "cpu"), _cfg(ref, backend))
    assert float(loss) == pytest.approx(jl, rel=1e-5)
    assert set(parts) == set(jp)
    for k, v in parts.items():
        assert float(v) == pytest.approx(jp[k], rel=1e-5, abs=1e-7), k
    want = _leaves(jg)
    worst = {k: _maxrel(g.numpy(), want[k]) for k, g in tree_leaves(grads)}
    assert set(worst) == set(want)
    assert max(worst.values()) <= 1e-5, sorted(worst.items(),
                                               key=lambda kv: -kv[1])[:3]
    assert all(bool(torch.isfinite(g).all()) for _, g in tree_leaves(grads))
    assert sum(float(g.abs().sum()) for _, g in tree_leaves(grads)) > 0


def test_reference_step_is_value_and_grad_then_adamw(ref):
    """The reference's own make_snn_train_step (detect mode) equals its
    value_and_grad + adamw_update, the composition the cognitive cases
    hold the port to."""
    jcfg = ref["jcfg"]
    state = jtrain.init_snn_state(
        jax.tree_util.tree_map(jnp.asarray, ref["params"]), ref["jopt"])
    step = jax.jit(jtrain.make_snn_train_step(jcfg, ref["jopt"], "detect",
                                              ref["jsched"]))
    new, m = step(state, ref["scene"])
    loss, _, grads = _jax_vg(ref, "detect", ref["params"], ref["scene"],
                             False)
    params, _, _ = ref["update"](state.params, grads, state.opt)
    assert float(m["loss"]) == loss
    for k, v in _leaves(new.params).items():
        np.testing.assert_allclose(v, _leaves(params)[k], rtol=1e-6,
                                   atol=1e-9)


def _jax_steps(ref, mode, n):
    """n reference steps from the shared params: [(loss, params)]."""
    key = (mode, "steps", n)
    if key in ref["memo"]:
        return ref["memo"][key]
    params = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    state = jtrain.init_snn_state(params, ref["jopt"])
    params, opt = state.params, state.opt
    out = []
    for _ in range(n):
        (loss, _), grads = ref["vg"][mode](params, ref["scene"])
        params, opt, om = ref["update"](params, grads, opt)
        out.append((float(loss), params, float(om["grad_norm"]),
                    float(om["lr"])))
    ref["memo"][key] = out
    return out


def _port_steps(ref, mode, backend, n):
    opt = AdamWConfig(**RECIPE)
    state = ttrain.init_snn_state(
        convert.params_from_numpy(ref["params"], "cpu"), opt)
    step = ttrain.make_snn_train_step(
        _cfg(ref, backend), opt, mode,
        warmup_cosine(RECIPE["lr"], **SCHEDULE))
    scene = convert.scene_from_numpy(ref["scene"], "cpu")
    out = []
    for _ in range(n):
        state, parts = step(state, scene)
        out.append((state, parts))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_reference(ref, mode, backend):
    """One step from the same params, scene and optimizer state: the
    loss within 1e-5, grad_norm and lr within 1e-5, every parameter
    within 1e-4, the step counters advanced."""
    (state, parts), = _port_steps(ref, mode, backend, 1)
    jloss, jparams, jgn, jlr = _jax_steps(ref, mode, 3)[0]
    assert float(parts["loss"]) == pytest.approx(jloss, rel=1e-5)
    assert float(parts["grad_norm"]) == pytest.approx(jgn, rel=1e-5)
    assert float(parts["lr"]) == pytest.approx(jlr, rel=1e-5)
    assert {"loss", "grad_norm", "lr", "xy", "wh", "obj", "cls"} <= set(parts)
    want = _leaves(jparams)
    for k, v in tree_leaves(state.params):
        assert _maxrel(v.numpy(), want[k]) <= 1e-4, k
    assert int(state.step) == 1 and int(state.opt["count"]) == 1


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_three_steps_track_reference(ref, mode, backend):
    got = [float(p["loss"]) for _, p in _port_steps(ref, mode, backend, 3)]
    want = [loss for loss, *_ in _jax_steps(ref, mode, 3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] != got[1]                       # the params moved


def test_step_leaves_its_input_state_alone(ref):
    opt = AdamWConfig(**RECIPE)
    params = convert.params_from_numpy(ref["params"], "cpu")
    state = ttrain.init_snn_state(params, opt)
    before = {k: v.clone() for k, v in tree_leaves(params)}
    step = ttrain.make_snn_train_step(_cfg(ref, "cuda"), opt)
    new, _ = step(state, convert.scene_from_numpy(ref["scene"], "cpu"))
    for k, v in tree_leaves(state.params):
        assert torch.equal(v, before[k]) and not v.requires_grad
    assert not any(v.requires_grad for _, v in tree_leaves(new.params))
    with pytest.raises(ValueError, match="mode"):
        ttrain.make_snn_train_step(_cfg(ref, "cuda"), opt, mode="classify")


# ---------------------------------------------------------------------------
# serving stays grad-free and bit-identical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_serving_outputs_equal_the_grad_path(ref, backend):
    """EngineCore.step (under no_grad) gives the bits of the same forward
    run with grad-requiring parameter leaves, the one training runs."""
    cfg = _cfg(ref, backend)
    params = convert.params_from_numpy(ref["params"], "cpu")
    rng = np.random.default_rng(3)
    vox = torch.tensor((rng.random((cfg.time_steps, B, cfg.height,
                                    cfg.width, 2)) < 0.15).astype(np.float32))
    bayer = torch.tensor(rng.uniform(0.05, 0.95, (B, cfg.height,
                                                  cfg.width)).astype(
        np.float32))
    n = 64
    events = EventStream(
        t=torch.tensor(rng.random((B, n)).astype(np.float32)),
        x=torch.tensor(rng.integers(0, cfg.width, (B, n)).astype(np.int32)),
        y=torch.tensor(rng.integers(0, cfg.height, (B, n)).astype(np.int32)),
        p=torch.tensor(rng.integers(0, 2, (B, n)).astype(np.int32)),
        valid=torch.ones((B, n), dtype=torch.bool))
    core = EngineCore(params, cfg, device="cpu")
    out, rgb, _ = core.step(vox, bayer, events,
                            torch.zeros(B, dtype=torch.bool))
    assert not out.raw_pred.requires_grad and not rgb.requires_grad
    p, _ = ttrain.with_leaves(params)
    with torch.enable_grad():
        got = npu_forward(p, vox, cfg)
        got_rgb = control_vector_pipeline_batch(
            bayer, got.control[:, :core.isp_cfg.control_dim], core.isp_cfg)
    assert got.raw_pred.requires_grad
    assert torch.equal(got.raw_pred.detach(), out.raw_pred)
    assert torch.equal(got.control.detach(), out.control)
    assert torch.equal(got_rgb.detach(), rgb)
