"""Port parity for the fused ISP backend (``"cuda_fused"``): the planner,
the executor and the plain versions of the two segment kernels (which
the kernels' wrappers take on the CPU), case for case after
tests/test_isp_fused.py, against the JAX package's jnp path.  The oracle
is JAX ``run_stages(..., "jnp")``, jitted per image; no Pallas output is
ever an expected value.

Tolerances:
  * the fused backend against the port's per-stage ``"torch"`` path:
    equal, since on the CPU both run the same torch ops (the windowed
    forms replay the full-image forms' op order);
  * against JAX, the NLM- and gamma-free prefix of the default ordering
    at atol 1e-6, the bar the JAX package sets for its fused path
    (tests/test_isp_fused.py), and whole pipelines at 1e-5, the port's
    end-to-end ISP bar (tests/test_torch_isp_kernels.py).  Stage by stage
    the port and XLA differ in the last bits (XLA sums AWB's statistics
    and the dpc neighbours in another order and contracts demosaic's
    taps), and two stages magnify such a difference: the gamma LUT's
    first segment (slope 20 at gamma 2.2) in a dark pixel, and NLM at a
    low strength, whose weights exp(-d2 / h^2) with h near 1e-3 react to
    a one-ulp change of the luminance.  On the hdr defaults the per-stage
    port path and the fused one both sit 2.7e-6 from JAX; with random
    per-frame controls the [awb*+nlm] segment alone, fed JAX's own
    input, reaches 1.3e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.isp import fuse as jfuse
from repro.isp import pipeline as jpipe
from repro.isp import stages as jstages
from repro_torch.configs.base import DEFAULT_ISP_STAGES
from repro_torch.configs.registry import ISP_CONFIGS, reduced_snn
from repro_torch.core.npu import init_npu
from repro_torch.isp import pipeline, stages
from repro_torch.isp.fuse import (Segment, compile_plan, describe_plan,
                                  memory_passes, plan_stages,
                                  run_fused_stages)
from repro_torch.serve.cognitive_engine import (CognitiveEngine,
                                                PerceptionRequest)

PREFIX_ATOL = 1e-6
PIPE_ATOL = 1e-5
NAMED = ("default", "hdr", "fast_preview")
RNG = np.random.default_rng(7)


def _raw(h=64, w=64, b=None):
    shape = (h, w) if b is None else (b, h, w)
    return RNG.random(shape).astype(np.float32)


def _jax_params(stage_names, ctrl_val):
    if ctrl_val is None:
        return jstages.default_stage_params(stage_names)
    return jstages.control_to_stage_params(
        jnp.full((jstages.control_dim_for(stage_names),), ctrl_val),
        stage_names)


def _tt(tree):
    """JAX stage params -> torch ([B] leaves stay [B])."""
    return {s: {k: torch.tensor(np.asarray(v)) for k, v in ps.items()}
            for s, ps in tree.items()}


@functools.lru_cache(maxsize=None)
def _jax_stages(names, batched):
    """The named stages' jnp impls in order, jitted once per ordering,
    vmapped over frames and their params when ``batched``."""
    def run(x, sp):
        for n in names:
            x = jstages.get_stage(n).impls["jnp"](
                x, jstages.resolve_stage_params(n, sp))
        return x
    return jax.jit(jax.vmap(run) if batched else run)


def _check_fused(raw, sp, stage_names, block=None, atol=PIPE_ATOL):
    """The fused backend on ``raw`` (one [H, W] frame, or a [B, H, W]
    batch with per-frame params) against the port's per-stage path
    (equal) and the JAX jnp pipeline (``atol``)."""
    batched = raw.ndim == 3
    xb = torch.tensor(raw if batched else raw[None])
    tsp = _tt(sp)
    got = run_fused_stages(xb, tsp, stage_names, block=block)
    assert torch.equal(got, stages.run_stages(xb, tsp, stage_names,
                                              backend="torch"))
    want = np.asarray(_jax_stages(tuple(stage_names), batched)(raw, sp))
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                               atol=atol, rtol=0)
    return got


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

def test_default_plan_segments():
    plan = plan_stages(DEFAULT_ISP_STAGES)
    assert plan == (
        Segment(pointwise=("exposure",), stencil="dpc"),
        Segment(stencil="demosaic"),
        Segment(reduce="awb", stencil="nlm"),
        Segment(pointwise=("gamma",), stencil="sharpen"))
    assert memory_passes(DEFAULT_ISP_STAGES) == 5 < len(DEFAULT_ISP_STAGES)
    assert describe_plan(DEFAULT_ISP_STAGES) == \
        "[exposure+dpc] [demosaic] [awb*+nlm] [gamma+sharpen]"
    assert pipeline.plan_summary(ISP_CONFIGS["default"]) == \
        describe_plan(DEFAULT_ISP_STAGES)


def test_hdr_plan_collapses_pointwise_tail():
    plan = plan_stages(ISP_CONFIGS["hdr"].stages)
    assert len(plan) == 4
    assert plan[-1] == Segment(pointwise=("tonemap", "ccm", "gamma"),
                               stencil="sharpen")


def test_fast_preview_plan_reduce_leads_trailing_segment():
    assert plan_stages(ISP_CONFIGS["fast_preview"].stages) == (
        Segment(pointwise=("exposure",), stencil="dpc"),
        Segment(stencil="demosaic"),
        Segment(reduce="awb", pointwise=("gamma",)))


def test_reduce_stage_always_starts_its_segment():
    assert plan_stages(("demosaic", "tonemap", "awb", "ccm")) == (
        Segment(stencil="demosaic"), Segment(pointwise=("tonemap",)),
        Segment(reduce="awb", pointwise=("ccm",)))


def test_plan_cache_reuses_segments():
    assert plan_stages(DEFAULT_ISP_STAGES) is plan_stages(
        list(DEFAULT_ISP_STAGES))
    assert compile_plan(DEFAULT_ISP_STAGES) is compile_plan(
        list(DEFAULT_ISP_STAGES))


@pytest.mark.parametrize("name", NAMED + ("fused", "hdr_fused"))
def test_plans_equal_jax(name):
    """Segment for segment and string for string, and every segment of
    the named orderings launches a kernel on the card."""
    jcfg = jreg.ISP_CONFIGS[name]
    port = ISP_CONFIGS[name]
    assert port.stages == tuple(jcfg.stages)
    plan, jplan = plan_stages(port.stages), jfuse.plan_stages(jcfg.stages)
    assert [dataclasses.astuple(s) for s in plan] == \
        [dataclasses.astuple(s) for s in jplan]
    assert describe_plan(port.stages) == jfuse.describe_plan(jcfg.stages)
    assert memory_passes(port.stages) == jfuse.memory_passes(jcfg.stages)
    assert pipeline.plan_summary(port) == jpipe.plan_summary(jcfg)
    assert all(ex.launches_kernel for ex in compile_plan(port.stages))


def test_packed_parameter_layout_matches_jax():
    for name in NAMED:
        names = ISP_CONFIGS[name].stages
        for ex, jex in zip(compile_plan(names),
                           jfuse._compiled_plan(names,
                                                jstages.REGISTRY_VERSION)):
            assert [(s, spec.name) for s, spec in ex.param_order] == \
                [(s, spec.name) for s, spec in jex.param_order]
            assert [(c.offset, c.names, c.c_offset, c.n_consts)
                    for c in ex.chain] == \
                [(c.offset, c.names, c.c_offset, c.n_consts)
                 for c in jex.chain]


# ---------------------------------------------------------------------------
# fused vs the JAX jnp path and the port's per-stage path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMED)
def test_fused_matches_jax_named_pipelines(name):
    names = ISP_CONFIGS[name].stages
    raw = _raw()
    for ctrl_val in (None, 0.2, 0.85):
        _check_fused(raw, _jax_params(names, ctrl_val), names)


def test_fused_bitwise_outside_nlm():
    """The NLM- and gamma-free prefix of the default ordering: the fused
    backend gives the per-stage path's bits, within 1e-6 of JAX."""
    names = ("exposure", "dpc", "demosaic", "awb")
    for ctrl_val in (None, 0.2, 0.85):
        _check_fused(_raw(), _jax_params(names, ctrl_val), names,
                     atol=PREFIX_ATOL)


@pytest.mark.parametrize("hw", [(48, 40), (50, 66)])
def test_fused_non_tile_multiple_frames(hw):
    """16x16 tiles over frames that are not tile multiples: the zero
    fringe never leaks into valid pixels."""
    raw = _raw(*hw)
    for name in NAMED:
        names = ISP_CONFIGS[name].stages
        _check_fused(raw, _jax_params(names, None), names, block=(16, 16))


def test_fused_batch_per_frame_controls():
    """The engine's tick shape: a batch of frames, each with its own
    control vector (the reference vmaps)."""
    names = ISP_CONFIGS["hdr"].stages
    ctrls = RNG.random((3, jstages.control_dim_for(names))).astype(
        np.float32)
    sp = jstages.control_to_stage_params(jnp.asarray(ctrls).T, names)
    sp = {s: {k: jnp.asarray(v) for k, v in ps.items()}
          for s, ps in sp.items()}
    _check_fused(_raw(32, 32, b=3), sp, names)


def test_cuda_fused_backend_through_run_stages():
    """run_stages / run_pipeline_batch route "cuda_fused" to the
    executor; scalar params broadcast over the batch."""
    raw = torch.tensor(_raw(32, 32, b=2))
    cfg = ISP_CONFIGS["fused"]
    sp = {"gamma": {"gamma": torch.tensor(1.7)}}
    got = pipeline.run_pipeline_batch(raw, sp, cfg)
    assert torch.equal(got, run_fused_stages(raw, sp, cfg.stages))
    assert torch.equal(got, pipeline.run_pipeline_batch(
        raw, sp, ISP_CONFIGS["default"]))
    with pytest.raises(ValueError, match="expects 'rgb' input"):
        stages.run_stages(raw, None, ("awb",), backend="cuda_fused")


# ---------------------------------------------------------------------------
# custom stages: fused when annotated, opaque fallback otherwise
# ---------------------------------------------------------------------------

def _jax_invert(x, p):
    return p["amount"] * (1.0 - x) + (1.0 - p["amount"]) * x


def _invert(x, p):
    a = p["amount"]
    if torch.is_tensor(a) and a.dim() == 1:
        a = a.reshape(a.shape + (1,) * (x.dim() - 1))
    return a * (1.0 - x) + (1.0 - a) * x


@pytest.fixture
def custom_stage():
    """Registers a stage under one name in both registries; removes it
    after the test."""
    added = []

    def register(name, jax_impl, impl, **kw):
        spec = kw.pop("params", ())
        jstages.register_stage(name, tuple(jstages.ParamSpec(*s)
                                           for s in spec), jax_impl, **kw)
        stages.register_stage(name, tuple(stages.ParamSpec(*s)
                                          for s in spec), impl, **kw)
        added.append(name)
    yield register
    for name in added:
        del jstages.STAGES[name]
        del stages.STAGES[name]


def test_custom_pointwise_stage_fuses(custom_stage):
    custom_stage("test_fused_invert", _jax_invert, _invert,
                 params=(("amount", 0.0, 1.0, 1.0),), kind="pointwise")
    names = ISP_CONFIGS["fast_preview"].stages + ("test_fused_invert",)
    # joins the trailing [awb*+gamma] run instead of a new segment
    assert plan_stages(names)[-1].pointwise == ("gamma",
                                                "test_fused_invert")
    # no device form: that segment runs the plain version on the card
    assert [ex.launches_kernel for ex in compile_plan(names)] == \
        [True, True, False]
    _check_fused(_raw(32, 32), jstages.default_stage_params(names), names)


def test_unannotated_custom_stage_runs_opaque(custom_stage):
    custom_stage("test_opaque_posterize",
                 lambda x, p: jnp.round(x * 4.0) / 4.0,
                 lambda x, p: torch.round(x * 4.0) / 4.0)
    names = ISP_CONFIGS["fast_preview"].stages + ("test_opaque_posterize",)
    assert plan_stages(names)[-1] == Segment(opaque="test_opaque_posterize")
    assert "[test_opaque_posterize?]" in describe_plan(names)
    assert not compile_plan(names)[-1].launches_kernel
    raw = _raw(32, 32)
    sp = jstages.default_stage_params(names)
    got = run_fused_stages(torch.tensor(raw)[None], _tt(sp), names)
    want = np.asarray(_jax_stages(names, False)(raw, sp))
    # rounding to quarters turns a 1e-7 difference at a .125 boundary
    # into 0.25; hold the pixels away from the boundaries
    pre = np.asarray(_jax_stages(names[:-1], False)(raw, sp))
    away = np.abs(pre * 4.0 - np.floor(pre * 4.0) - 0.5) > 1e-4
    np.testing.assert_allclose(got[0].numpy()[away], want[away],
                               atol=PIPE_ATOL, rtol=0)
    assert torch.equal(got, stages.run_stages(
        torch.tensor(raw)[None], _tt(sp), names, backend="torch"))


def test_bad_fusion_metadata_rejected():
    with pytest.raises(ValueError, match="unknown fusion kind"):
        stages.register_stage("test_bad_kind", (), lambda x, p: x,
                              kind="magic")
    with pytest.raises(ValueError, match="needs window_fn"):
        stages.register_stage("test_bad_stencil", (), lambda x, p: x,
                              kind="stencil")
    with pytest.raises(ValueError, match="needs stats_fn"):
        stages.register_stage("test_bad_reduce", (), lambda x, p: x,
                              kind="reduce")
    with pytest.raises(ValueError, match="no\\s+tile_fn"):
        stages.register_stage("test_bad_consts", (), lambda x, p: x,
                              kind="pointwise",
                              fuse_consts=(torch.ones(3),))
    with pytest.raises(ValueError, match="unknown device op"):
        stages.register_stage("test_bad_op", (), lambda x, p: x,
                              kind="pointwise", device_op="vignette")
    assert not any(n.startswith("test_bad_") for n in stages.STAGES)


def test_reregistering_invalidates_cached_plans():
    gamma = stages.STAGES["gamma"]
    before = plan_stages(DEFAULT_ISP_STAGES)
    stages.register_stage("gamma", gamma.params, gamma.impls["torch"],
                          doc=gamma.doc)            # no fusion metadata
    try:
        assert plan_stages(DEFAULT_ISP_STAGES) is not before
        assert "[gamma?]" in describe_plan(DEFAULT_ISP_STAGES)
    finally:
        stages.STAGES["gamma"] = gamma
        stages._bump_registry_version()
    assert plan_stages(DEFAULT_ISP_STAGES) == before


# ---------------------------------------------------------------------------
# hypothesis fuzz over control vectors
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:                                  # pragma: no cover
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:
    _FUZZ_STAGES = ISP_CONFIGS["hdr"].stages
    _FUZZ_DIM = jstages.control_dim_for(_FUZZ_STAGES)
    _FUZZ_RAW = np.random.default_rng(3).random((32, 32)).astype(np.float32)

    @settings(max_examples=20, deadline=None)
    @given(ctrl=st.lists(st.floats(0.0, 1.0, width=32), min_size=_FUZZ_DIM,
                         max_size=_FUZZ_DIM))
    def test_fuzz_control_vectors_fused_parity(ctrl):
        sp = jstages.control_to_stage_params(
            jnp.asarray(ctrl, jnp.float32), _FUZZ_STAGES)
        _check_fused(_FUZZ_RAW, sp, _FUZZ_STAGES)


# ---------------------------------------------------------------------------
# the slice whole: the engine's tick on the fused backend
# ---------------------------------------------------------------------------

def test_engine_on_fused_config_matches_default():
    """A reduced CognitiveEngine serving through ISP_CONFIGS["fused"]
    answers exactly as the same engine on the per-stage default."""
    cfg = reduced_snn("spiking_yolo")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(1)
    reqs = [dict(rid=i, voxels=(rng.random((cfg.time_steps, cfg.height,
                                            cfg.width, 2)) < 0.15
                                ).astype(np.float32),
                 bayer=rng.uniform(0.05, 0.95, (cfg.height, cfg.width))
                 .astype(np.float32)) for i in range(3)]
    out = {}
    for name in ("fused", "default"):
        eng = CognitiveEngine(params, cfg, isp_cfg=ISP_CONFIGS[name],
                              batch=2, device="cpu")
        done = eng.run_to_completion([PerceptionRequest(**r) for r in reqs])
        out[name] = {r.rid: r.result for r in done}
    assert sorted(out["fused"]) == [0, 1, 2]
    for rid, got in out["fused"].items():
        want = out["default"][rid]
        for field in ("rgb", "control", "raw_pred"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        assert 0.0 <= got.rgb.min() and got.rgb.max() <= 1.0
