"""Port parity for the ``"cuda"`` ISP backend and the legacy shims:
the demosaic and NLM stage impls of the ``"cuda"`` backend (their
kernels' wrappers, which take the plain versions on the CPU), the
``"cuda"``, ``"hdr"`` and ``"fast_preview"`` pipelines, and the seed-API
shims (``ISPParams``, ``control_to_params``, ``isp_pipeline``) against
the JAX package's jnp path, with a different parameter setting per image
where the reference vmaps.  Plus the stage registry's backend API, the
case list of tests/test_isp_stages.py.

Tolerances: a single stage at atol=1e-6, the bar of
tests/test_torch_isp.py; a whole pipeline at 1e-5, the end-to-end ISP bar
of tests/test_torch_engine.py.  NLM turns a one-ulp difference in the
luminance (XLA and torch may sum or divide the channel mean differently)
into output differences of a few 1e-6 wherever two patches nearly match,
so the stage check feeds it an image whose luminance is exact in any
order, and whole pipelines, where NLM sees the AWB output, use the
end-to-end bar.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.isp import pipeline as jpipe
from repro.isp import stages as jstages
from repro.isp.demosaic import demosaic_mhc as jax_demosaic
from repro.isp.nlm import nlm_denoise as jax_nlm
from repro_torch import convert
from repro_torch.configs.registry import ISP_CONFIGS
from repro_torch.isp import pipeline, stages
from repro_torch.kernels.demosaic import demosaic
from repro_torch.kernels.nlm import nlm

ATOL = 1e-6
PIPE_ATOL = 1e-5
B, H, W = 3, 32, 24


def _bayer(seed):
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0.05, 0.9, (B, H, W)).astype(np.float32)
    hot = rng.random((B, H, W)) < 0.02
    raw[hot] = rng.choice([0.0, 1.0], hot.sum())
    return raw


def _exact_lum(rgb):
    """rgb rounded to multiples of 1/64 with each pixel's channel sum a
    multiple of 3/64: its luminance is exact however it is summed."""
    q = np.round(rgb * 64)
    r = q.sum(-1) % 3
    q[..., 2] = np.where(q[..., 2] >= r, q[..., 2] - r, q[..., 2] + 3 - r)
    return (q / 64).astype(np.float32)


def _stage_params(names, seed):
    rng = np.random.default_rng(seed)
    return {n: {s.name: rng.uniform(s.lo, s.hi, B).astype(np.float32)
                for s in jstages.get_stage(n).params} for n in names}


def _tt(tree):
    return {s: {k: torch.tensor(v) for k, v in ps.items()}
            for s, ps in tree.items()}


def test_cuda_stage_impls_match_jax():
    raw = _bayer(1)
    rgb = np.asarray(jax.jit(jax.vmap(jax_demosaic))(raw))
    got = stages.get_stage("demosaic").impl_for("cuda")(torch.tensor(raw), {})
    np.testing.assert_allclose(got.numpy(), rgb, atol=ATOL, rtol=0)
    assert torch.equal(demosaic(torch.tensor(raw)), got)

    rgb = _exact_lum(rgb)
    strength = np.random.default_rng(2).uniform(0, 1, B).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jax_nlm))(rgb, strength))
    got = stages.get_stage("nlm").impl_for("cuda")(
        torch.tensor(rgb), {"strength": torch.tensor(strength)})
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the single-channel form and a shared scalar strength
    want1 = np.asarray(jax.jit(jax.vmap(lambda x: jax_nlm(x, 0.4)))(raw))
    np.testing.assert_allclose(nlm(torch.tensor(raw), 0.4).numpy(), want1,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,jax_name", [("cuda", "default"),
                                           ("hdr", "hdr"),
                                           ("fast_preview", "fast_preview")])
def test_pipeline_configs_match_jax(name, jax_name):
    """The port's named pipelines against the JAX jnp path (the oracle
    of the JAX "pallas" config for the port's "cuda")."""
    cfg, jcfg = ISP_CONFIGS[name], jreg.ISP_CONFIGS[jax_name]
    assert cfg.stages == tuple(jcfg.stages)
    assert cfg.control_dim == jcfg.control_dim
    raw = _bayer(len(name))
    sp = _stage_params(cfg.stages, len(name) + 1)
    want = np.asarray(jax.jit(lambda r, p: jpipe.run_pipeline_batch(
        r, p, jcfg))(raw, sp))
    got = pipeline.run_pipeline_batch(torch.tensor(raw), _tt(sp), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=PIPE_ATOL, rtol=0)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


@pytest.mark.parametrize("name", ["default", "pallas", "hdr",
                                  "fast_preview"])
def test_isp_config_conversion(name):
    jcfg = jreg.ISP_CONFIGS[name]
    cfg = convert.isp_config(jcfg)
    port_name = {"pallas": "cuda"}.get(name, name)
    assert cfg == dataclasses.replace(ISP_CONFIGS[port_name], name=name)


def test_fused_isp_backend_not_ported():
    """The JAX "pallas_fused" backend exists for the ISP only: its ISP
    configs map onto "cuda_fused", and the SNN and encoding configs,
    which have no fused backend, stay unported."""
    cfg = convert.isp_config(jreg.ISP_CONFIGS["fused"])
    assert cfg == ISP_CONFIGS["fused"]
    snn = dataclasses.replace(jreg.SNN_ARCHS["spiking_yolo"],
                              backend="pallas_fused")
    with pytest.raises(ValueError, match="has no port"):
        convert.snn_config(snn)


def test_legacy_shims_match_jax():
    ctrl = np.random.default_rng(4).uniform(0, 1, (B, 8)).astype(np.float32)
    jp = jax.vmap(jpipe.control_to_params)(ctrl)
    p = pipeline.control_to_params(torch.tensor(ctrl))
    assert p._fields == jpipe.ISPParams._fields
    for got, want in zip(p, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0,
                                   rtol=0)
    for got, want in zip(pipeline.default_params(), jpipe.default_params()):
        assert float(got) == float(want)

    raw = _bayer(5)
    want = np.asarray(jax.jit(jax.vmap(jpipe.isp_pipeline))(raw, jp))
    for use_cuda in (False, True):
        got = pipeline.isp_pipeline_batch(torch.tensor(raw), p, use_cuda)
        np.testing.assert_allclose(got.numpy(), want, atol=PIPE_ATOL, rtol=0)
    one = pipeline.isp_pipeline(torch.tensor(raw[1]),
                                pipeline.ISPParams(*(v[1] for v in p)))
    np.testing.assert_allclose(one.numpy(), want[1], atol=PIPE_ATOL, rtol=0)
    dflt = pipeline.isp_pipeline(torch.tensor(raw[0]))
    np.testing.assert_allclose(
        dflt.numpy(), np.asarray(jax.jit(jpipe.isp_pipeline)(raw[0])),
        atol=PIPE_ATOL, rtol=0)


def test_legacy_batch_mixes_scalar_and_per_image_leaves():
    """A [B] leaf beside scalar leaves: the scalars broadcast across the
    batch, as the reference's all-leaf dispatch does."""
    raw = _bayer(6)
    gains = np.array([0.7, 1.0, 1.6], np.float32)
    jp = jpipe.default_params()._replace(exposure_gain=jnp.asarray(gains))
    want = np.asarray(jax.jit(jpipe.isp_pipeline_batch)(raw, jp))
    p = pipeline.default_params()._replace(exposure_gain=torch.tensor(gains))
    got = pipeline.isp_pipeline_batch(torch.tensor(raw), p)
    np.testing.assert_allclose(got.numpy(), want, atol=PIPE_ATOL, rtol=0)


def test_per_stage_backend_parity():
    """Each stage with a "cuda" impl matches its "torch" impl (on the
    CPU the kernels' wrappers take the plain versions: equal)."""
    raw = torch.tensor(_bayer(7))
    rgb = demosaic(raw)
    with_cuda = [n for n, s in stages.STAGES.items() if "cuda" in s.impls]
    assert sorted(with_cuda) == ["demosaic", "nlm"]
    for name in with_cuda:
        stage = stages.get_stage(name)
        x = raw if stage.domain == "bayer" else rgb
        p = {s.name: torch.tensor(s.default) for s in stage.params}
        assert torch.equal(stage.impl_for("cuda")(x, p),
                           stage.impl_for("torch")(x, p))
    assert stages.get_stage("gamma").impl_for("cuda") is \
        stages.get_stage("gamma").impls["torch"]


def test_unregistered_backend_rejected_registered_falls_back():
    raw = torch.tensor(_bayer(8))
    cfg = ISP_CONFIGS["default"]
    with pytest.raises(ValueError, match="unknown ISP backend"):
        pipeline.run_pipeline_batch(
            raw, None, dataclasses.replace(cfg, backend="no_such_backend"))
    stages.register_backend("test_empty")
    try:
        base = pipeline.run_pipeline_batch(raw, None, cfg)
        out = pipeline.run_pipeline_batch(
            raw, None, dataclasses.replace(cfg, backend="test_empty"))
        assert torch.equal(out, base)
    finally:
        stages.BACKENDS.remove("test_empty")


def test_replacing_stage_keeps_backend_impls():
    nlm_stage = stages.STAGES["nlm"]
    assert "cuda" in nlm_stage.impls
    stages.register_stage("nlm", nlm_stage.params, nlm_stage.impls["torch"],
                          doc=nlm_stage.doc)
    try:
        assert "cuda" in stages.STAGES["nlm"].impls
    finally:
        stages.STAGES["nlm"] = nlm_stage


def test_register_stage_impl_rebuilds_stage():
    """Attaching an impl leaves a Stage handed out before untouched."""
    before = stages.STAGES["gamma"]
    try:
        stages.register_stage_impl("gamma", "test_extra",
                                   before.impls["torch"])
        assert "test_extra" in stages.STAGES["gamma"].impls
        assert "test_extra" not in before.impls
        assert "test_extra" in stages.BACKENDS
    finally:
        stages.STAGES["gamma"] = before
        stages.BACKENDS.remove("test_extra")
    with pytest.raises(KeyError, match="unknown ISP stage"):
        stages.register_stage_impl("no_such_stage", "cuda", lambda x, p: x)
