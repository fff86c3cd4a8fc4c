"""Port parity: every stage of the default ISP ordering, the tone
stages and the whole control-vector pipeline against the JAX package's
jnp reference (repro.isp), on a batch of numpy frames with a different
parameter setting per image (the reference vmaps the per-image
pipeline).

Tolerance atol=1e-6, the bar the reference's own fused ISP is held to:
the arithmetic is the reference's op for op, but XLA and PyTorch differ
in the last bits of exp, pow, 3x3 matrix products and the order of a
few reductions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DEFAULT_ISP_STAGES
from repro.isp import demosaic as jax_demosaic
from repro.isp import gamma as jax_gamma
from repro.isp import stages as jax_stages
from repro.isp.pipeline import (control_vector_pipeline as jax_cvp,
                                legacy_control_permutation as jax_legacy_perm)
from repro_torch.isp import demosaic, gamma, stages
from repro_torch.isp.pipeline import (control_vector_pipeline,
                                      control_vector_pipeline_batch,
                                      legacy_control_permutation,
                                      run_pipeline)

ATOL = 1e-6
B, H, W = 3, 32, 24


def _bayer(seed):
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0.05, 0.9, (B, H, W)).astype(np.float32)
    hot = rng.random((B, H, W)) < 0.02
    raw[hot] = rng.choice([0.0, 1.0], hot.sum())       # defective pixels
    return raw


def _rgb(seed):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (B, H, W, 3)).astype(np.float32)


def _params(name, seed):
    """One value per image for each declared parameter of ``name``."""
    rng = np.random.default_rng(seed)
    return {s.name: rng.uniform(s.lo, s.hi, B).astype(np.float32)
            for s in jax_stages.get_stage(name).params}


def _jax_stage(name, x, p):
    fn = jax_stages.get_stage(name).impl_for("jnp")
    return np.asarray(jax.jit(jax.vmap(fn))(x, p))


@pytest.mark.parametrize("name", list(DEFAULT_ISP_STAGES)
                         + ["tonemap", "ccm"])
def test_stage_matches_jax(name):
    stage = jax_stages.get_stage(name)
    x = _bayer(1) if stage.domain in ("bayer", "any") else _rgb(1)
    p = _params(name, len(name))
    want = _jax_stage(name, x, p)
    got = stages.get_stage(name).impl_for("torch")(
        torch.tensor(x), {k: torch.tensor(v) for k, v in p.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_control_vector_pipeline_matches_jax():
    raw = _bayer(5)
    ctrl = np.random.default_rng(5).uniform(0, 1, (B, 8)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jax_cvp))(raw, ctrl))
    got = control_vector_pipeline_batch(torch.tensor(raw),
                                        torch.tensor(ctrl)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    one = control_vector_pipeline(torch.tensor(raw[1]), torch.tensor(ctrl[1]))
    np.testing.assert_allclose(one.numpy(), got[1], atol=0, rtol=0)
    assert 0.0 <= got.min() and got.max() <= 1.0


def test_default_params_pipeline_matches_jax():
    raw = _bayer(9)
    want = np.asarray(jax.jit(jax.vmap(
        lambda r: jax_stages.run_stages(r, None, DEFAULT_ISP_STAGES)))(raw))
    got = torch.stack([run_pipeline(torch.tensor(r)) for r in raw])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_control_mapping_matches_jax():
    ctrl = np.random.default_rng(2).uniform(0, 1, 8).astype(np.float32)
    want = jax_stages.control_to_stage_params(jnp.asarray(ctrl),
                                              DEFAULT_ISP_STAGES)
    got = stages.control_to_stage_params(torch.tensor(ctrl),
                                         DEFAULT_ISP_STAGES)
    assert list(got) == list(want)
    for s in want:
        assert list(got[s]) == list(want[s])
        for k in want[s]:
            assert float(got[s][k]) == float(want[s][k])
    assert stages.control_dim_for(DEFAULT_ISP_STAGES) == 8
    assert legacy_control_permutation() == jax_legacy_perm()


def test_demosaic_constants_pinned():
    for name in ("_F_G", "_F_RB_ROW", "_F_RB_COL", "_F_RB_DIAG"):
        np.testing.assert_array_equal(getattr(demosaic, name),
                                      getattr(jax_demosaic, name))
    np.testing.assert_array_equal(gamma._RGB2YCBCR.numpy(),
                                  np.asarray(jax_gamma._RGB2YCBCR))
    np.testing.assert_array_equal(gamma._lut_axis().numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, 256)))


def test_ycbcr_and_luma_constants_built_once_per_device(monkeypatch):
    """rgb_to_ycbcr, ycbcr_to_rgb and apply_saturation take their
    constants from a per-device cache: built once per device (no
    inverse and no host copy per call), with the bits of the per-call
    forms they replace."""
    from repro_torch.isp import tone
    rng = np.random.default_rng(9)
    rgb = torch.tensor(rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32))
    m, off = gamma._RGB2YCBCR, gamma._YCC_OFFSET
    inv = torch.linalg.inv(m)
    want_ycc = torch.einsum("...c,dc->...d", rgb, m) + off
    want_rgb = torch.clamp(torch.einsum("...c,dc->...d", want_ycc - off,
                                        inv), 0.0, 1.0)
    lum = (rgb[..., 0] * m[0, 0] + rgb[..., 1] * m[0, 1]
           + rgb[..., 2] * m[0, 2])[..., None]
    want_sat = torch.clamp(lum + 0.7 * (rgb - lum), 0.0, 1.0)

    gamma._ycc_consts.cache_clear()
    tone._luma_row.cache_clear()
    got = [gamma.rgb_to_ycbcr(rgb), gamma.ycbcr_to_rgb(want_ycc),
           tone.apply_saturation(rgb, 0.7)]
    assert gamma._ycc_consts.cache_info().misses == 1
    assert tone._luma_row.cache_info().misses == 1

    def no_inverse(*a, **k):
        raise AssertionError("inverse taken again")
    monkeypatch.setattr(torch.linalg, "inv", no_inverse)
    for _ in range(3):
        got = [gamma.rgb_to_ycbcr(rgb), gamma.ycbcr_to_rgb(want_ycc),
               tone.apply_saturation(rgb, 0.7)]
    assert gamma._ycc_consts.cache_info().misses == 1
    assert gamma._ycc_consts.cache_info().hits == 7
    assert tone._luma_row.cache_info().misses == 1
    for g, w in zip(got, (want_ycc, want_rgb, want_sat)):
        assert torch.equal(g, w)
    assert gamma._ycc_consts(rgb.device) is gamma._ycc_consts(rgb.device)
    np.testing.assert_array_equal(gamma._ycc_consts(rgb.device)[1].numpy(),
                                  gamma.SHARPEN_CONSTS[2].numpy())


def test_stage_order_and_params_are_checked():
    with pytest.raises(ValueError):
        stages.run_stages(torch.zeros(1, 8, 8), None, ("gamma", "demosaic"))
    with pytest.raises(ValueError):
        stages.run_stages(torch.zeros(1, 8, 8), {"gamma": {"gain": 1.0}},
                          DEFAULT_ISP_STAGES)
    with pytest.raises(ValueError):
        stages.control_dim_for(("exposure", "exposure"))
