"""Port parity for the cognitive loop (``repro_torch.core.cognitive``)
and for the all-kernel serving configuration: ``cognitive_forward``,
``cognitive_step`` and ``exposure_reward`` against the JAX package's jnp
path on the same weights and scenes, and the port's ``CognitiveEngine``
on the CPU with the ``"cuda"`` encoding and ISP configs (their kernels'
wrappers take the plain versions there) and the ``"cuda"`` SNN backend
against the JAX engine on its jnp configs, the oracle of the JAX
``"pallas"`` ones.

Weights come from the JAX ``init_npu``, carried across as numpy; the
DVS windows, event buffers and Bayer frames are made with numpy.
Tolerances are those of tests/test_torch_engine.py: the NPU outputs at
1e-4, the ISP output and the stage params at 1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import cognitive as jcog
from repro.core.encoding import EventStream as JaxEventStream
from repro.core.npu import init_npu as jax_init_npu
from repro.serve.cognitive_engine import CognitiveEngine as JaxEngine
from repro.serve.cognitive_engine import PerceptionRequest as JaxRequest
from repro_torch import convert
from repro_torch.configs.registry import ENCODING_CONFIGS, ISP_CONFIGS
from repro_torch.core import cognitive
from repro_torch.core.encoding import EventStream
from repro_torch.serve.cognitive_engine import (CognitiveEngine,
                                                PerceptionRequest)

NPU_ATOL = 1e-4
ISP_ATOL = 1e-5
BATCH = 2
EVENT_CAPACITY = 256


@pytest.fixture(scope="module")
def ref():
    jcfg = jreg.reduced_snn("spiking_yolo")
    jparams = jax.jit(lambda k: jax_init_npu(k, jcfg))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    vox = (rng.random((jcfg.time_steps, BATCH, jcfg.height, jcfg.width, 2))
           < 0.15).astype(np.float32)
    bayer = rng.uniform(0.05, 0.95, (BATCH, jcfg.height, jcfg.width)).astype(
        np.float32)
    run = jax.jit(lambda p, v, b: (jcog.cognitive_forward(p, v, b, jcfg),
                                   jcog.cognitive_step(p, v, b, jcfg)))
    forward, step = run(jparams, vox, bayer)
    return dict(jcfg=jcfg, jparams=jparams, vox=vox, bayer=bayer,
                forward=forward, step=step,
                params=convert.params_from_numpy(
                    jax.tree_util.tree_map(np.asarray, jparams),
                    device="cpu"))


def _cfg(ref, backend="cuda"):
    return dataclasses.replace(convert.snn_config(ref["jcfg"]),
                               backend=backend)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _check_npu(got, want):
    _close(got.raw_pred, want.raw_pred, NPU_ATOL)
    _close(got.control, want.control, NPU_ATOL)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_cognitive_forward_matches_jax(ref, backend):
    want = ref["forward"]
    isp_cfg = ISP_CONFIGS[{"torch": "default", "cuda": "cuda"}[backend]]
    got = cognitive.cognitive_forward(
        ref["params"], torch.tensor(ref["vox"]), torch.tensor(ref["bayer"]),
        _cfg(ref, backend), isp_cfg)
    _check_npu(got.npu, want.npu)
    _close(got.rgb, want.rgb, ISP_ATOL)
    assert sorted(got.isp_params) == sorted(want.isp_params)
    for s, ps in want.isp_params.items():
        for k, v in ps.items():
            _close(got.isp_params[s][k], v, ISP_ATOL)


def test_cognitive_forward_rejects_undersized_head(ref):
    with pytest.raises(ValueError, match="control_dim"):
        cognitive.cognitive_forward(
            ref["params"], torch.tensor(ref["vox"]),
            torch.tensor(ref["bayer"]), _cfg(ref), ISP_CONFIGS["hdr"])


@pytest.mark.parametrize("use_cuda", [False, True])
def test_cognitive_step_matches_jax(ref, use_cuda):
    want = ref["step"]
    got = cognitive.cognitive_step(
        ref["params"], torch.tensor(ref["vox"]), torch.tensor(ref["bayer"]),
        _cfg(ref), use_cuda=use_cuda)
    _check_npu(got.npu, want.npu)
    _close(got.rgb, want.rgb, ISP_ATOL)
    assert got.isp_params._fields == want.isp_params._fields
    for g, w in zip(got.isp_params, want.isp_params):
        _close(g, w, ISP_ATOL)


def test_exposure_reward_matches_jax():
    rgb = np.random.default_rng(3).uniform(0, 1, (4, 16, 12, 3)).astype(
        np.float32)
    rgb[0] = 0.0                                       # fully clipped
    want = np.asarray(jcog.exposure_reward(rgb))
    got = cognitive.exposure_reward(torch.tensor(rgb))
    assert got.shape == (4,)
    _close(got, want, 1e-6)


def _payloads(ref, n=5, seed=0):
    """Voxel windows and raw event buffers (ragged, some over the
    EVENT_CAPACITY FIFO) with Bayer frames, alternating."""
    jcfg = ref["jcfg"]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        bayer = rng.uniform(0.05, 0.95, (jcfg.height, jcfg.width)).astype(
            np.float32)
        if i % 2 == 0:
            out.append(dict(rid=i, voxels=ref["vox"][:, i % BATCH],
                            bayer=bayer))
        else:
            k = int(rng.integers(100, 2 * EVENT_CAPACITY))
            ev = (rng.random(k).astype(np.float32),
                  rng.integers(0, jcfg.width, k).astype(np.int32),
                  rng.integers(0, jcfg.height, k).astype(np.int32),
                  rng.integers(0, 2, k).astype(np.int32),
                  rng.random(k) < 0.95)
            out.append(dict(rid=i, events=ev, bayer=bayer))
    return out


def _requests(payloads, req_cls, stream_cls):
    return [req_cls(rid=p["rid"], voxels=p.get("voxels"), bayer=p["bayer"],
                    events=stream_cls(*p["events"]) if "events" in p
                    else None) for p in payloads]


def test_all_kernel_engine_matches_jax(ref):
    """The all-kernel configuration (``"cuda"`` encoding, SNN and ISP
    backends) on the CPU against the JAX engine on jnp."""
    payloads = _payloads(ref)
    jeng = JaxEngine(ref["jparams"], ref["jcfg"], batch=BATCH,
                     isp_cfg=jreg.ISP_CONFIGS["default"],
                     enc_cfg=dataclasses.replace(
                         jreg.ENCODING_CONFIGS["paper_binary"],
                         event_capacity=EVENT_CAPACITY))
    want = {r.rid: r.result for r in jeng.run_to_completion(
        _requests(payloads, JaxRequest, JaxEventStream))}
    enc_cfg = dataclasses.replace(ENCODING_CONFIGS["cuda"],
                                  event_capacity=EVENT_CAPACITY)
    eng = CognitiveEngine(ref["params"], _cfg(ref), batch=BATCH,
                          isp_cfg=ISP_CONFIGS["cuda"], enc_cfg=enc_cfg,
                          device="cpu")
    assert eng.staging.events.t.shape == (BATCH, EVENT_CAPACITY)
    done = eng.run_to_completion(_requests(payloads, PerceptionRequest,
                                           EventStream))
    assert sorted(r.rid for r in done) == [p["rid"] for p in payloads]
    for r in done:
        got, w = r.result, want[r.rid]
        _check_npu(got, w)
        _close(got.rgb, w.rgb, ISP_ATOL)
        for s, ps in w.stage_params.items():
            for k, v in ps.items():
                _close(got.stage_params[s][k], v, ISP_ATOL)


def test_engine_rejects_unknown_encoding_backend(ref):
    with pytest.raises(ValueError, match="encoding backend"):
        CognitiveEngine(ref["params"], _cfg(ref), batch=BATCH, device="cpu",
                        enc_cfg=dataclasses.replace(ENCODING_CONFIGS["cuda"],
                                                    backend="pallas"))


@pytest.mark.parametrize("name", ["paper_binary", "count_strict", "signed",
                                  "pallas", "night_lowrate"])
def test_encoding_config_conversion(name):
    cfg = convert.encoding_config(jreg.ENCODING_CONFIGS[name])
    port_name = {"pallas": "cuda"}.get(name, name)
    assert cfg == dataclasses.replace(ENCODING_CONFIGS[port_name], name=name)
