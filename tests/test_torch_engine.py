"""Port parity for the slice whole: the port's ``CognitiveEngine`` on the
CPU and the JAX ``CognitiveEngine`` (jnp path) answer the same mix of
voxel and raw-event requests with matching rgb, control, raw_pred and
stage params; slots recycle and ``run_to_completion`` drains.

Inputs are numpy-made; weights come from the JAX ``init_npu`` through
``repro_torch.convert``.  Tolerances: the NPU outputs at 1e-4 (the
whole-forward bar of tests/test_torch_npu.py), the ISP output and the
stage params at 1e-5 (the control vector's rounding carried through).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.registry import reduced_snn as jax_reduced_snn
from repro.core.encoding import EventStream as JaxEventStream
from repro.core.npu import init_npu as jax_init_npu
from repro.serve.cognitive_engine import CognitiveEngine as JaxEngine
from repro.serve.cognitive_engine import PerceptionRequest as JaxRequest
from repro_torch import convert
from repro_torch.core.encoding import EventStream
from repro_torch.isp.pipeline import legacy_control_permutation
from repro_torch.serve.cognitive_engine import (CognitiveEngine,
                                                PerceptionRequest)

NPU_ATOL = 1e-4
ISP_ATOL = 1e-5
N_REQ, BATCH = 5, 2


def _payloads(cfg, n, seed=0):
    """n requests alternating voxel windows and raw event buffers (of
    ragged length, some over the FIFO capacity)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        bayer = rng.uniform(0.05, 0.95, (cfg.height, cfg.width)).astype(
            np.float32)
        if i % 2 == 0:
            vox = (rng.random((cfg.time_steps, cfg.height, cfg.width, 2))
                   < 0.15).astype(np.float32)
            out.append(dict(rid=i, voxels=vox, bayer=bayer))
        else:
            n_ev = int(rng.integers(500, 2600))
            ev = (rng.random(n_ev).astype(np.float32),
                  rng.integers(0, cfg.width, n_ev).astype(np.int32),
                  rng.integers(0, cfg.height, n_ev).astype(np.int32),
                  rng.integers(0, 2, n_ev).astype(np.int32),
                  rng.random(n_ev) < 0.95)
            out.append(dict(rid=i, events=ev, bayer=bayer))
    return out


def _requests(payloads, req_cls, stream_cls):
    return [req_cls(rid=p["rid"], voxels=p.get("voxels"), bayer=p["bayer"],
                    events=stream_cls(*p["events"]) if "events" in p
                    else None) for p in payloads]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced_snn("spiking_yolo")
    jparams = jax_init_npu(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    payloads = _payloads(jcfg, N_REQ)
    jeng = JaxEngine(jparams, jcfg, batch=BATCH)
    want = {r.rid: r.result for r in jeng.run_to_completion(
        _requests(payloads, JaxRequest, JaxEventStream))}
    return jcfg, params, payloads, want


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_matches_jax(setup, backend):
    jcfg, params, payloads, want = setup
    cfg = dataclasses.replace(convert.snn_config(jcfg), backend=backend)
    eng = CognitiveEngine(params, cfg, batch=BATCH, device="cpu")
    done = eng.run_to_completion(_requests(payloads, PerceptionRequest,
                                           EventStream))
    assert sorted(r.rid for r in done) == list(range(N_REQ))
    assert eng.ticks == -(-N_REQ // BATCH)
    for r in done:
        got, ref = r.result, want[r.rid]
        assert got.rgb.shape == (cfg.height, cfg.width, 3)
        np.testing.assert_allclose(got.raw_pred, np.asarray(ref.raw_pred),
                                   atol=NPU_ATOL, rtol=0)
        np.testing.assert_allclose(got.control, np.asarray(ref.control),
                                   atol=NPU_ATOL, rtol=0)
        np.testing.assert_allclose(got.rgb, np.asarray(ref.rgb),
                                   atol=ISP_ATOL, rtol=0)
        assert sorted(got.stage_params) == sorted(ref.stage_params)
        for s, ps in ref.stage_params.items():
            for k, v in ps.items():
                np.testing.assert_allclose(got.stage_params[s][k],
                                           np.asarray(v), atol=ISP_ATOL)


def test_legacy_control_order_and_sparsity(setup):
    """control_order="legacy" permutes the head's slots before the range
    mapping; collect_sparsity rides the per-layer rates on every result."""
    jcfg, params, payloads, _ = setup
    cfg = convert.snn_config(jcfg)
    reqs = _requests(payloads[:BATCH], PerceptionRequest, EventStream)
    eng = CognitiveEngine(params, cfg, batch=BATCH, device="cpu",
                          control_order="legacy", collect_sparsity=True)
    perm = np.asarray(legacy_control_permutation())
    for r in eng.run_to_completion(reqs):
        ctrl = r.result.control[perm]
        assert float(r.result.stage_params["exposure"]["gain"]) == \
            pytest.approx(0.5 + 1.5 * float(ctrl[0]))
        assert "network_sparsity" in r.result.sparsity
        assert 0.0 <= r.result.sparsity["d0"] <= 1.0


def test_slots_recycle_and_validate(setup):
    jcfg, params, payloads, _ = setup
    cfg = convert.snn_config(jcfg)
    eng = CognitiveEngine(params, cfg, batch=BATCH, device="cpu")
    reqs = _requests(payloads[:3], PerceptionRequest, EventStream)
    assert eng.submit(reqs[0]) and eng.submit(reqs[1])
    assert not eng.submit(reqs[2])                  # pool exhausted
    assert eng.staging.from_events.tolist() == [False, True]
    assert {r.rid for r in eng.tick()} == {0, 1}
    assert eng.tick() == []                         # nothing active
    assert eng.submit_events(reqs[1])               # slot recycled
    assert [r.rid for r in eng.tick()] == [1]
    with pytest.raises(ValueError):
        eng.submit(PerceptionRequest(rid=9, bayer=payloads[0]["bayer"]))
    with pytest.raises(ValueError):
        eng.submit_events(PerceptionRequest(rid=9, voxels=np.zeros(3),
                                            bayer=payloads[0]["bayer"]))

