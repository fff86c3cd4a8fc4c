"""The port's FleetEngine on the CPU (``device="cpu"``, reduced
spiking-YOLO), mirroring tests/test_fleet.py: admission control, deadline
shedding, ragged arrival, the double-buffered pipeline, telemetry and
fleet-vs-CognitiveEngine parity; then what the port adds: the same
requests against the JAX FleetEngine (``mesh=None``, jnp) on both SNN
backends, ``dispatch`` then ``fetch`` against ``step``, a core's
RuntimeError out of ``step()``, one card only (an explicit mesh raises),
the hardened ``validate_request`` with the reference's messages, the
pinned-bank rule, and the fleet configs against the reference's.

The reference's two mesh tests are not mirrored: the port serves one
card.  Tolerances: the JAX parity is tests/test_torch_engine.py's (NPU
outputs 1e-4, rgb and stage params 1e-5); everything inside the port is
held exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro.configs.registry import reduced_snn as jax_reduced_snn
from repro.core.encoding import EventStream as JaxEventStream
from repro.core.npu import init_npu as jax_init_npu
from repro.serve.cognitive_engine import PerceptionRequest as JaxRequest
from repro.serve.fleet import FleetEngine as JaxFleet
from repro_torch import convert
from repro_torch.configs import base, registry
from repro_torch.configs.base import FleetConfig
from repro_torch.core.encoding import EventStream
from repro_torch.serve.cognitive_engine import (CognitiveEngine,
                                                PerceptionRequest)
from repro_torch.serve.fleet import FleetEngine
from repro_torch.serve.scheduler import (AdmissionQueue, RequestStatus,
                                         ServeRequest)
from repro_torch.serve.transport import (DoubleBuffer, StagingBank,
                                         validate_request)

NPU_ATOL = 1e-4
ISP_ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced_snn("spiking_yolo")
    jparams = jax_init_npu(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, convert.snn_config(jcfg), params


def _payloads(cfg, n, seed=0, events=False):
    """n requests: voxel windows, or (``events``) every other one a raw
    event buffer of ragged length."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        bayer = rng.uniform(0.05, 0.95, (cfg.height, cfg.width)).astype(
            np.float32)
        if events and i % 2:
            n_ev = int(rng.integers(500, 2600))
            ev = (rng.random(n_ev).astype(np.float32),
                  rng.integers(0, cfg.width, n_ev).astype(np.int32),
                  rng.integers(0, cfg.height, n_ev).astype(np.int32),
                  rng.integers(0, 2, n_ev).astype(np.int32),
                  rng.random(n_ev) < 0.95)
            out.append(dict(rid=i, events=ev, bayer=bayer))
        else:
            vox = (rng.random((cfg.time_steps, cfg.height, cfg.width, 2))
                   < 0.15).astype(np.float32)
            out.append(dict(rid=i, voxels=vox, bayer=bayer))
    return out


def _as(payloads, req_cls=PerceptionRequest, stream_cls=EventStream):
    return [req_cls(rid=p["rid"], voxels=p.get("voxels"), bayer=p["bayer"],
                    events=stream_cls(*p["events"]) if "events" in p
                    else None) for p in payloads]


def _requests(cfg, n, seed=0, events=False):
    return _as(_payloads(cfg, n, seed, events))


class _FakeClock:
    """Deterministic serving clock: deadlines fire exactly when the test
    advances it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fleet(params, cfg, **kw):
    return FleetEngine(params, cfg, device="cpu", **kw)


# ---------------------------------------------------------------------------
# pure scheduler semantics (no engine)
# ---------------------------------------------------------------------------

def test_admission_queue_bounded_and_sheds():
    q = AdmissionQueue(2)
    a = ServeRequest(request=PerceptionRequest(rid=0))
    b = ServeRequest(request=PerceptionRequest(rid=1), deadline=5.0)
    c = ServeRequest(request=PerceptionRequest(rid=2))
    assert q.offer(a, now=0.0) and q.offer(b, now=1.0)
    assert not q.offer(c, now=2.0)            # depth 2: rejected
    assert c.status is RequestStatus.REJECTED and q.n_rejected == 1
    assert b.telemetry.t_enqueue == 1.0
    shed = q.shed_expired(now=10.0)           # b expired mid-queue
    assert shed == [b] and b.status is RequestStatus.EXPIRED
    assert q.n_expired == 1 and len(q) == 1
    assert q.pop_ready(now=10.0) is a and q.pop_ready(now=10.0) is None
    with pytest.raises(ValueError, match="max_depth"):
        AdmissionQueue(0)


# ---------------------------------------------------------------------------
# fleet serving semantics (one device)
# ---------------------------------------------------------------------------

def test_fleet_admission_control_rejects_beyond_queue(setup):
    _, _, cfg, params = setup
    fleet = _fleet(params, cfg, fleet_cfg=FleetConfig(batch=2, max_queue=3))
    sub = [fleet.submit(r) for r in _requests(cfg, 5)]
    assert [s.status for s in sub[:3]] == [RequestStatus.QUEUED] * 3
    assert [s.status for s in sub[3:]] == [RequestStatus.REJECTED] * 2
    assert all(s.request.result is None for s in sub[3:])
    done = fleet.drain()
    assert sorted(s.rid for s in done) == [0, 1, 2]
    assert fleet.stats()["rejected"] == 2
    assert fleet.stats()["delivered"] == 3


def test_fleet_deadline_shedding_is_explicit(setup):
    """A queued request whose deadline passes is shed with EXPIRED and a
    None result: never silently dropped, never delivered stale."""
    _, _, cfg, params = setup
    clk = _FakeClock()
    fleet = _fleet(params, cfg, clock=clk,
                   fleet_cfg=FleetConfig(batch=2, max_queue=8))
    live, doomed = _requests(cfg, 2)
    s_live = fleet.submit(live)                       # no deadline
    s_doomed = fleet.submit(doomed, deadline_ms=10.0)  # 0.01 s
    clk.t = 5.0                                       # way past it
    done = fleet.drain()
    assert s_doomed in done and s_doomed.status is RequestStatus.EXPIRED
    assert doomed.result is None
    assert s_live.status is RequestStatus.DONE
    assert live.result is not None
    assert fleet.stats()["expired"] == 1


def test_fleet_default_deadline_inherited_from_config(setup):
    _, _, cfg, params = setup
    clk = _FakeClock()
    fleet = _fleet(params, cfg, clock=clk,
                   fleet_cfg=FleetConfig(batch=2, max_queue=8,
                                         default_deadline_ms=100.0))
    sreq = fleet.submit(_requests(cfg, 1)[0])
    assert sreq.deadline == pytest.approx(0.1)
    clk.t = 1.0
    done = fleet.drain()
    assert done == [sreq] and sreq.status is RequestStatus.EXPIRED


def test_fleet_double_buffer_pipelines_one_tick_deep(setup):
    """With double buffering the first step dispatches but harvests
    nothing; results arrive one step later.  Depth 1 delivers at once."""
    _, _, cfg, params = setup
    fleet = _fleet(params, cfg, fleet_cfg=FleetConfig(
        batch=2, max_queue=8, double_buffer=True))
    for r in _requests(cfg, 2):
        fleet.submit(r)
    assert fleet.step() == []            # tick 1 in flight
    assert fleet._inflight is not None
    done = fleet.step()                  # harvested on the next round
    assert sorted(s.rid for s in done) == [0, 1]
    assert all(s.status is RequestStatus.DONE for s in done)

    edge = _fleet(params, cfg, fleet_cfg=FleetConfig(
        batch=2, max_queue=8, double_buffer=False))
    for r in _requests(cfg, 2, seed=1):
        edge.submit(r)
    assert sorted(s.rid for s in edge.step()) == [0, 1]


@pytest.mark.parametrize("double_buffer", [True, False])
def test_fleet_matches_cognitive_engine(setup, double_buffer):
    """Continuous batching does not change the math: the same requests
    through the fleet (either depth) and the CognitiveEngine give the
    same rgb, control and raw_pred."""
    _, _, cfg, params = setup
    n = 5                                # ragged: 2 full ticks + 1 part
    fleet = _fleet(params, cfg, fleet_cfg=FleetConfig(
        batch=2, max_queue=8, double_buffer=double_buffer))
    done = fleet.run_to_completion(_requests(cfg, n, events=True))
    assert len(done) == n
    eng = CognitiveEngine(params, cfg, batch=2, device="cpu")
    ref = _requests(cfg, n, events=True)
    eng.run_to_completion(ref)
    for s, r in zip(sorted(done, key=lambda s: s.rid), ref):
        assert s.rid == r.rid
        for f in ("rgb", "control", "raw_pred"):
            np.testing.assert_array_equal(getattr(s.request.result, f),
                                          getattr(r.result, f))


def test_fleet_ragged_arrival_keeps_batch_full(setup):
    """Requests arriving between steps pack into the next tick; nothing
    waits for a full batch."""
    _, _, cfg, params = setup
    fleet = _fleet(params, cfg, fleet_cfg=FleetConfig(batch=4,
                                                      max_queue=16))
    reqs = _requests(cfg, 6)
    for r in reqs[:3]:
        fleet.submit(r)
    out = fleet.step()                   # 3/4 slots used, in flight
    for r in reqs[3:]:
        fleet.submit(r)                  # arrive mid-pipeline
    out += fleet.drain()
    assert sorted(s.rid for s in out) == list(range(6))
    assert fleet.ticks == 2              # 3-wide tick + 3-wide tick


def test_fleet_event_requests_and_mixed_kinds(setup):
    _, _, cfg, params = setup
    fleet = _fleet(params, cfg, fleet_cfg=FleetConfig(batch=2,
                                                      max_queue=8))
    vr, er = _requests(cfg, 2, seed=2, events=True)
    s1, s2 = fleet.submit(vr), fleet.submit(er)
    assert (s1.kind, s2.kind) == ("voxels", "events")
    done = fleet.drain()
    assert sorted(s.rid for s in done) == [0, 1]
    for s in done:
        assert s.request.result.rgb.shape == (cfg.height, cfg.width, 3)
        assert np.isfinite(s.request.result.rgb).all()


def test_fleet_telemetry_timestamps_and_late_delivery(setup):
    """enqueue <= admit <= dispatch <= deliver; a request whose deadline
    passes after dispatch is still delivered, flagged deadline_missed."""
    _, _, cfg, params = setup
    clk = _FakeClock()
    fleet = _fleet(params, cfg, clock=clk, fleet_cfg=FleetConfig(
        batch=2, max_queue=8, double_buffer=True))
    sreq = fleet.submit(_requests(cfg, 1)[0], deadline_ms=1000.0)
    clk.t = 0.25
    assert fleet.step() == []            # dispatched within deadline
    assert sreq.status is RequestStatus.IN_FLIGHT
    clk.t = 2.0                          # deadline passes in flight
    done = fleet.step()
    assert done == [sreq] and sreq.status is RequestStatus.DONE
    tel = sreq.request.result.telemetry
    assert tel.deadline_missed
    assert (tel.t_enqueue <= tel.t_admit <= tel.t_dispatch
            <= tel.t_deliver)
    assert tel.latency_s == pytest.approx(2.0)
    assert fleet.stats()["deadline_missed"] == 1


def test_fleet_stats_percentiles(setup):
    _, _, cfg, params = setup
    fleet = _fleet(params, cfg, fleet_cfg=FleetConfig(batch=2,
                                                      max_queue=16))
    fleet.run_to_completion(_requests(cfg, 4))
    st = fleet.stats()
    assert st["delivered"] == 4 and st["rejected"] == 0
    assert st["n_devices"] == 1
    assert 0.0 < st["latency_p50_s"] <= st["latency_p99_s"]


# ---------------------------------------------------------------------------
# what the port adds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["auto", None])
def test_fleet_serves_one_card(setup, mesh):
    """``mesh="auto"`` (and None) is the one device; an explicit mesh
    waits for sharded serving."""
    _, _, cfg, params = setup
    fleet = _fleet(params, cfg, mesh=mesh,
                   fleet_cfg=FleetConfig(batch=2, max_queue=4))
    assert fleet.mesh is None
    assert len(fleet.run_to_completion(_requests(cfg, 2))) == 2
    assert fleet.core.n_devices == 1
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        _fleet(params, cfg, mesh=object())


@pytest.fixture(scope="module")
def jax_fleet_results(setup):
    """The JAX FleetEngine (mesh=None, jnp) on a mix of voxel and event
    requests, batch 2, double-buffered."""
    jcfg, jparams, cfg, _ = setup
    fleet = JaxFleet(jparams, jcfg, mesh=None,
                     fleet_cfg=jbase.FleetConfig(batch=2, max_queue=8))
    done = fleet.run_to_completion(
        _as(_payloads(cfg, 5, seed=4, events=True), JaxRequest,
            JaxEventStream))
    return {s.rid: s.request.result for s in done}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fleet_matches_jax_fleet(setup, jax_fleet_results, backend):
    _, _, cfg, params = setup
    fleet = _fleet(params, dataclasses.replace(cfg, backend=backend),
                   fleet_cfg=FleetConfig(batch=2, max_queue=8))
    done = fleet.run_to_completion(_requests(cfg, 5, seed=4, events=True))
    assert sorted(s.rid for s in done) == sorted(jax_fleet_results)
    assert fleet.ticks == 3
    for s in done:
        got, ref = s.request.result, jax_fleet_results[s.rid]
        assert s.status is RequestStatus.DONE
        np.testing.assert_allclose(got.raw_pred, np.asarray(ref.raw_pred),
                                   atol=NPU_ATOL, rtol=0)
        np.testing.assert_allclose(got.control, np.asarray(ref.control),
                                   atol=NPU_ATOL, rtol=0)
        np.testing.assert_allclose(got.rgb, np.asarray(ref.rgb),
                                   atol=ISP_ATOL, rtol=0)
        for st, ps in ref.stage_params.items():
            for k, v in ps.items():
                np.testing.assert_allclose(got.stage_params[st][k],
                                           np.asarray(v), atol=ISP_ATOL)
        assert got.telemetry.rung == backend


def test_dispatch_then_fetch_equals_step(setup):
    """The split tick is the tick: fetch(dispatch(upload)) against
    fetch(step) on the same bank, and two ticks dispatched before either
    is fetched keep their own outputs."""
    _, _, cfg, params = setup
    fleet = _fleet(params, cfg, fleet_cfg=FleetConfig(batch=2))
    core = fleet.core
    banks = fleet.buffers.banks
    for bank, seed in zip(banks, (5, 6)):
        for i, r in enumerate(_requests(cfg, 2, seed=seed)):
            bank.stage_voxels(i, r.voxels, r.bayer)
    a = core.dispatch(core.upload(banks[0]))
    b = core.dispatch(core.upload(banks[1]))
    for bank, d in ((banks[0], a), (banks[1], b)):
        out, rgb, sp = core.fetch(d)
        w_out, w_rgb, w_sp = core.step(*core.upload(bank))
        np.testing.assert_array_equal(out.raw_pred, w_out.raw_pred.numpy())
        np.testing.assert_array_equal(out.control, w_out.control.numpy())
        np.testing.assert_array_equal(rgb, w_rgb.numpy())
        for st, ps in w_sp.items():
            for k, v in ps.items():
                np.testing.assert_array_equal(sp[st][k], v.numpy())


def test_core_runtime_error_propagates_out_of_step(setup, monkeypatch):
    """A kernel that fails to build or launch raises RuntimeError; the
    fleet never turns it into a failed tick or a demotion."""
    _, _, cfg, params = setup
    fleet = _fleet(params, dataclasses.replace(cfg, backend="cuda"),
                   supervisor_cfg=base.SupervisorConfig(),
                   fleet_cfg=FleetConfig(batch=2))

    def broken(*_):
        raise RuntimeError("CUDA kernel spike_conv failed to launch: "
                           "cudaError 98")
    monkeypatch.setattr(fleet.cores[0], "step", broken)
    for r in _requests(cfg, 2):
        fleet.submit(r)
    with pytest.raises(RuntimeError, match="failed to launch"):
        fleet.step()
    assert fleet.supervisor.rung == 0 and fleet.supervisor.events == []
    assert fleet.supervisor.n_tick_failures == 0


def test_validate_request_hardened_with_the_reference_messages(setup):
    _, _, cfg, _ = setup
    T, H, W = cfg.time_steps, cfg.height, cfg.width
    kw = dict(time_steps=T, voxel_hw=(H, W), frame_hw=(H, W))
    good = np.zeros((T, H, W, 2), np.float32)
    bayer = np.zeros((H, W), np.float32)
    cases = [
        (dict(voxels=np.zeros(3, np.float32), bayer=bayer),
         r"request 7: voxels must be \[T, H, W, C\], got shape \(3,\)"),
        (dict(voxels=good[:, :4], bayer=bayer),
         r"request 7: voxel shape \(3, 4, 32, 2\) does not match the "
         r"engine's \[T, H, W, C\]=\(3, 32, 32, 2\)"),
        (dict(voxels=good[:2], bayer=bayer), "does not match"),
        (dict(voxels=good, bayer=bayer[:8]),
         r"request 7: bayer frame \(8, 32\) does not match the engine's "
         r"frame_hw=\(32, 32\)"),
        (dict(voxels=good, bayer=bayer[0]),
         r"bayer frame must be 2-D \[H, W\], got shape \(32,\)"),
        (dict(voxels=good), "request 7 carries no bayer frame"),
        (dict(bayer=bayer), "request 7: neither voxels nor events"),
        (dict(events=EventStream(*(np.zeros(4, np.int32),) * 5),
              bayer=bayer[:4]), "does not match the engine's frame_hw"),
    ]
    for fields, msg in cases:
        with pytest.raises(ValueError, match=msg):
            validate_request(PerceptionRequest(rid=7, **fields), 2, **kw)
    assert validate_request(PerceptionRequest(rid=7, voxels=good,
                                              bayer=bayer), 2, **kw) \
        == "voxels"
    # without the keywords only the rank and the channels are held
    assert validate_request(PerceptionRequest(
        rid=7, voxels=good[:2, :4], bayer=bayer[:8]), 2) == "voxels"
    with pytest.raises(ValueError, match="does not match"):
        validate_request(PerceptionRequest(rid=7, voxels=good,
                                           bayer=bayer), 3)


class _Event:
    """A copy's event, completed when the test says so."""

    def __init__(self):
        self.done = False
        self.waited = 0

    def synchronize(self):
        self.waited += 1
        self.done = True


def test_bank_is_repacked_only_after_its_copy_event(setup):
    """Every write into a bank (staging, the fleet's recycled slots)
    first waits for the event recorded behind its last upload."""
    _, _, cfg, _ = setup
    bank = StagingBank(cfg, 2, (cfg.height, cfg.width), 16)
    r = _requests(cfg, 1)[0]
    for write in (lambda: bank.stage_voxels(0, r.voxels, r.bayer),
                  lambda: bank.stage_events(1, EventStream(
                      *(np.zeros(16, dt) for dt in (np.float32, np.int32,
                                                    np.int32, np.int32,
                                                    bool))), r.bayer)):
        ev = _Event()
        bank.mark_copied(ev)
        write()
        assert ev.done and ev.waited == 1
        write()                          # the event is consumed once
        assert ev.waited == 1
    buffers = DoubleBuffer(lambda: StagingBank(cfg, 2, (8, 8), 4))
    first = buffers.front
    buffers.flip()
    assert buffers.front is not first
    buffers.flip()
    assert buffers.front is first
    assert len(DoubleBuffer(lambda: None, enabled=False).banks) == 1


@pytest.mark.parametrize("port_reg,ref_reg", [
    ("FLEET_CONFIGS", "FLEET_CONFIGS"), ("FAULT_CONFIGS", "FAULT_CONFIGS"),
    ("SUPERVISOR_CONFIGS", "SUPERVISOR_CONFIGS")])
def test_fleet_configs_equal_the_reference(port_reg, ref_reg):
    """Field names, defaults and every named config as the reference's."""
    port, ref = getattr(registry, port_reg), getattr(jregistry, ref_reg)
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert dataclasses.asdict(port[name]) == \
            dataclasses.asdict(ref[name])
    for cls in ("FleetConfig", "FaultConfig", "SupervisorConfig"):
        assert dataclasses.asdict(getattr(base, cls)()) == \
            dataclasses.asdict(getattr(jbase, cls)())
    assert registry.get_fleet_config("edge_realtime").batch == 4
    assert registry.get_fault_config("chaos").seed == 7
    assert registry.get_supervisor_config("soak").breaker_threshold == 1


def test_bank_pinned_only_for_a_card(setup):
    _, _, cfg, params = setup
    fleet = _fleet(params, cfg, fleet_cfg=FleetConfig(batch=2))
    assert all(not b.buffer.is_pinned() for b in fleet.buffers.banks)
    assert fleet.core.device == torch.device("cpu")
