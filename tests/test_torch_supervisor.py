"""The port's FleetSupervisor, mirroring tests/test_supervisor.py: the
breaker state machine under scripted outcomes (pure unit, fake clock),
the fallback ladder's rungs, NaN quarantine through the real fleet,
degradation and recovery end to end, and hedged re-dispatch.  The fleet
runs on the CPU (``device="cpu"``, reduced spiking-YOLO on the "cuda"
backend, whose kernel wrappers take their plain versions there).

Rung parity: on the CPU the three rungs (``"cuda_fused"``, ``"cuda"``,
``"torch"``) all run plain versions and agree exactly, as held here.  On
the card the ladder is rungs 0 and 1 only, bit-equal (the fused and
segment kernels are held bit-equal to the per-layer route), and rung 0
is within the 1e-4 that holds every all-kernel engine to a core on the
plain SNN layers, which is no rung there (``chip_smoke.py``'s fleet
phase checks both).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import FleetConfig, SupervisorConfig
from repro_torch.configs.registry import reduced_snn
from repro_torch.core.npu import init_npu
from repro_torch.serve.cognitive_engine import PerceptionRequest
from repro_torch.serve.faults import FaultEvent, FaultKind, FaultPlan
from repro_torch.serve.fleet import FleetEngine, fleet_ladder
from repro_torch.serve.scheduler import RequestStatus
from repro_torch.serve.supervisor import BreakerState, FleetSupervisor


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_snn("spiking_yolo", backend="cuda")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, params


def _requests(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [PerceptionRequest(
        rid=i,
        voxels=(rng.random((cfg.time_steps, cfg.height, cfg.width, 2))
                < 0.15).astype(np.float32),
        bayer=rng.uniform(0.05, 0.95, (cfg.height, cfg.width)).astype(
            np.float32)) for i in range(n)]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fleet(params, cfg, sup, *, plan=None, clk=None, batch=2):
    clk = clk if clk is not None else _FakeClock()
    return FleetEngine(
        params, cfg, fleet_cfg=FleetConfig(batch=batch, shard=False),
        supervisor_cfg=sup, fault_plan=plan, clock=clk,
        fault_advance=lambda s: setattr(clk, "t", clk.t + s),
        device="cpu"), clk


# ---------------------------------------------------------------------------
# breaker state machine (pure unit: scripted outcomes, no engines)
# ---------------------------------------------------------------------------

def _sup(**kw):
    cfg = SupervisorConfig(breaker_threshold=kw.pop("k", 3),
                           half_open_after=kw.pop("cool", 4),
                           recovery_threshold=kw.pop("rec", 2), **kw)
    return FleetSupervisor(cfg, ["fused", "layer", "torch"], _FakeClock())


def _drive(sup, outcomes):
    """A scripted pass/fail tape through the select/record cycle (depth
    1: each record lands before the next select)."""
    for tick, ok in enumerate(outcomes):
        rung = sup.select_rung(tick)
        sup.record_tick(tick, rung, ok, wall_s=0.01,
                        reason="" if ok else "scripted")


def test_breaker_opens_after_consecutive_failures_only():
    sup = _sup(k=3)
    _drive(sup, [False, False, True, False, False, True])
    assert sup.state is BreakerState.CLOSED
    assert sup.rung == 0
    _drive(sup, [False, False, False])
    assert sup.state is BreakerState.OPEN
    assert sup.rung == 1                      # demoted one rung
    assert [e.event for e in sup.events] == ["demote"]


def test_half_open_probe_and_recovery():
    sup = _sup(k=2, cool=3, rec=2)
    _drive(sup, [False, False])               # open + demote -> rung 1
    assert sup.rung == 1
    _drive(sup, [True, True, True])           # cooldown on rung 1
    assert sup.select_rung(5) == 0            # half-open probe
    assert sup.state is BreakerState.HALF_OPEN
    sup.record_tick(5, 0, True, 0.01)
    assert sup.rung == 1                      # one clean probe: not yet
    assert sup.select_rung(6) == 0
    sup.record_tick(6, 0, True, 0.01)
    assert sup.rung == 0                      # two: promoted
    assert sup.state is BreakerState.CLOSED
    assert [e.event for e in sup.events] == ["demote", "probe", "promote"]


def test_failed_probe_reopens_and_restarts_cooldown():
    sup = _sup(k=2, cool=2, rec=1)
    _drive(sup, [False, False])               # rung 1
    _drive(sup, [True, True])                 # cooldown
    assert sup.select_rung(4) == 0            # probe
    sup.record_tick(4, 0, False, 0.01, "still broken")
    assert sup.state is BreakerState.OPEN
    assert sup.rung == 1                      # stays degraded
    assert sup.select_rung(5) == 1            # the cooldown restarted
    assert "probe_failed" in [e.event for e in sup.events]


def test_ladder_floor_keeps_serving():
    sup = _sup(k=1)
    _drive(sup, [False, False, False])        # demote 0->1->2
    assert sup.rung == 2
    _drive(sup, [False, False])               # on the floor: no demote
    assert sup.rung == 2
    assert [e.event for e in sup.events].count("breaker_floor") == 3


def test_floor_rung_breaker_recloses():
    """A one-rung ladder has nowhere to demote; the breaker re-closes
    after a clean cooldown."""
    cfg = SupervisorConfig(breaker_threshold=2, half_open_after=3,
                           recovery_threshold=2)
    sup = FleetSupervisor(cfg, ["torch"], _FakeClock())
    _drive(sup, [False, False])
    assert sup.state is BreakerState.OPEN
    assert sup.rung == 0
    _drive(sup, [True] * 5)
    assert sup.state is BreakerState.CLOSED
    assert [e.event for e in sup.events] == ["breaker_floor", "close"]


def test_straggler_ticks_count_as_failures():
    cfg = SupervisorConfig(breaker_threshold=1, straggler_factor=2.0,
                           straggler_patience=3)
    sup = FleetSupervisor(cfg, ["fused", "torch"], _FakeClock())
    for t in range(8):                        # a healthy median
        sup.record_tick(t, 0, True, wall_s=0.01)
    assert sup.rung == 0
    for t in range(8, 8 + 3):                 # slow but "ok" ticks
        sup.record_tick(t, 0, True, wall_s=1.0)
    assert sup.rung == 1
    assert any(e.reason == "straggler" for e in sup.events)


def test_tick_outcomes_deterministic_replay():
    a, b = _sup(k=2, cool=2, rec=1), _sup(k=2, cool=2, rec=1)
    tape = [True, False, False, True, True, False, True, True, True,
            False, False, True, True, True, True]
    _drive(a, tape)
    _drive(b, tape)
    assert a.stats() == b.stats()


# ---------------------------------------------------------------------------
# the fallback ladder: degradation trades speed, never the function
# ---------------------------------------------------------------------------

def test_ladder_rungs_bit_parity(setup):
    """The three rungs on one staged bank agree exactly on the CPU (all
    plain versions); rung 1 pins an empty launch table."""
    cfg, params = setup
    fleet, _ = _fleet(params, cfg, SupervisorConfig())
    assert fleet.ladder_names == ["cuda_fused", "cuda", "torch"]
    assert [c.cfg.backend for c in fleet.cores] == ["cuda", "cuda", "torch"]
    assert fleet.cores[1].tune_table.entries == {}
    bank = fleet.buffers.front
    for i, r in enumerate(_requests(cfg, 2, seed=3)):
        bank.stage_voxels(i, r.voxels, r.bayer)
    outs = [core.tick(bank) for core in fleet.cores]
    ref_out, ref_rgb, ref_sp = outs[0]
    for out, rgb, sp in outs[1:]:
        np.testing.assert_array_equal(out.raw_pred, ref_out.raw_pred)
        np.testing.assert_array_equal(out.control, ref_out.control)
        np.testing.assert_array_equal(rgb, ref_rgb)
        for st, ps in ref_sp.items():
            for k, v in ps.items():
                np.testing.assert_array_equal(sp[st][k], v)


@pytest.mark.parametrize("device_type,names", [
    ("cuda", ["cuda_fused", "cuda"]),
    ("cpu", ["cuda_fused", "cuda", "torch"])])
def test_card_ladder_has_kernel_rungs_only(setup, device_type, names):
    """On a card every rung is a kernel route, so a quarantine or a stall
    never moves the fleet onto the plain layers; the CPU keeps the
    reference's plain third rung."""
    cfg, _ = setup
    ladder = fleet_ladder(cfg, device_type)
    assert [n for n, _, _ in ladder] == names
    assert [c.backend for _, c, _ in ladder][:2] == ["cuda", "cuda"]
    assert ladder[1][2].entries == {}
    plain = dataclasses.replace(cfg, backend="torch")
    assert [n for n, _, _ in fleet_ladder(plain, device_type)] == ["torch"]
    assert [n for n, _, _ in fleet_ladder(cfg, device_type, False)] == \
        ["cuda"]


def test_unsupervised_or_plain_fleet_has_one_rung(setup):
    cfg, params = setup
    fleet, _ = _fleet(params, cfg, None)
    assert fleet.ladder_names == ["cuda"] and len(fleet.cores) == 1
    plain, _ = _fleet(params, dataclasses.replace(cfg, backend="torch"),
                      SupervisorConfig())
    assert plain.ladder_names == ["torch"]


def test_prewarm_runs_every_rung(setup, monkeypatch):
    cfg, params = setup
    calls = []
    from repro_torch.serve import engine_core
    real = engine_core.EngineCore.dispatch

    def counted(self, views):
        calls.append(self.cfg.backend)
        return real(self, views)
    monkeypatch.setattr(engine_core.EngineCore, "dispatch", counted)
    plan = FaultPlan([FaultEvent(0, FaultKind.TRANSIENT_ERROR)])
    fleet, _ = _fleet(params, cfg, SupervisorConfig(prewarm=True),
                      plan=plan)
    assert calls == ["cuda", "cuda", "torch"]
    assert fleet.core._ticker.tick == 0       # past the injector


# ---------------------------------------------------------------------------
# through the real fleet: quarantine, degradation, recovery, hedging
# ---------------------------------------------------------------------------

def test_nan_quarantine_zero_nan_delivered(setup):
    cfg, params = setup
    plan = FaultPlan([FaultEvent(0, FaultKind.NAN_OUTPUT, slot=0),
                      FaultEvent(1, FaultKind.NAN_OUTPUT, slot=1)])
    sup = SupervisorConfig(max_retries=2, retry_backoff_ms=1.0,
                           retry_jitter_ms=0.0, breaker_threshold=100)
    fleet, clk = _fleet(params, cfg, sup, plan=plan)
    rs = _requests(cfg, 4)
    for r in rs:
        fleet.submit(r)
    for _ in range(12):
        clk.t += 0.01
        fleet.step()
    s = fleet.stats()
    assert s["nan_delivered"] == 0
    assert s["supervisor"]["quarantined"] == 2
    assert s["delivered"] == 4                # quarantined slots retried
    for r in rs:
        assert np.isfinite(r.result.raw_pred).all()
    assert sum(r.result.telemetry.quarantined for r in rs) >= 1


def test_degrade_and_recover_visible_in_telemetry(setup):
    cfg, params = setup
    plan = FaultPlan([FaultEvent(t, FaultKind.TRANSIENT_ERROR)
                      for t in range(1, 5)])
    sup = SupervisorConfig(breaker_threshold=2, half_open_after=2,
                           recovery_threshold=2, max_retries=3,
                           retry_backoff_ms=1.0, retry_jitter_ms=0.0)
    fleet, clk = _fleet(params, cfg, sup, plan=plan)
    rs = _requests(cfg, 16)
    for r in rs[:6]:
        fleet.submit(r)
    done = []
    for step in range(60):
        clk.t += 0.01
        done.extend(fleet.step())
        if step % 3 == 0 and 6 + step // 3 < len(rs):
            fleet.submit(rs[6 + step // 3])
    s = fleet.stats()
    events = [e["event"] for e in s["supervisor"]["transitions"]]
    assert "demote" in events and "promote" in events
    assert s["supervisor"]["degraded_ticks"] > 0
    assert s["supervisor"]["breaker_state"] == "closed"
    assert s["supervisor"]["active_backend"] == "cuda_fused"
    assert s["delivered"] == 16
    assert s["nan_delivered"] == 0
    rungs = {r.telemetry.rung for r in done
             if r.status is RequestStatus.DONE}
    assert "cuda_fused" in rungs and "cuda" in rungs


def test_hedge_wins_when_primary_tick_fails(setup):
    cfg, params = setup
    plan = FaultPlan([FaultEvent(0, FaultKind.TRANSIENT_ERROR)])
    sup = SupervisorConfig(max_retries=0, hedge_after_ms=5.0,
                           breaker_threshold=100)
    fleet, clk = _fleet(params, cfg, sup, plan=plan)
    rs = _requests(cfg, 2)
    for r in rs:
        fleet.submit(r)
    for _ in range(8):
        clk.t += 0.01
        fleet.step()
    s = fleet.stats()
    assert s["hedges"] == 2
    assert s["hedge_wins"] == 2
    assert s["delivered"] == 2
    assert s["failed"] == 0                   # parked on hedge, not failed
    for r in rs:
        assert r.result is not None
        assert r.result.telemetry.hedge_won


def test_hedge_win_settles_a_queued_retry(setup):
    """The primaries' tick fails after their hedges were dispatched; the
    primaries back off to retry, the hedges deliver them, and the
    retries waiting in the queue are never packed: each request is
    delivered and reported terminal exactly once."""
    cfg, params = setup
    plan = FaultPlan([FaultEvent(0, FaultKind.TRANSIENT_ERROR)])
    sup = SupervisorConfig(max_retries=1, retry_backoff_ms=50.0,
                           retry_jitter_ms=0.0, hedge_after_ms=5.0,
                           breaker_threshold=100)
    fleet, clk = _fleet(params, cfg, sup, plan=plan)
    rs = _requests(cfg, 2)
    subs = [fleet.submit(r) for r in rs]
    terminal = []
    for _ in range(12):
        clk.t += 0.01
        terminal.extend(fleet.step())
    s = fleet.stats()
    assert s["retries"] == 2 and s["hedge_wins"] == 2
    assert s["delivered"] == 2 and s["failed"] == 0
    assert sorted(t.rid for t in terminal) == [0, 1]
    assert all(x.status is RequestStatus.DONE for x in subs)
    assert len(fleet.queue) == 0 and fleet.ticks == 2


def test_no_hedge_before_slo(setup):
    cfg, params = setup
    fleet, clk = _fleet(params, cfg, SupervisorConfig(
        hedge_after_ms=10_000.0))
    for r in _requests(cfg, 2):
        fleet.submit(r)
    for _ in range(4):
        clk.t += 0.01
        fleet.step()
    s = fleet.stats()
    assert s["hedges"] == 0
    assert s["delivered"] == 2


def test_supervised_clean_run_stays_on_primary(setup):
    cfg, params = setup
    fleet, clk = _fleet(params, cfg, SupervisorConfig())
    done = fleet.run_to_completion(_requests(cfg, 6))
    s = fleet.stats()
    assert s["delivered"] == 6
    assert s["supervisor"]["breaker_state"] == "closed"
    assert s["supervisor"]["transitions"] == []
    assert s["supervisor"]["degraded_ticks"] == 0
    assert {r.telemetry.rung for r in done} == {"cuda_fused"}
