"""The port's fault injection on the CPU (``device="cpu"``, reduced
spiking-YOLO), mirroring tests/test_faults.py: schedule determinism, the
injected faults reaching the real serving path, malformed requests at
the edge, retries and backoff on a fake clock.  Then against the
reference itself: ``FaultPlan.from_config`` gives the reference's event
list for every named fault config, and the retry gates (backoff and
seeded jitter) equal the JAX FleetEngine's on the same fault schedule.
Everything inside the port is held exact."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro.configs.registry import reduced_snn as jax_reduced_snn
from repro.core.npu import init_npu as jax_init_npu
from repro.serve import faults as jfaults
from repro.serve.cognitive_engine import PerceptionRequest as JaxRequest
from repro.serve.fleet import FleetEngine as JaxFleet
from repro_torch import convert
from repro_torch.configs.base import (FaultConfig, FleetConfig,
                                      SupervisorConfig)
from repro_torch.configs.registry import FAULT_CONFIGS
from repro_torch.serve.cognitive_engine import PerceptionRequest
from repro_torch.serve.faults import (FaultEvent, FaultKind, FaultPlan,
                                      make_malformed_request)
from repro_torch.serve.fleet import FleetEngine
from repro_torch.serve.scheduler import RequestStatus


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced_snn("spiking_yolo")
    jparams = jax_init_npu(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, convert.snn_config(jcfg), params


def _payloads(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [((rng.random((cfg.time_steps, cfg.height, cfg.width, 2))
              < 0.15).astype(np.float32),
             rng.uniform(0.05, 0.95, (cfg.height, cfg.width)).astype(
                 np.float32)) for _ in range(n)]


def _requests(cfg, n, seed=0, cls=PerceptionRequest):
    return [cls(rid=i, voxels=v, bayer=b)
            for i, (v, b) in enumerate(_payloads(cfg, n, seed))]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fleet(params, cfg, *, plan=None, sup=None, clk=None, batch=2, **kw):
    clk = clk if clk is not None else _FakeClock()
    return FleetEngine(
        params, cfg, fleet_cfg=FleetConfig(batch=batch, shard=False),
        supervisor_cfg=sup, fault_plan=plan, clock=clk,
        fault_advance=lambda s: setattr(clk, "t", clk.t + s),
        device="cpu", **kw), clk


def _events(plan):
    return [(e.tick, e.kind.value, e.slot, repr(e.value), e.stall_s)
            for e in plan]


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

def test_fault_plan_deterministic():
    cfg = FaultConfig(seed=3, p_corrupt_input=0.1, p_nan_output=0.1,
                      p_transient=0.1, p_stall=0.05, p_malformed=0.05)
    a = FaultPlan.from_config(cfg, 300, 8)
    b = FaultPlan.from_config(cfg, 300, 8)
    assert [repr(e) for e in a] == [repr(e) for e in b]
    assert len(a) > 0
    assert a.kinds() == set(FaultKind)
    c = FaultPlan.from_config(dataclasses.replace(cfg, seed=4), 300, 8)
    assert [repr(e) for e in a] != [repr(e) for e in c]


def test_fault_plan_prefix_stable():
    """A longer horizon keeps the earlier ticks."""
    cfg = FaultConfig(seed=9, p_nan_output=0.2, p_transient=0.2)
    short = FaultPlan.from_config(cfg, 50, 4)
    long = FaultPlan.from_config(cfg, 100, 4)
    for t in range(50):
        assert ([repr(e) for e in short.events_at(t)]
                == [repr(e) for e in long.events_at(t)])


def test_fault_plan_empty_config_is_clean():
    plan = FaultPlan.from_config(FaultConfig(), 100, 8)
    assert len(plan) == 0
    assert plan.kinds() == set()


@pytest.mark.parametrize("name", sorted(jregistry.FAULT_CONFIGS))
@pytest.mark.parametrize("n_ticks,batch", [(80, 8), (300, 16)])
def test_fault_plan_equals_the_reference(name, n_ticks, batch):
    """Every named config expands to the reference's event list, event
    for event (kind, tick, slot, poison, stall)."""
    want = jfaults.FaultPlan.from_config(jregistry.FAULT_CONFIGS[name],
                                         n_ticks, batch)
    got = FaultPlan.from_config(FAULT_CONFIGS[name], n_ticks, batch)
    assert _events(got) == _events(want)
    assert {k.value for k in got.kinds()} == {k.value for k in want.kinds()}
    assert [got.malformed_at(t) for t in range(n_ticks)] == \
        [want.malformed_at(t) for t in range(n_ticks)]


# ---------------------------------------------------------------------------
# the faults reach the real serving path
# ---------------------------------------------------------------------------

def test_unsupervised_fleet_delivers_injected_nan(setup):
    """Without a supervisor there is no NaN guard: the injected
    non-finite output reaches the client (the control experiment)."""
    _, _, cfg, params = setup
    plan = FaultPlan([FaultEvent(0, FaultKind.NAN_OUTPUT, slot=0)])
    fleet, clk = _fleet(params, cfg, plan=plan)
    rs = _requests(cfg, 2)
    for r in rs:
        fleet.submit(r)
    for _ in range(4):
        clk.t += 0.01
        fleet.step()
    assert fleet.stats()["nan_delivered"] == 1
    bad = [r for r in rs if not np.isfinite(r.result.raw_pred).all()]
    assert len(bad) == 1


def test_corrupt_input_poisons_staged_voxels(setup):
    """CORRUPT_INPUT is silent: the spiking threshold turns the NaN into
    no spikes, so the output stays finite but differs, in the targeted
    slot only."""
    _, _, cfg, params = setup
    plan = FaultPlan([FaultEvent(0, FaultKind.CORRUPT_INPUT, slot=0,
                                 value=float("nan"))])
    fleet, clk = _fleet(params, cfg, plan=plan)
    rs = _requests(cfg, 2)
    for r in rs:
        fleet.submit(r)
    for _ in range(4):
        clk.t += 0.01
        fleet.step()
    clean, cclk = _fleet(params, cfg)
    refs = _requests(cfg, 2)
    for r in refs:
        clean.submit(r)
    for _ in range(4):
        cclk.t += 0.01
        clean.step()
    assert not np.array_equal(rs[0].result.raw_pred, refs[0].result.raw_pred)
    np.testing.assert_array_equal(rs[1].result.raw_pred,
                                  refs[1].result.raw_pred)


def test_stall_fault_advances_serving_clock(setup):
    _, _, cfg, params = setup
    plan = FaultPlan([FaultEvent(0, FaultKind.STALL, stall_s=0.5)])
    fleet, clk = _fleet(params, cfg, plan=plan)
    for r in _requests(cfg, 2):
        fleet.submit(r)
    t0 = clk.t
    for _ in range(4):
        clk.t += 0.01
        fleet.step()
    assert clk.t - t0 == pytest.approx(0.04 + 0.5)


# ---------------------------------------------------------------------------
# malformed requests at the edge
# ---------------------------------------------------------------------------

def test_malformed_submit_fails_without_killing_loop(setup):
    _, _, cfg, params = setup
    fleet, clk = _fleet(params, cfg, sup=SupervisorConfig())
    for v in range(4):
        bad = fleet.submit(make_malformed_request(1000 + v))
        assert bad.status is RequestStatus.FAILED
        assert bad.error
        assert bad.request.result is None
    rs = _requests(cfg, 2)
    done = fleet.run_to_completion(rs)
    assert fleet.stats()["malformed"] == 4
    assert all(r.result is not None for r in rs)
    assert sum(s.status is RequestStatus.DONE for s in done) == 2


def test_malformed_never_counted_delivered(setup):
    _, _, cfg, params = setup
    fleet, clk = _fleet(params, cfg, sup=SupervisorConfig())
    fleet.submit(make_malformed_request(0))
    s = fleet.stats()
    assert s["delivered"] == 0
    assert s["failed"] == 1
    assert s["availability"] == 0.0


def test_malformed_variants_fail_with_the_reference_messages(setup):
    """Each malformed variant fails at the port's edge with the error the
    reference's edge gives it."""
    jcfg, jparams, cfg, params = setup
    fleet, _ = _fleet(params, cfg)
    ref = JaxFleet(jparams, jcfg, mesh=None,
                   fleet_cfg=jbase.FleetConfig(batch=2))
    for rid in range(4):
        got = fleet.submit(make_malformed_request(rid))
        want = ref.submit(jfaults.make_malformed_request(rid))
        assert got.status is RequestStatus.FAILED
        assert got.error == want.error


# ---------------------------------------------------------------------------
# retry / backoff
# ---------------------------------------------------------------------------

def test_transient_fault_retries_then_delivers(setup):
    _, _, cfg, params = setup
    plan = FaultPlan([FaultEvent(0, FaultKind.TRANSIENT_ERROR)])
    sup = SupervisorConfig(max_retries=2, retry_backoff_ms=5.0,
                           retry_jitter_ms=0.0)
    fleet, clk = _fleet(params, cfg, plan=plan, sup=sup)
    for r in _requests(cfg, 2):
        fleet.submit(r)
    done = []
    for _ in range(10):
        clk.t += 0.01
        done.extend(fleet.step())
    s = fleet.stats()
    assert s["retries"] == 2                # both slots of the failed tick
    assert s["delivered"] == 2
    assert s["failed"] == 0
    assert all(r.telemetry.n_retries == 1 for r in done
               if r.status is RequestStatus.DONE)


def test_retry_budget_exhaustion_fails_terminally(setup):
    _, _, cfg, params = setup
    plan = FaultPlan([FaultEvent(t, FaultKind.TRANSIENT_ERROR)
                      for t in range(40)])
    sup = SupervisorConfig(max_retries=2, retry_backoff_ms=1.0,
                           retry_jitter_ms=0.0, breaker_threshold=1000)
    fleet, clk = _fleet(params, cfg, plan=plan, sup=sup)
    for r in _requests(cfg, 2):
        fleet.submit(r)
    done = []
    for _ in range(30):
        clk.t += 0.01
        done.extend(fleet.step())
    failed = [r for r in done if r.status is RequestStatus.FAILED]
    assert len(failed) == 2
    assert all(r.attempts == 3 for r in failed)     # 1 try + 2 retries
    assert all(r.error for r in failed)
    assert fleet.stats()["availability"] == 0.0


def _retry_gates(make_fleet, make_requests, steps=20):
    """(rid, attempts, not_before) of every queued request after each
    step, and the stats, for transient faults at ticks 0 and 2."""
    fleet, clk = make_fleet()
    for r in make_requests():
        fleet.submit(r)
    gates = []
    for _ in range(steps):
        clk.t += 0.01
        fleet.step()
        gates.extend((s.rid, s.attempts, s.not_before)
                     for s in list(fleet.queue._q))
    return gates, fleet.stats()


def test_retry_backoff_deterministic(setup):
    """Two identical fleets on identical fake clocks walk the same retry
    schedule: jitter is keyed on (seed, rid, attempt)."""
    _, _, cfg, params = setup

    def make():
        plan = FaultPlan([FaultEvent(t, FaultKind.TRANSIENT_ERROR)
                          for t in (0, 2)])
        sup = SupervisorConfig(max_retries=3, retry_backoff_ms=4.0,
                               retry_jitter_ms=2.0, retry_seed=5)
        return _fleet(params, cfg, plan=plan, sup=sup)

    g1, s1 = _retry_gates(make, lambda: _requests(cfg, 2))
    g2, s2 = _retry_gates(make, lambda: _requests(cfg, 2))
    assert g1 == g2
    assert s1["retries"] == s2["retries"] > 0
    assert s1["latency_p99_s"] == s2["latency_p99_s"]


def test_retry_jitter_equals_the_reference(setup):
    """The same fault schedule on the JAX FleetEngine and the port's:
    every retry gate (backoff plus seeded jitter) equal, and the same
    retry, delivery and latency accounting."""
    jcfg, jparams, cfg, params = setup
    kw = dict(max_retries=3, retry_backoff_ms=4.0, retry_jitter_ms=2.0,
              retry_seed=5)

    def port():
        plan = FaultPlan([FaultEvent(t, FaultKind.TRANSIENT_ERROR)
                          for t in (0, 2)])
        return _fleet(params, cfg, plan=plan, sup=SupervisorConfig(**kw))

    def ref():
        clk = _FakeClock()
        plan = jfaults.FaultPlan([jfaults.FaultEvent(
            t, jfaults.FaultKind.TRANSIENT_ERROR) for t in (0, 2)])
        return JaxFleet(
            jparams, jcfg, mesh=None,
            fleet_cfg=jbase.FleetConfig(batch=2, shard=False),
            supervisor_cfg=jbase.SupervisorConfig(**kw), fault_plan=plan,
            clock=clk, fault_advance=lambda s: setattr(clk, "t",
                                                       clk.t + s)), clk

    got, gs = _retry_gates(port, lambda: _requests(cfg, 2))
    want, ws = _retry_gates(ref, lambda: _requests(cfg, 2, cls=JaxRequest))
    assert got == want and len(got) > 0
    for k in ("retries", "delivered", "failed", "latency_p50_s",
              "latency_p99_s"):
        assert gs[k] == ws[k], k


def test_retry_preserves_original_enqueue_time(setup):
    """Latency charges the whole retry journey to the request."""
    _, _, cfg, params = setup
    plan = FaultPlan([FaultEvent(0, FaultKind.TRANSIENT_ERROR)])
    sup = SupervisorConfig(max_retries=2, retry_backoff_ms=1.0,
                           retry_jitter_ms=0.0)
    fleet, clk = _fleet(params, cfg, plan=plan, sup=sup)
    rs = _requests(cfg, 2)
    clk.t = 1.0
    for r in rs:
        fleet.submit(r)
    for _ in range(10):
        clk.t += 0.01
        fleet.step()
    for r in rs:
        tel = r.result.telemetry
        assert tel.t_enqueue == 1.0
        assert tel.latency_s > 0.02     # spans the failed tick + retry
