"""The port's sharded FleetEngine on the CPU: the three checks of the
reference's ``tests/_fleet_main.py`` on a serving mesh of 8
``torch.device("cpu")`` entries (the stand-in for the reference's 8
forced host devices) at ``reduced_snn("spiking_yolo")``, held request by
request within 1e-5 of the one-device ``CognitiveEngine``:

- the voxel path (two full sharded ticks), with telemetry timestamps in
  order and ``n_devices == 8``;
- the raw-event path;
- a trailing partial tick (``BATCH + 3`` requests): its unfilled slots
  ride as inert lanes of their shards;

then the mesh's wiring (reference ``tests/test_fleet.py:254-264``): a
batch the mesh does not divide raises, an explicit one-entry mesh
serves, ``mesh="auto"`` with ``shard=False`` (or on the CPU) is one
device, and every ladder rung builds its core on the mesh.  The kernel
wrappers' one launch path enters the tensors' device
(``kernels/build.py`` ``launch``), shown with ``torch.cuda.device``
replaced by a recorder.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import FleetConfig, SupervisorConfig
from repro_torch.configs.registry import reduced_snn
from repro_torch.core.encoding import EventStream, voxel_batch
from repro_torch.core.npu import init_npu
from repro_torch.data.synthetic import make_scene_batch, stream_generator
from repro_torch.distributed.sharding import local_mesh
from repro_torch.kernels import build
from repro_torch.serve.cognitive_engine import (CognitiveEngine,
                                                PerceptionRequest)
from repro_torch.serve.fleet import FleetEngine
from repro_torch.serve.scheduler import RequestStatus
from repro_torch.serve.transport import ShardedBank

BATCH = 8
ATOL = 1e-5
CPU = torch.device("cpu")
KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "kernels"


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_snn("spiking_yolo")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, params


def _payloads(cfg, n, seed):
    scene = make_scene_batch(stream_generator(seed, 0), batch=n,
                             height=cfg.height, width=cfg.width,
                             time_steps=cfg.time_steps, n_events=2048,
                             device="cpu")
    vox = voxel_batch(scene.events, time_steps=cfg.time_steps,
                      height=cfg.height, width=cfg.width).numpy()
    events = EventStream(*(np.asarray(a) for a in scene.events))
    return vox, events, scene.bayer.numpy()


def _voxel_requests(cfg, n, seed):
    vox, _, bayer = _payloads(cfg, n, seed)
    return [PerceptionRequest(rid=i, voxels=vox[:, i], bayer=bayer[i])
            for i in range(n)]


def _event_requests(cfg, n, seed):
    _, ev, bayer = _payloads(cfg, n, seed)
    return [PerceptionRequest(rid=i, events=EventStream(*(a[i] for a in ev)),
                              bayer=bayer[i]) for i in range(n)]


def _fleet(params, cfg, mesh, batch=BATCH, **kw):
    return FleetEngine(params, cfg, mesh=mesh, device="cpu",
                       fleet_cfg=FleetConfig(batch=batch, max_queue=64), **kw)


def _reference(params, cfg, reqs):
    eng = CognitiveEngine(params, cfg, batch=BATCH, device="cpu")
    eng.run_to_completion(reqs)
    return reqs


def _hold(done, ref, n):
    assert len(done) == n
    assert all(s.status is RequestStatus.DONE for s in done)
    for s, r in zip(sorted(done, key=lambda s: s.rid), ref):
        assert s.rid == r.rid
        got, want = s.request.result, r.result
        for f in ("rgb", "control", "raw_pred"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       atol=ATOL, err_msg=f)
        for st, ps in want.stage_params.items():
            for k, v in ps.items():
                np.testing.assert_allclose(got.stage_params[st][k], v,
                                           atol=ATOL)


def test_sharded_matches_single_device(setup):
    """The voxel path over 8 shards of one slot each, two full ticks."""
    cfg, params = setup
    n = 2 * BATCH
    fleet = _fleet(params, cfg, local_mesh([CPU] * 8))
    assert fleet.core.n_devices == 8
    assert fleet.stats()["n_devices"] == 8
    assert all(isinstance(b, ShardedBank) and len(b.shards) == 8
               for b in fleet.buffers.banks)
    done = fleet.run_to_completion(_voxel_requests(cfg, n, 0))
    _hold(done, _reference(params, cfg, _voxel_requests(cfg, n, 0)), n)
    assert fleet.ticks == 2
    for s in done:
        tel = s.request.result.telemetry
        assert (tel.t_enqueue <= tel.t_admit <= tel.t_dispatch
                <= tel.t_deliver)


def test_sharded_event_path(setup):
    """Raw-event requests ride the sharded tick (each shard's event
    FIFOs go up with its rows)."""
    cfg, params = setup
    fleet = _fleet(params, cfg, local_mesh([CPU] * 8))
    done = fleet.run_to_completion(_event_requests(cfg, BATCH, 3))
    _hold(done, _reference(params, cfg, _event_requests(cfg, BATCH, 3)),
          BATCH)


def test_uneven_final_tick(setup):
    """A trailing partial tick (3 of 8 slots) still shards: the unfilled
    slots ride as inert lanes of their shards."""
    cfg, params = setup
    n = BATCH + 3
    fleet = _fleet(params, cfg, local_mesh([CPU] * 8))
    done = fleet.run_to_completion(_voxel_requests(cfg, n, 7))
    _hold(done, _reference(params, cfg, _voxel_requests(cfg, n, 7)), n)
    assert fleet.ticks == 2


def test_sharded_telemetry_is_the_batch_mean(setup):
    """On a two-shard mesh the batch-reduced scalars (sparsity,
    tile_skip, per-layer rates) are the one-device tick's."""
    cfg, params = setup
    reqs = _voxel_requests(cfg, BATCH, 5)
    fleet = _fleet(params, cfg, local_mesh([CPU] * 2),
                   collect_sparsity=True)
    one = _fleet(params, cfg, None, collect_sparsity=True)
    bank, bank1 = fleet._bank(), one._bank()
    for i, r in enumerate(reqs):
        bank.stage_voxels(i, r.voxels, r.bayer)
        bank1.stage_voxels(i, r.voxels, r.bayer)
    (got, rgb, _), (want, rgb1, _) = fleet.core.tick(bank), \
        one.core.tick(bank1)
    np.testing.assert_allclose(rgb, rgb1, atol=ATOL)
    np.testing.assert_allclose(got.sparsity, want.sparsity, atol=1e-6)
    np.testing.assert_allclose(got.tile_skip, want.tile_skip, atol=1e-6)
    assert got.layer_rates.keys() == want.layer_rates.keys()
    for k, v in want.layer_rates.items():
        np.testing.assert_allclose(got.layer_rates[k], v, atol=1e-6)


def test_batch_not_divisible_by_mesh_raises(setup):
    cfg, params = setup
    with pytest.raises(ValueError, match="not divisible"):
        _fleet(params, cfg, local_mesh([CPU] * 4), batch=6)


def test_explicit_one_entry_mesh_serves(setup):
    """Reference ``tests/test_fleet.py:254-264``: one entry always
    divides; the explicit mesh is wired through."""
    cfg, params = setup
    mesh = local_mesh([CPU])
    fleet = _fleet(params, cfg, mesh, batch=2)
    assert fleet.mesh is mesh and fleet.core.n_devices == 1
    assert len(fleet.run_to_completion(_voxel_requests(cfg, 2, 1))) == 2


@pytest.mark.parametrize("shard", [False, True])
def test_auto_mesh_without_cards_is_one_device(setup, shard):
    """``mesh="auto"`` with ``shard=False``, or on the CPU, is the local
    path."""
    cfg, params = setup
    fleet = FleetEngine(params, cfg, device="cpu", fleet_cfg=FleetConfig(
        batch=2, max_queue=4, shard=shard))
    assert fleet.mesh is None and fleet.core.n_devices == 1


def test_mesh_refusals(setup):
    cfg, params = setup
    with pytest.raises(ValueError, match="one \\('data',\\) axis"):
        _fleet(params, cfg, local_mesh([CPU] * 2, ("model",)))
    with pytest.raises(ValueError, match="not on device"):
        FleetEngine(params, cfg, mesh=local_mesh([CPU] * 2),
                    fleet_cfg=FleetConfig(batch=2), device="meta")
    with pytest.raises(ValueError, match="'auto', None or a Mesh"):
        _fleet(params, cfg, "data")


def test_ladder_rungs_share_the_mesh(setup):
    """Every supervised rung's core shards over the same mesh."""
    cfg, params = setup
    cfg = dataclasses.replace(cfg, backend="cuda")
    fleet = _fleet(params, cfg, local_mesh([CPU] * 2),
                   supervisor_cfg=SupervisorConfig())
    assert fleet.ladder_names == ["cuda_fused", "cuda", "torch"]
    assert [c.n_devices for c in fleet.cores] == [2, 2, 2]
    done = fleet.run_to_completion(_voxel_requests(cfg, 4, 2))
    assert [s.status for s in done] == [RequestStatus.DONE] * 4


def test_launch_enters_the_tensors_device(monkeypatch):
    """``build.launch`` calls the C launch function under
    ``torch.cuda.device(<the tensors' device>)`` with that device's
    current stream last, then counts the launch."""
    entered, calls = [], []

    class Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(("enter", self.dev))

        def __exit__(self, *exc):
            entered.append(("exit", self.dev))
            return False

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 1000 + dev.index

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    dev = torch.device("cuda", 1)

    def fn(*args):
        calls.append((args, list(entered)))
        return 0

    build.reset_launches()
    build.launch("probe", dev, fn, 7, 8)
    assert calls == [((7, 8, 1001), [("enter", dev)])]
    assert entered == [("enter", dev), ("exit", dev)]
    assert build.LAUNCHES["probe"] == 1
    with pytest.raises(RuntimeError, match="probe failed to launch"):
        build.launch("probe", dev, lambda *a: 3)
    build.reset_launches()


def test_every_wrapper_launches_through_the_one_helper():
    """No kernel wrapper enters a device or reads a stream itself: each
    launch goes through ``build.launch``."""
    wrappers = sorted(p for p in KERNELS.glob("*.py") if p.name != "build.py")
    launching = []
    for p in wrappers:
        text = p.read_text()
        assert "torch.cuda.device(" not in text, p
        assert "stream_of" not in text, p
        if re.search(r"\bload\(\"", text):
            launching.append(p.stem)
            assert re.search(r"^\s+launch\(\"", text, re.M), p
    assert len(launching) == 12, launching
