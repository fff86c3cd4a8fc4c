"""Profile the serving tick on the card: where a tick's time goes.

    python -m repro_torch.profile_tick [--arch spiking_yolo] [--ticks 20]
        [--batch 8] [--backend cuda] [--enc-backend torch|cuda]
        [--isp-backend torch|cuda|cuda_fused]
        [--tune-table PATH | --sweep-to PATH] [--segments]

Serves one of the paper's four backbones at full width (``--arch``, a
name of ``SNN_ARCHS``: spiking_yolo, spiking_vgg, spiking_mobilenet or
spiking_densenet; seeded random weights, random voxel windows and Bayer
frames) through ``CognitiveEngine`` — the SNN layers
on ``--backend``, the event encoding on ``--enc-backend`` and the ISP on
``--isp-backend`` (``cuda`` for all three is the all-kernel tick;
``cuda_fused`` runs the ISP as the fusion plan's segment kernels) — and
records ``--ticks`` ticks under ``torch.profiler`` after three warm-up
ticks.  ``--tune-table`` loads a launch table (``TuningTable.save``'s
JSON) that the engine snapshots; ``--sweep-to`` first sweeps one on the
tick's own voxels (one eager ``npu_forward`` under ``tune.tuning``, the
"smoke" policy), saves it there and profiles with it; with neither the
engine takes the active chain (``REPRO_TORCH_TUNE_TABLE``, else the
untuned per-op route).  ``--segments`` adds to that table (or to an
empty one) an entry per fused-route backbone segment of the arch that
sends it to the ``backbone_segment`` kernel: the forced-segment tick.
A table's ``backbone_seg`` entries serve as its ``conv_lif`` ones do.
Prints, per tick: the host wall time, the host time inside each stage
span (``tick.upload``/``encode``/``npu``/``isp``/``fetch``, set by
``EngineCore``), the device busy time (the sum of kernel and copy times)
and so the device's idle share, the number of device operations, and the
kernels that take the most device time.  The last line is one JSON
object with those numbers and every device op's count a tick, by name
(so a forced-segment tick shows one ``backbone_segment`` op per
segment).  Needs a CUDA device; it never falls back to
the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from repro_torch.configs.registry import (ENCODING_CONFIGS, ISP_CONFIGS,
                                         SNN_ARCHS, get_tune_config)
from repro_torch.core.backbones import fused_route_segments
from repro_torch.core.npu import init_npu, npu_forward
from repro_torch.kernels import tune
from repro_torch.kernels.ops import fused_segment_table
from repro_torch.serve.cognitive_engine import (CognitiveEngine,
                                                PerceptionRequest)

STAGES = ("tick.upload", "tick.encode", "tick.npu", "tick.isp", "tick.fetch")
# backend name -> the named config that runs on it
ISP_BY_BACKEND = {"torch": "default", "cuda": "cuda", "cuda_fused": "fused"}
ENC_BY_BACKEND = {"torch": "paper_binary", "cuda": "cuda"}


def _requests(cfg, batch, rng):
    out = []
    for i in range(batch):
        vox = (rng.random((cfg.time_steps, cfg.height, cfg.width, 2))
               < 0.05).astype(np.float32)
        bayer = rng.uniform(0.05, 0.95, (cfg.height, cfg.width)).astype(
            np.float32)
        out.append(PerceptionRequest(rid=i, voxels=vox, bayer=bayer))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="spiking_yolo",
                    choices=sorted(SNN_ARCHS))
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"))
    ap.add_argument("--enc-backend", default="torch", choices=("cuda", "torch"))
    ap.add_argument("--isp-backend", default="torch",
                    choices=tuple(ISP_BY_BACKEND))
    ap.add_argument("--seed", type=int, default=0)
    tables = ap.add_mutually_exclusive_group()
    tables.add_argument("--tune-table", default=None,
                        help="launch table JSON for the engine to snapshot")
    tables.add_argument("--sweep-to", default=None,
                        help="sweep a launch table on the tick's voxels, "
                             "save it here and serve with it")
    ap.add_argument("--segments", action="store_true",
                    help="route every fused-route backbone segment to the "
                         "backbone_segment kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_tick: needs a CUDA device")
    table = None
    if args.tune_table is not None:
        table = tune.TuningTable.load(args.tune_table)
        if not table.entries:
            raise SystemExit(f"profile_tick: {args.tune_table} holds no "
                             f"entry for these kernels (empty, or another "
                             f"schema/kernels_version)")

    cfg = dataclasses.replace(SNN_ARCHS[args.arch], backend=args.backend)
    params = init_npu(torch.Generator().manual_seed(args.seed), cfg)
    reqs = _requests(cfg, args.batch, np.random.default_rng(args.seed))
    if args.sweep_to is not None:
        vox = torch.tensor(np.stack([r.voxels for r in reqs], axis=1),
                           device="cuda")
        with tune.tuning(tune.TuningTable(),
                         get_tune_config("smoke")) as table:
            npu_forward(params, vox, cfg)
        table.save(args.sweep_to)
        fused = sorted(k for k, e in table.entries.items() if e["fused"])
        print(f"swept {len(table.entries)} shapes into {args.sweep_to}; "
              f"fused at {fused}")
    if args.segments:
        keys = [k for _, _, k in fused_route_segments(cfg, args.batch)]
        if not keys:
            raise SystemExit(f"profile_tick: {args.arch} has no fused-route "
                             f"segment")
        forced = fused_segment_table(keys)
        if table is not None:
            forced.entries = dict(table.entries, **forced.entries)
        table = forced
        print(f"forced {len(keys)} backbone segments onto the kernel")
    with tune.pinned(table):             # the engine snapshots it
        eng = CognitiveEngine(
            params, cfg, batch=args.batch,
            isp_cfg=ISP_CONFIGS[ISP_BY_BACKEND[args.isp_backend]],
            enc_cfg=ENCODING_CONFIGS[ENC_BY_BACKEND[args.enc_backend]])

    def tick():
        for r in reqs:
            eng.submit(dataclasses.replace(r, result=None))
        eng.tick()
        return eng.last_tick_s

    for _ in range(3):
        tick()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        walls = [tick() for _ in range(args.ticks)]
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0

    events = prof.events()
    n = args.ticks
    spans = {s: sum(e.cpu_time_total for e in events if e.name == s) / n
             / 1e3 for s in STAGES}
    # device-side events, less the stage spans' own GPU annotations
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name not in STAGES]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / n / 1e3
    # the same device time, as the kernels attributed to host operations
    attributed_ms = sum(k.duration for e in events for k in e.kernels) / n / 1e3
    by_name, count = {}, {}
    for e in dev:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / n / 1e3)
        count[e.name] = count.get(e.name, 0) + 1 / n
    wall_ms = total_s / n * 1e3
    print(f"{args.arch}, backend {args.backend} (encoding "
          f"{args.enc_backend}, ISP {args.isp_backend}), batch "
          f"{args.batch}, {n} ticks, {torch.cuda.get_device_name(0)}")
    print(f"tick wall p50 {statistics.median(walls) * 1e3:.3f} ms; "
          f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"({len(dev) / n:.0f} device ops per tick; {attributed_ms:.3f} ms "
          f"attributed to host ops)")
    for s, ms in spans.items():
        print(f"  host span {s:12s} {ms:8.3f} ms")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    for name, ms in top:
        print(f"  device {ms:8.4f} ms  {name[:90]}")
    print(json.dumps({
        "arch": args.arch, "backend": args.backend,
        "tune_table": args.tune_table or args.sweep_to,
        "segments": args.segments,
        "enc_backend": args.enc_backend, "isp_backend": args.isp_backend,
        "batch": args.batch, "ticks": n,
        "device": torch.cuda.get_device_name(0),
        "tick_wall_p50_ms": statistics.median(walls) * 1e3,
        "wall_ms_per_tick": wall_ms, "device_busy_ms_per_tick": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_attributed_ms_per_tick": attributed_ms,
        "device_ops_per_tick": len(dev) / n, "host_span_ms": spans,
        "top_device_ms": dict(top[:8]),
        "device_ops_by_name": {name[:100]: c for name, c in sorted(
            count.items(), key=lambda kv: -kv[1])}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
