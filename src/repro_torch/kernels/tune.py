"""Shape-keyed launch table: measured launch configs per (op, shape) —
the counterpart of ``repro.kernels.tune`` for the port's kernels.

For each (op, layer shape) a sweep times the launch choices the port's
kernels really take against the layer's own inputs and keeps the winner
in a table.  Two ops have choices.  ``conv_lif``, a whole firing conv
layer, runs either the fused kernel (``spike_conv_lif``, under its gate
and cluster size ``bm``) or the per-op pair
(``spike_conv`` then ``norm_affine_lif``, under the conv's gate).
``backbone_seg``, a planned backbone segment, runs either the
``backbone_segment`` kernel (under the gate "inline" or "none", ``bm``
blocks per batch element) or the per-layer route, each layer through
its own dispatch.  Every other
op resolves to its one default until its kernels take launch choices.
A segment's key carries each layer's shape token (``L0k3s1c64n64d0p0``,
no layer name), so same-shaped segments share one entry.

How a sweep is bounded: the candidates of a shape are ranked by the
roofline estimate (``repro_torch.launch.roofline``, H100 figures), and
only the ``TuneConfig.prune_to`` first (plus the untuned default, always)
are timed: a warm-up call, then the minimum over ``reps`` calls, each
between two ``torch.cuda.synchronize()`` on the card.

Dispatch (``repro_torch.kernels.ops``): the port is eager, so every call
has concrete inputs.  ``dispatch`` resolves a shape key through an
epoch-keyed cache (a dict lookup on a hit; no file access); under
``tuning()`` the first call at an untuned key sweeps on the live
activations, records the winner with its µs and the default's, and bumps
the epoch.

The table a resolve reads: the ``tuning()`` context's > ``set_table``'s
(or ``pinned``'s) > the file named by ``REPRO_TORCH_TUNE_TABLE`` > a
packaged ``tuned_defaults.json`` beside this module, if present > the
untuned defaults.  ``off()`` forces the defaults.  The port keeps its own
chain: it reads none of the JAX package's tables or variables, whose
winners were timed on a TPU.

Versioning: a table carries ``schema`` (file format) and
``kernels_version`` (the kernels its times are valid for).  ``load``
empties a table on either mismatch; the port's ``kernels_version`` is a
string no JAX table (an int there) can match.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import TuneConfig
from repro_torch.configs.registry import get_tune_config
from repro_torch.kernels.backbone_fuse import spec_from_token
from repro_torch.kernels.backbone_segment import plan_clusters, segment_plan
from repro_torch.kernels.blocks import DEFAULT_BK, DEFAULT_BM, DEFAULT_BN
from repro_torch.kernels.spike_conv import conv_tiles
from repro_torch.kernels.spike_conv_lif import (CLUSTERS, TILE_N,
                                                channel_tile, conv_lif_plan)
from repro_torch.launch.roofline import SMS, kernel_launch_estimate

TUNE_SCHEMA_VERSION = 1
# the port's kernels: bump when their numerics, launch semantics or
# speed change (a table's winners were timed on them)
KERNELS_VERSION = "h100-5"
ENV_VAR = "REPRO_TORCH_TUNE_TABLE"
DEFAULT_TABLE_PATH = os.path.join(os.path.dirname(__file__),
                                  "tuned_defaults.json")


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """One launch decision: tile shapes, gate mode, fusion variant.  For
    the fused ``conv_lif`` kernel ``bm`` is its cluster size (its plan
    sets the channel tile; a table entry whose ``bm`` is no cluster that
    holds the slab resolves to the plan's); for the ``backbone_segment``
    kernel ``bm`` is its blocks per batch element (the cluster size; its
    ``segment_plan`` sets the rest, and an entry whose ``bm`` the plan
    refuses resolves to the plan's)."""
    bm: int = DEFAULT_BM
    bn: int = DEFAULT_BN
    bk: int = DEFAULT_BK
    gate: str = "mask"              # "mask" | "inline" | "none"
    fused: bool = False


# What ``off()`` and an untuned key resolve to: the per-op composition,
# so fusion is a measured choice, never a silent default.
_OP_DEFAULTS: Dict[str, LaunchConfig] = {
    "conv_lif": LaunchConfig(fused=False),
    "backbone_seg": LaunchConfig(fused=False),
}


def default_config(op: str) -> LaunchConfig:
    return _OP_DEFAULTS.get(op, LaunchConfig())


def _fused_cluster(key: str, cfg: LaunchConfig) -> LaunchConfig:
    """A fused ``conv_lif`` or ``backbone_seg`` entry with its ``bm``
    made a cluster size its kernel's plan accepts at the key's shape:
    the plan's where the entry's is none (an entry recorded without one
    holds ``DEFAULT_BM``).  Other entries, and shapes no cluster holds,
    are left as they are."""
    try:
        op, d = parse_key(key)
        if op == "conv_lif":
            shape = tuple(int(d[k]) for k in ("T", "B", "HW", "N", "K"))
            plan = functools.partial(conv_lif_plan, *shape)
        elif op == "backbone_seg":
            plan = functools.partial(segment_plan, segment_specs(d), d["T"],
                                     d["B"], d["H"], d["W"])
        else:
            return cfg
    except (KeyError, ValueError):
        return cfg
    for cluster in ((cfg.bm,) if cfg.bm in CLUSTERS else ()) + (None,):
        try:
            return dataclasses.replace(cfg, bm=plan(cluster=cluster).cluster)
        except ValueError:
            continue
    return cfg


def segment_specs(dims: Dict) -> Tuple:
    """The anonymous ``LayerSpec``s of a ``backbone_seg`` key's segment
    (its ``L<i>`` tokens, in order)."""
    n = sum(1 for k in dims if re.fullmatch(r"L\d+", k))
    return tuple(spec_from_token(dims[f"L{i}"]) for i in range(n))


def shape_key(op: str, **dims) -> str:
    """Stable table key, e.g. ``"conv_lif|B2,HW1024,K18,N8,T3"`` (the
    reference's format)."""
    return op + "|" + ",".join(f"{k}{v}" for k, v in sorted(dims.items()))


_TOKEN_DIM = re.compile(r"([A-Z]+\d*)([a-z].*)")
_INT_DIM = re.compile(r"([A-Za-z]+)(\d+)")


def parse_key(key: str) -> Tuple[str, Dict[str, Union[int, str]]]:
    """The (op, dims) of a ``shape_key``: integer dims (``HW1024``), and
    layer tokens (``L0k3s1c64n64d0p0`` -> ``L0``: ``"k3s1c64n64d0p0"``)."""
    op, _, rest = key.partition("|")
    dims: Dict[str, Union[int, str]] = {}
    for part in rest.split(",") if rest else ():
        m = _TOKEN_DIM.fullmatch(part)
        if m is not None:
            dims[m.group(1)] = m.group(2)
            continue
        m = _INT_DIM.fullmatch(part)
        if m is None:
            raise ValueError(f"bad dim {part!r} in key {key!r}")
        dims[m.group(1)] = int(m.group(2))
    return op, dims


class TuningTable:
    """key -> winning LaunchConfig, with its measured µs and the untuned
    default's µs, so each entry records its own speedup."""

    def __init__(self, entries: Optional[Dict[str, Dict]] = None):
        self.entries: Dict[str, Dict] = dict(entries or {})

    def config_for(self, key: str) -> Optional[LaunchConfig]:
        e = self.entries.get(key)
        if e is None:
            return None
        cfg = LaunchConfig(bm=int(e["bm"]), bn=int(e["bn"]),
                           bk=int(e["bk"]), gate=str(e["gate"]),
                           fused=bool(e["fused"]))
        return _fused_cluster(key, cfg) if cfg.fused else cfg

    def record(self, key: str, cfg: LaunchConfig, us: float,
               default_us: float) -> None:
        self.entries[key] = dict(dataclasses.asdict(cfg), us=round(us, 3),
                                 default_us=round(default_us, 3))

    def to_json(self) -> Dict:
        return {"schema": TUNE_SCHEMA_VERSION,
                "kernels_version": KERNELS_VERSION,
                "entries": self.entries}

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        """Load a table; a schema or kernels_version mismatch empties it
        wholesale."""
        with open(path) as f:
            data = json.load(f)
        if (data.get("schema") != TUNE_SCHEMA_VERSION
                or data.get("kernels_version") != KERNELS_VERSION):
            return cls()
        return cls(data.get("entries", {}))


# ---------------------------------------------------------------------------
# The active table (module state; every change bumps the epoch, so the
# resolve cache never serves an entry of a table no longer active)
# ---------------------------------------------------------------------------

_UNSET = object()                   # fall through to the env/packaged chain
_OFF = object()                     # force the untuned defaults
_explicit = _UNSET
_epoch = 0


@dataclasses.dataclass
class _TuneContext:
    table: TuningTable
    cfg: TuneConfig


_tune_ctx: Optional[_TuneContext] = None
_FILE_CACHE: Dict[str, tuple] = {}  # path -> (mtime, TuningTable)


def _bump_epoch() -> None:
    global _epoch
    _epoch += 1


def _load_table_file(path: str) -> Optional[TuningTable]:
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    hit = _FILE_CACHE.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    try:
        table = TuningTable.load(path)
    except (OSError, ValueError, KeyError, AttributeError):
        return None
    _FILE_CACHE[path] = (mtime, table)
    return table


def active_table() -> Optional[TuningTable]:
    """The table a resolve reads now, or None for the untuned defaults."""
    if _tune_ctx is not None:
        return _tune_ctx.table
    if _explicit is _OFF:
        return None
    if _explicit is not _UNSET:
        return _explicit
    env = os.environ.get(ENV_VAR)
    if env:
        return _load_table_file(env)
    return _load_table_file(DEFAULT_TABLE_PATH)


def chain_is_untuned() -> bool:
    """True when no ``tuning``, ``set_table``, ``pinned`` or ``off``
    holds: resolves read the env/packaged chain."""
    return _tune_ctx is None and _explicit is _UNSET


def set_table(table: Optional[TuningTable]) -> None:
    """Install ``table`` as the active table (``None``: back to the
    env/packaged chain).  The next resolve reads it.  An engine built
    before keeps its own snapshot."""
    global _explicit
    _explicit = table if table is not None else _UNSET
    _bump_epoch()


def reset() -> None:
    """Drop every ``set_table`` and tuning context: the untuned chain."""
    global _explicit, _tune_ctx
    _explicit, _tune_ctx = _UNSET, None
    _bump_epoch()


@contextlib.contextmanager
def _holding(explicit, ctx):
    global _explicit, _tune_ctx
    prev, prev_ctx = _explicit, _tune_ctx
    _explicit, _tune_ctx = explicit, ctx
    _bump_epoch()
    try:
        yield
    finally:
        _explicit, _tune_ctx = prev, prev_ctx
        _bump_epoch()


def off():
    """Force the untuned defaults for the block."""
    return _holding(_OFF, None)


@contextlib.contextmanager
def pinned(table: Optional[TuningTable]):
    """Resolve through ``table`` for the block, whatever else is set
    (``None``: change nothing).  The engine runs each tick pinned to the
    snapshot it took at construction."""
    if table is None:
        yield
        return
    with _holding(table, None):
        yield


@contextlib.contextmanager
def tuning(table: Optional[TuningTable] = None,
           tune_cfg: Optional[TuneConfig] = None):
    """Sweep on first dispatch: while active, the first call of an op at
    a key not yet in ``table`` times the candidates on that call's
    inputs and records the winner.  Yields the table (save it to keep
    it).  ``tune_cfg`` defaults to ``TUNE_CONFIGS["default"]``."""
    global _tune_ctx
    t = table if table is not None else TuningTable()
    prev = _tune_ctx
    _tune_ctx = _TuneContext(t, tune_cfg or get_tune_config("default"))
    _bump_epoch()
    try:
        yield t
    finally:
        _tune_ctx = prev
        _bump_epoch()


def tuning_active() -> bool:
    return _tune_ctx is not None


def resolve(op: str, key: str) -> LaunchConfig:
    return _resolve_cached(op, key, _epoch)


@functools.lru_cache(maxsize=4096)
def _resolve_cached(op: str, key: str, epoch: int) -> LaunchConfig:
    table = active_table()
    cfg = table.config_for(key) if table is not None else None
    return cfg if cfg is not None else default_config(op)


# ---------------------------------------------------------------------------
# Candidates and their estimate
# ---------------------------------------------------------------------------

_CONV_GATES = ("mask", "inline", "none")
# the fused kernel's cluster sizes tried per gate beside its plan's: twice
# and half it, where the slab fits
_FUSED_CLUSTER_SCALES = (2, 0.5)


_SEG_GATES = ("inline", "none")


def _fused_plans(dims: Dict):
    """The fused kernel's plans at a ``conv_lif`` key: its default, and
    the other cluster sizes of ``_FUSED_CLUSTER_SCALES`` that hold the
    slab; none where no cluster does."""
    shape = (dims["T"], dims["B"], dims["HW"], dims["N"], dims["K"])
    try:
        p = conv_lif_plan(*shape)
    except ValueError:
        return []
    out = [p]
    for f in _FUSED_CLUSTER_SCALES:
        c = int(p.cluster * f)
        try:
            q = conv_lif_plan(*shape, cluster=c)
        except ValueError:
            continue
        if q not in out:
            out.append(q)
    return out


def candidates(op: str, dims: Dict, tune_cfg: TuneConfig) -> List[LaunchConfig]:
    """The launch configs the port's kernels take at (op, shape): never
    one that cannot launch there.  Capped at ``max_candidates``."""
    out: List[LaunchConfig] = []
    if op == "backbone_seg":
        # the kernel under both gates (no "mask": interior patch matrices
        # never exist outside it) at each cluster size its plan accepts
        # (the plan's, twice and half it), then the per-layer route
        try:
            specs = segment_specs(dims)
        except ValueError:
            specs = ()
        clusters = (plan_clusters(specs, dims["T"], dims["B"], dims["H"],
                                  dims["W"]) if specs else ())
        for gate in _SEG_GATES:
            for cs in clusters:
                out.append(LaunchConfig(bm=cs, gate=gate, fused=True))
        out.append(LaunchConfig(fused=False))
    elif op == "conv_lif":
        plans = _fused_plans(dims)
        for gate in _CONV_GATES:
            for p in plans:
                out.append(LaunchConfig(bm=p.cluster, gate=gate,
                                        fused=True))
        for gate in _CONV_GATES:
            out.append(LaunchConfig(gate=gate, fused=False))
    else:
        out.append(default_config(op))
    return out[:tune_cfg.max_candidates]


def _segment_estimate(dims: Dict, cfg: LaunchConfig, live: float) -> float:
    """A segment: the kernel crosses device memory once, at the segment's
    edges (``E``), in one launch; its time is its busiest block's conv
    tiles (``SegmentPlan.block_macs``: pad rows and idle tile columns
    included) at one SM's share of the peak, once per wave of clusters.
    The per-layer route round-trips each layer's conv output (``A``:
    written, copied, read three times by the epilogue, its spikes
    written and read) in ``U`` device operations."""
    frac = live if cfg.gate != "none" else 1.0
    if cfg.fused:
        p = segment_plan(segment_specs(dims), dims["T"], dims["B"],
                         dims["H"], dims["W"], cluster=cfg.bm)
        macs = sum(p.block_macs(l) for l in range(len(p.layers)))
        waves = math.ceil(p.blocks / SMS)
        flops = 2.0 * macs * frac * SMS * waves
        return kernel_launch_estimate(flops, 4.0 * dims["E"], 1)
    flops = 2.0 * dims["F"] * live
    return kernel_launch_estimate(flops, 4.0 * (dims["E"] + 7 * dims["A"]),
                                  dims["U"])


def estimate(op: str, dims: Dict, cfg: LaunchConfig,
             live: float = 1.0, taps: int = 9) -> float:
    """Roofline estimate (seconds) used to RANK candidates; ``live`` is
    the live-activation fraction of the inputs, which the gates skip;
    ``taps`` the conv's kh*kw (the key holds only K = kh*kw*C, so a
    dispatch passes it; a 3x3 conv when not given)."""
    if op == "backbone_seg":
        return _segment_estimate(dims, cfg, live)
    if op != "conv_lif":
        return kernel_launch_estimate(0.0, 0.0, 1)
    B, M = dims["B"], dims["B"] * dims["T"] * dims["HW"]
    K, N = dims["K"], dims["N"]
    frac = live if cfg.gate != "none" else 1.0
    flops = 2.0 * M * K * N * frac
    if cfg.fused:
        # one launch: the kernel reads the activation (about M*C, once
        # per channel tile; each tap's re-read comes from L2) and the
        # weights and writes the spikes once; its GEMM computes 32
        # columns a tile, and B * tiles * cluster blocks may leave SMs
        # idle
        tiles = math.ceil(N / channel_tile(N))
        flops *= tiles * TILE_N / N * max(1.0, SMS / (B * tiles * cfg.bm))
        nbytes = 4.0 * (M * K / taps * tiles + K * N + M * N)
        launches = 1
    else:
        # the conv kernel reads the activation (about M*C: each tap's
        # re-read comes from L2, as does the "mask" gate's check) and
        # the weights; its output is written, copied to
        # [T, B, HW, N] and read three times by the epilogue; under
        # split-K its partials cross memory once more.  Three host
        # launches: the conv (its split-K reduce is launched inside
        # it), the copy, the epilogue.
        t = conv_tiles(M, K, N)
        partials = 2 * t.kblocks * M * N if t.split else 0
        nbytes = 4.0 * (M * K / taps + K * N + 7 * M * N + partials)
        launches = 3
    return kernel_launch_estimate(flops, nbytes, launches)


# ---------------------------------------------------------------------------
# Measurement and the sweep
# ---------------------------------------------------------------------------

def _wait(out) -> None:
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def measure(runner: Callable[[LaunchConfig], object], cfg: LaunchConfig,
            reps: int) -> float:
    """Minimum over ``reps`` calls of ``runner(cfg)`` (µs), after one
    warm-up call; on the card each call is timed from an idle device to
    its result (host launch cost included).  A candidate that raises is
    a fault, not a loser: the error propagates.  The calls run under
    ``torch.no_grad()``: a sweep inside a train step records nothing in
    its graph."""
    with torch.no_grad():
        _wait(runner(cfg))
        best = float("inf")
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            _wait(runner(cfg))
            best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _sweep(op: str, dims: Dict[str, int],
           runner: Callable[[LaunchConfig], object], tune_cfg: TuneConfig,
           live: float, taps: int):
    ranked = sorted(candidates(op, dims, tune_cfg),
                    key=lambda c: estimate(op, dims, c, live, taps))
    short = ranked[:max(1, tune_cfg.prune_to)]
    dflt = default_config(op)
    if dflt not in short:
        short.append(dflt)          # the baseline is always measured
    best_cfg, best_us, default_us = dflt, float("inf"), float("inf")
    for c in short:
        us = measure(runner, c, tune_cfg.reps)
        if c == dflt:
            default_us = us
        if us < best_us:
            best_cfg, best_us = c, us
    return best_cfg, best_us, default_us


def dispatch(op: str, dims: Dict[str, int],
             runner: Optional[Callable[[LaunchConfig], object]] = None, *,
             live: float = 1.0, taps: int = 9) -> LaunchConfig:
    """The launch config of (op, shape).  Under ``tuning()``, with a
    ``runner`` and an untuned key, sweep on the caller's inputs first
    (ranked by ``estimate`` at ``live`` and ``taps``) and record the
    winner."""
    key = shape_key(op, **dims)
    ctx = _tune_ctx
    if (ctx is not None and runner is not None
            and key not in ctx.table.entries):
        cfg, us, default_us = _sweep(op, dims, runner, ctx.cfg, live, taps)
        ctx.table.record(key, cfg, us, default_us)
        _bump_epoch()               # the resolve cache must see the entry
        return cfg
    return resolve(op, key)
