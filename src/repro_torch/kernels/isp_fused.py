"""The fused ISP segments: the wrappers of their two CUDA kernels
(``csrc/isp_fused.cu``) and their plain versions.

The fusion planner (:mod:`repro_torch.isp.fuse`) cuts a stage ordering
into segments; each segment is one pass over the frame:

  * ``pointwise_segment``: a run of pointwise stages (plus an optional
    leading reduce-stage apply) on every pixel;
  * ``stencil_segment``: the same pointwise run as the prologue of a
    stencil stage, recomputed on the halo of each output tile (a few
    redundant halo pixels instead of a materialised intermediate), then
    the stage's window op.

Stage parameters come as one packed [B, P] float32 tensor (``pvec``, one
row per frame, laid out by the planner), the reduce stage's global
statistics as [B, w] (``stats``) and the array constants of the fused
forms as a tuple (``consts``): all device tensors, so one kernel serves
every control vector without a host sync.  The gamma stage's per-frame
LUT is built by each block of either kernel from its frame's gamma, with
``gamma_lut``'s ops, so a call is one device op.  The halo
replays each stage's reference: ``pad="wrap"`` for cyclic-roll references,
``pad="zero"`` for SAME-padded ones, with the zero halo set after the
prologue, as the per-stage path pads the prologue's output.

The plain versions ``pointwise_segment_torch`` and
``stencil_segment_torch`` walk the frame in ``(bh, bw)`` tiles like the
TPU kernels (``block`` sizes are theirs only) and call each stage's own
torch form.  The wrappers take them for CPU tensors; for CUDA tensors
they launch the kernels or raise.  A CUDA kernel cannot call a Python
function, so it interprets a descriptor: one op code (``DEVICE_OPS``)
and one parameter and constant offset per chain step, plus the window
op.  The stencil kernel's output tile, threads and shared bytes come
from ``stencil_plan`` (per window op and frame shape, cached), the
pointwise kernel's from ``pointwise_plan``; the CPU tests hold both to
their invariants.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.isp.gamma import LUT_SIZE
from repro_torch.kernels.build import check_f32, launch, load

BH, BW = 128, 128   # the plain versions' default tile

# Device forms of the built-in stages; the op code of each is its index
# plus one (csrc/isp_fused.cu, enum Op).
POINTWISE_OPS = ("exposure", "awb", "gamma", "tonemap", "ccm")
WINDOW_OPS = ("dpc", "demosaic", "nlm", "sharpen")
DEVICE_OPS = POINTWISE_OPS + WINDOW_OPS
WINDOW_RADIUS = {"dpc": 2, "demosaic": 2, "nlm": 4, "sharpen": 1}
MAX_STEPS = 8       # chain steps a descriptor holds (csrc kMaxSteps)

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, out, pvec, stats, consts, the gamma step's param offset (or -1),
# then the ints, the descriptor arrays (ops, param offsets, const
# offsets), the stencil's window op, each kernel's plan, the stream
_POINTWISE_SIG = ("isp_pointwise_launch",        # gamma B H W C P S n
                  [_P] * 5 + [_I] * 8 + [_P] * 3  # tile threads smem
                  + [_I] * 3 + [_P])
_STENCIL_SIG = ("isp_stencil_launch",            # gamma B H W Cin Cout P
                [_P] * 5 + [_I] * 9 + [_P] * 3   # S n; wop wpoff wcoff r
                + [_I] * 9 + [_P])               # th tw threads smem

# The stencil kernel's tiles (csrc/isp_fused.cu launch_tile; the
# standalone demosaic and NLM kernels have the same), largest first: one
# 8x32 tile, a thread an output pixel, for dpc, demosaic and sharpen (on the H100 as fast as any of 8x8 to 16x32 at [8, 64, 64] and
# at [4, 480, 640]); NLM_THREADS for NLM, whose weight threads each walk
# a run of a tile row for one of its 7 shift rows.
LIGHT_TILES = ((8, 32),)
NLM_TILES = ((16, 16), (8, 16), (8, 8))
NLM_THREADS = 256
NLM_SHIFTS = 49
# the input channels a window op's instances take: the stencil segment
# runs NLM on 1 or 3, the standalone NLM kernel (csrc/nlm.cu, the same
# tile) on 1 to 4
OP_CHANNELS = {"dpc": (1,), "demosaic": (1,), "nlm": (1, 2, 3, 4),
               "sharpen": (3,)}
SMS = 132                       # the H100's streaming multiprocessors
MIN_BLOCKS = 2 * SMS            # a grid that puts two blocks on every SM
SMEM_LIMIT = 232448             # shared bytes a block can use (227 KB)
GRID_LIMIT = 2 ** 31 - 1        # blocks on gridDim.x


class ChainStep(NamedTuple):
    """One stage inside a segment: ``fn`` is its plain form (``(x, p)``;
    ``(x, p, stats)`` for a reduce-stage apply; ``(x, p, consts)`` for a
    tile_fn), its params are columns ``offset : offset + len(names)`` of
    ``pvec``, its constants ``consts[c_offset : c_offset + n_consts]``,
    and ``op`` its device form (None: the segment runs plain)."""
    fn: Optional[Callable]
    names: Tuple[str, ...]
    offset: int
    uses_stats: bool = False
    uses_consts: bool = False
    c_offset: int = 0
    n_consts: int = 0
    op: Optional[str] = None


def _step_params(step: ChainStep, pv: torch.Tensor):
    return {n: pv[:, step.offset + k] for k, n in enumerate(step.names)}


def _step_consts(step: ChainStep, cv):
    return tuple(cv[step.c_offset:step.c_offset + step.n_consts])


def _apply_chain(x, chain, pv, sv, cv):
    for step in chain:
        p = _step_params(step, pv)
        if step.uses_stats:
            x = step.fn(x, p, sv)
        elif step.uses_consts:
            x = step.fn(x, p, _step_consts(step, cv))
        else:
            x = step.fn(x, p)
    return x


def _tile_geometry(H, W, bh, bw):
    """Clamp the tile to the frame and round the grid up: a frame that
    is not a whole number of tiles runs with a zero fringe that is
    cropped after the call (the fringe feeds no valid output pixel)."""
    bh, bw = min(bh, H), min(bw, W)
    Hp = -(-H // bh) * bh
    Wp = -(-W // bw) * bw
    return bh, bw, Hp, Wp


def _pad_hw(x: torch.Tensor, top: int, bottom: int, left: int,
            right: int) -> torch.Tensor:
    """Zero-pad the image dims (1, 2) of x [B, H, W(, C)]."""
    tail = (0, 0) * (x.dim() - 3)
    return F.pad(x, tail + (left, right, top, bottom))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def pointwise_segment_torch(x, pvec, stats, consts=(), *,
                            chain: Tuple[ChainStep, ...], bh: int = BH,
                            bw: int = BW):
    """x [B, H, W(, C)] -> the same shape, ``chain`` applied tile by
    tile."""
    H, W = x.shape[1:3]
    bh, bw, Hp, Wp = _tile_geometry(H, W, bh, bw)
    xp = _pad_hw(x, 0, Hp - H, 0, Wp - W)
    out = torch.empty_like(xp)
    for y0 in range(0, Hp, bh):
        for x0 in range(0, Wp, bw):
            out[:, y0:y0 + bh, x0:x0 + bw] = _apply_chain(
                xp[:, y0:y0 + bh, x0:x0 + bw], chain, pvec, stats, consts)
    return out[:, :H, :W]


def stencil_segment_torch(x, pvec, stats, consts=(), *,
                          prologue: Tuple[ChainStep, ...],
                          window_fn: Callable, wstep: ChainStep,
                          radius: int, pad: str, out_tail: Tuple[int, ...],
                          bh: int = BH, bw: int = BW):
    """x [B, H, W(, C)] -> [B, H, W] + out_tail.  The frame is
    halo-padded once (``pad="wrap"`` cyclic, ``"zero"`` zeros); each
    tile's [bh+2r, bw+2r] window gets the ``prologue``, then the
    stage's ``window_fn``."""
    B, H, W = x.shape[:3]
    r = radius
    bh, bw, Hp, Wp = _tile_geometry(H, W, bh, bw)
    if pad == "wrap":
        rows = torch.arange(-r, H + r, device=x.device) % H
        cols = torch.arange(-r, W + r, device=x.device) % W
        xp = x[:, rows][:, :, cols]
    else:
        xp = _pad_hw(x, r, r, r, r)
    # zero fringe beyond the halo'd frame: it feeds only cropped outputs
    xp = _pad_hw(xp, 0, Hp - H, 0, Wp - W)
    zero_mask = pad == "zero" and bool(prologue)
    out = torch.empty((B, Hp, Wp) + tuple(out_tail), dtype=x.dtype,
                      device=x.device)
    wp = _step_params(wstep, pvec)
    ctx = {"consts": _step_consts(wstep, consts)} if wstep.n_consts else {}
    for y0 in range(0, Hp, bh):
        for x0 in range(0, Wp, bw):
            win = xp[:, y0:y0 + bh + 2 * r, x0:x0 + bw + 2 * r]
            if prologue:
                win = _apply_chain(win, prologue, pvec, stats, consts)
            if zero_mask:
                # the per-stage path zero-pads the prologue's OUTPUT, so
                # halo pixels read 0, not prologue(0)
                yy = torch.arange(y0 - r, y0 + bh + r, device=x.device)
                xx = torch.arange(x0 - r, x0 + bw + r, device=x.device)
                ok = (((yy >= 0) & (yy < H))[:, None]
                      & ((xx >= 0) & (xx < W))[None, :])
                ok = ok.reshape(ok.shape + (1,) * (win.dim() - 3))
                win = torch.where(ok, win, 0.0)
            out[:, y0:y0 + bh, x0:x0 + bw] = window_fn(
                win, wp, y0=y0, x0=x0, bh=bh, bw=bw, **ctx)
    return out[:, :H, :W]


# ---------------------------------------------------------------------------
# the stencil kernel's launch plan
# ---------------------------------------------------------------------------

class StencilPlan(NamedTuple):
    """One stencil launch: output tiles of ``th`` x ``tw`` pixels, one
    block each, ``tiles_y`` x ``tiles_x`` a frame (the column fastest,
    then the row, then the frame, all on gridDim.x), ``threads`` a block
    and ``smem`` shared bytes a block (the window, a luminance plane,
    NLM's weights)."""
    op: str
    th: int
    tw: int
    threads: int
    tiles_y: int
    tiles_x: int
    blocks: int
    smem: int


def lum_pitch(wx: int) -> int:
    """The luminance plane's row pitch for a window wx pixels wide
    (csrc/nlm_tile.cuh lum_pitch): a 16-float pitch puts two of NLM's
    shift rows on one bank, so it is widened by 4."""
    return wx + 4 if wx % 16 == 0 else wx


def nlm_tile_smem(c_in: int, th: int, tw: int) -> int:
    """Shared bytes of the NLM tile (csrc/nlm_tile.cuh NlmTile::kFloats,
    the standalone NLM kernel's block): the window's c_in channels (a
    float4 a pixel for 3), the luminance plane and the weights
    [shift][pixel] (a tile's pixels and one more a shift)."""
    r = WINDOW_RADIUS["nlm"]
    wy, wx = th + 2 * r, tw + 2 * r
    floats = wy * wx * (4 if c_in == 3 else c_in) + wy * lum_pitch(wx)
    return 4 * (floats + NLM_SHIFTS * (th * tw + 1))


def demosaic_tile_smem(th: int, tw: int) -> int:
    """Shared bytes of the demosaic tile (csrc/demosaic_tile.cuh
    DemosaicTile::kFloats, the standalone demosaic kernel's block): the
    mosaic window, the tile and its halo, one float a pixel."""
    r = WINDOW_RADIUS["demosaic"]
    return 4 * (th + 2 * r) * (tw + 2 * r)


def stencil_smem(op: str, c_in: int, th: int, tw: int) -> int:
    """Shared bytes of a stencil block (csrc Layout::kFloats): the
    window's c_in channels (NLM on RGB: a float4 a pixel), the luminance
    (NLM) or Y (sharpen) plane, NLM's weights [shift][pixel] (a tile's
    pixels and one more a shift) -- NLM's planes are the NLM tile's --
    and the frame's gamma LUT."""
    if op == "nlm":
        return nlm_tile_smem(c_in, th, tw) + 4 * LUT_SIZE
    r = WINDOW_RADIUS[op]
    wy, wx = th + 2 * r, tw + 2 * r
    floats = wy * wx * c_in
    if op == "sharpen":
        floats += wy * lum_pitch(wx)
    return 4 * (floats + LUT_SIZE)


def op_tiles(op: str):
    """The output tiles the kernel has an instance of for window op
    ``op``, largest first."""
    if op not in WINDOW_OPS:
        raise ValueError(f"stencil_plan: no window op {op!r}")
    return NLM_TILES if op == "nlm" else LIGHT_TILES


def tile_plan(op: str, B: int, H: int, W: int, c_in: int, th: int,
              tw: int) -> StencilPlan:
    """The plan of one of ``op``'s tiles on B frames of H x W."""
    if (th, tw) not in op_tiles(op):
        raise ValueError(f"stencil_plan: {op} has no {th}x{tw} tile")
    if c_in not in OP_CHANNELS[op]:
        raise ValueError(f"stencil_plan: {op} has no instance on {c_in} "
                         f"channels")
    if op == "demosaic" and (th % 2 or tw % 2):
        # the demosaic tile takes a pixel's Bayer phase from its place in
        # the tile: its corner must be even
        raise ValueError(f"stencil_plan: demosaic needs an even tile, not "
                         f"{th}x{tw}")
    ty, tx = -(-H // th), -(-W // tw)
    blocks = B * ty * tx
    if blocks > GRID_LIMIT:
        raise ValueError(f"stencil_plan: {blocks} blocks past gridDim.x")
    return StencilPlan(op, th, tw, NLM_THREADS if op == "nlm" else th * tw,
                       ty, tx, blocks, stencil_smem(op, c_in, th, tw))


@functools.lru_cache(maxsize=None)
def stencil_plan(op: str, B: int, H: int, W: int, c_in: int) -> StencilPlan:
    """The stencil kernel's plan for window op ``op`` on B frames of H x W
    with c_in channels: the largest of the op's tiles whose grid puts two
    blocks on every SM (else the smallest tile; dpc, demosaic and sharpen
    have one), its threads and its shared bytes.  Cached per shape: the
    tick asks once per segment.  The standalone NLM kernel takes its
    tile and threads from ``stencil_plan("nlm", ...)`` too (its shared
    bytes: ``nlm_tile_smem``, without the LUT), the standalone demosaic
    kernel from ``stencil_plan("demosaic", ...)`` (``demosaic_tile_smem``)."""
    tiles = op_tiles(op)
    for th, tw in tiles:
        if B * -(-H // th) * -(-W // tw) >= MIN_BLOCKS:
            break
    return tile_plan(op, B, H, W, c_in, th, tw)


# ---------------------------------------------------------------------------
# the pointwise kernel's launch plan
# ---------------------------------------------------------------------------

POINTWISE_TILES = (1024, 512, 256)  # pixels a block, largest first
POINTWISE_THREADS = 256
POINTWISE_SMEM_LIMIT = 48 * 1024    # static launch, no opt-in


class PointwisePlan(NamedTuple):
    """One pointwise launch: tiles of ``tile`` pixels of a frame's flat
    ``H * W * C`` span, one block each, ``tiles`` a frame (the tile
    fastest, then the frame, all on gridDim.x), ``threads`` a block and
    ``smem`` shared bytes a block (the staged span with a 16-byte
    phase's slack, the gamma LUT, the frame's pvec and stats rows)."""
    tile: int
    threads: int
    tiles: int
    blocks: int
    smem: int


def pointwise_smem(tile: int, c: int, p: int, s: int) -> int:
    """Shared bytes of a pointwise block (csrc pointwise_floats)."""
    return 4 * (tile * c + 4 + LUT_SIZE + p + s)


@functools.lru_cache(maxsize=None)
def pointwise_plan(B: int, H: int, W: int, C: int, P: int,
                   S: int) -> PointwisePlan:
    """The pointwise kernel's plan on B frames of H x W x C with pvec
    [B, P] and stats [B, S]: the largest of ``POINTWISE_TILES`` whose
    grid puts two blocks on every SM (else the smallest: a launch's
    latency sets the time there), its threads and shared bytes.  Cached
    per shape: the tick asks once per segment."""
    if C not in (1, 3):
        raise ValueError(f"pointwise_plan: C must be 1 or 3, got {C}")
    for tile in POINTWISE_TILES:
        if B * -(-H * W // tile) >= MIN_BLOCKS:
            break
    tiles = -(-H * W // tile)
    blocks = B * tiles
    if blocks > GRID_LIMIT:
        raise ValueError(f"pointwise_plan: {blocks} blocks past gridDim.x")
    smem = pointwise_smem(tile, C, P, S)
    if smem > POINTWISE_SMEM_LIMIT:
        raise ValueError(f"pointwise_plan: {smem} shared bytes (P {P}, S "
                         f"{S}) past {POINTWISE_SMEM_LIMIT}")
    return PointwisePlan(tile, POINTWISE_THREADS, tiles, blocks, smem)


# ---------------------------------------------------------------------------
# wrappers of the CUDA kernels
# ---------------------------------------------------------------------------

def _descriptor(chain, consts):
    """The chain as the kernels read it: op codes, param offsets and
    constant offsets (in floats of the flattened consts) as ctypes
    arrays, and each constant's start in the flattened consts."""
    if len(chain) > MAX_STEPS:
        raise ValueError(f"isp_fused: {len(chain)} chain steps, at most "
                         f"{MAX_STEPS}")
    starts = [0]
    for c in consts:
        starts.append(starts[-1] + c.numel())
    ops, poffs, coffs = [], [], []
    for step in chain:
        if step.op not in POINTWISE_OPS:
            raise ValueError(f"isp_fused: chain step {step.names} has no "
                             f"pointwise device form (op {step.op!r})")
        ops.append(DEVICE_OPS.index(step.op) + 1)
        poffs.append(step.offset)
        coffs.append(starts[step.c_offset])
    arr = ctypes.c_int * MAX_STEPS
    return (len(chain), arr(*ops), arr(*poffs), arr(*coffs)), starts


def gamma_offset(chain) -> int:
    """The gamma step's parameter column in pvec (the last one's, if
    several), or -1: the column the gamma LUT is built from."""
    return next((s.offset for s in reversed(chain) if s.op == "gamma"), -1)


_FLAT: "collections.OrderedDict" = collections.OrderedDict()
_FLAT_MAX = 64


def _flat_consts(consts, dev) -> torch.Tensor:
    """The constants flattened into one float32 tensor on ``dev`` (one
    zero where there are none), made once per tuple of constant tensors
    and device: a segment passes the same device tensors every call
    (``isp.fuse._SegmentExec.consts_on``), so a call adds no device op
    for them.  The constants are never modified in place."""
    key = (dev, tuple(id(c) for c in consts))
    hit = _FLAT.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], consts)):
        _FLAT.move_to_end(key)
        return hit[1]
    if not consts:
        flat = torch.zeros(1, dtype=torch.float32, device=dev)
    else:
        flat = torch.cat([c.reshape(-1) for c in consts]).to(
            device=dev, dtype=torch.float32).contiguous()
    _FLAT[key] = (tuple(consts), flat)
    if len(_FLAT) > _FLAT_MAX:
        _FLAT.popitem(last=False)
    return flat


def _check_inputs(name, x, pvec, stats):
    dev = check_f32(name, x, pvec, stats)
    B = x.shape[0]
    if x.dim() not in (3, 4) or (x.dim() == 4 and x.shape[3] not in (1, 3)):
        raise ValueError(f"{name}: expected [B, H, W] or [B, H, W, 1|3], "
                         f"got {tuple(x.shape)}")
    for t, what in ((pvec, "pvec"), (stats, "stats")):
        if t.dim() != 2 or t.shape[0] != B:
            raise ValueError(f"{name}: {what} must be [{B}, n], got "
                             f"{tuple(t.shape)}")
    return dev


def pointwise_segment(x, pvec, stats, consts=(), *,
                      chain: Tuple[ChainStep, ...], bh: int = BH,
                      bw: int = BW):
    """x [B, H, W(, C)] float32, pvec [B, P], stats [B, w], consts a
    tuple of tensors -> the same shape as x.  On a CUDA tensor: one
    launch on its ``pointwise_plan``, the gamma LUT built in the
    kernel."""
    dev = _check_inputs("pointwise_segment", x, pvec, stats)
    if dev.type == "cpu":
        return pointwise_segment_torch(x, pvec, stats, consts, chain=chain,
                                       bh=bh, bw=bw)
    (n, ops, poffs, coffs), _ = _descriptor(chain, consts)
    B, H, W = x.shape[:3]
    C = x.shape[3] if x.dim() == 4 else 1
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    flat = _flat_consts(consts, dev)
    P, S = pvec.shape[1], stats.shape[1]
    plan = pointwise_plan(B, H, W, C, P, S)
    lib = load("isp_fused", _POINTWISE_SIG)
    launch("isp_pointwise_segment", dev, lib.isp_pointwise_launch,
           x.data_ptr(), out.data_ptr(), pvec.data_ptr(), stats.data_ptr(),
           flat.data_ptr(), gamma_offset(chain), B, H, W, C, P, S, n, ops,
           poffs, coffs, plan.tile, plan.threads, plan.smem)
    return out


def stencil_segment(x, pvec, stats, consts=(), *,
                    prologue: Tuple[ChainStep, ...], window_fn: Callable,
                    wstep: ChainStep, radius: int, pad: str,
                    out_tail: Tuple[int, ...], bh: int = BH, bw: int = BW):
    """x [B, H, W(, C)] float32, pvec [B, P], stats [B, w], consts a
    tuple of tensors -> [B, H, W] + out_tail.  On a CUDA tensor the
    window op is ``wstep.op``, launched on its ``stencil_plan``;
    ``window_fn`` is the plain form."""
    dev = _check_inputs("stencil_segment", x, pvec, stats)
    if dev.type == "cpu":
        return stencil_segment_torch(
            x, pvec, stats, consts, prologue=prologue, window_fn=window_fn,
            wstep=wstep, radius=radius, pad=pad, out_tail=out_tail, bh=bh,
            bw=bw)
    if wstep.op not in WINDOW_OPS or WINDOW_RADIUS[wstep.op] != radius:
        raise ValueError(f"stencil_segment: window op {wstep.op!r} with "
                         f"radius {radius} has no device form")
    if pad not in ("wrap", "zero") or len(out_tail) > 1:
        raise ValueError(f"stencil_segment: pad {pad!r}, out_tail "
                         f"{out_tail}")
    (n, ops, poffs, coffs), starts = _descriptor(prologue, consts)
    B, H, W = x.shape[:3]
    c_in = x.shape[3] if x.dim() == 4 else 1
    c_out = out_tail[0] if out_tail else 1
    out = torch.empty((B, H, W) + tuple(out_tail), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    flat = _flat_consts(consts, dev)
    plan = stencil_plan(wstep.op, B, H, W, c_in)
    lib = load("isp_fused", _STENCIL_SIG)
    launch("isp_stencil_segment", dev, lib.isp_stencil_launch,
           x.data_ptr(), out.data_ptr(), pvec.data_ptr(), stats.data_ptr(),
           flat.data_ptr(), gamma_offset(prologue), B, H, W, c_in, c_out,
           pvec.shape[1], stats.shape[1], n, ops, poffs, coffs,
           DEVICE_OPS.index(wstep.op) + 1, wstep.offset,
           starts[wstep.c_offset], radius, int(pad == "zero"), plan.th,
           plan.tw, plan.threads, plan.smem)
    return out
