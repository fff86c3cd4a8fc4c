"""DVS event encoding (paper §IV-A): event buffers -> voxel grids, the
counterpart of ``repro.core.encoding``.

Semantics, as in the reference:

- invalid events and out-of-bounds ``x``/``y``/``p`` are dropped;
- time bin = ``floor(t / window * time_steps)`` in float32, in that
  order; bins outside ``[0, time_steps)`` follow ``oob``: "clip" aliases
  them into the edge bins, "drop" discards them;
- ``mode``: "binary" (one-hot occupancy), "count" (per-polarity counts),
  "signed" (channels ``(ON - OFF, ON + OFF)``).

The plain scatter is one ``index_put_(..., accumulate=True)`` of ones
into a flat float32 grid with a dump slot for dead events: adding 1.0 to
integer counts below 2^24 is exact in any order, so the grid is
bit-identical to the reference.  ``voxel_batch`` and the tick's
``encode_batch`` (the grid, or a window's staged voxels where it came
as voxels) dispatch on the encoding backend: ``"torch"`` is that plain
scatter, ``"cuda"`` the voxelization kernel
(:mod:`repro_torch.kernels.event_voxel`).

It also carries the batched EventStream plumbing of the reference:
stacking and concatenating bounded event buffers, validity-masked
padding, and event budgeting for overfull windows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

VOXEL_MODES = ("binary", "count", "signed")
OOB_POLICIES = ("clip", "drop")
ENCODING_BACKENDS = ("torch", "cuda")


class EventStream(NamedTuple):
    """Fixed-capacity event buffer; leaves are [N] for one window or
    [B, N] when batched."""
    t: torch.Tensor      # float32 in [0, window)
    x: torch.Tensor      # int32
    y: torch.Tensor      # int32
    p: torch.Tensor      # int32 {0, 1}
    valid: torch.Tensor  # bool

    @property
    def capacity(self) -> int:
        return self.t.shape[-1]

    def num_events(self) -> torch.Tensor:
        """Live events per window: [] or [B] int64."""
        return self.valid.sum(dim=-1)


def as_stream(ev, device=None) -> EventStream:
    """An EventStream of tensors (float32 t, int32 x/y/p, bool valid)
    from any stream whose leaves convert with ``torch.as_tensor``."""
    def leaf(a, dtype):
        return torch.as_tensor(a).to(device=device, dtype=dtype)
    return EventStream(t=leaf(ev.t, torch.float32), x=leaf(ev.x, torch.int32),
                       y=leaf(ev.y, torch.int32), p=leaf(ev.p, torch.int32),
                       valid=leaf(ev.valid, torch.bool))


def resolve_mode(mode: Optional[str], binary: bool = True) -> str:
    """``mode``, or the legacy ``binary`` flag's (True -> "binary",
    False -> "count") when ``mode`` is None."""
    if mode is None:
        return "binary" if binary else "count"
    if mode not in VOXEL_MODES:
        raise ValueError(f"mode must be one of {VOXEL_MODES}, got {mode!r}")
    return mode


def check_oob(oob: str) -> None:
    if oob not in OOB_POLICIES:
        raise ValueError(f"oob must be one of {OOB_POLICIES}, got {oob!r}")


def saturate_int32(q: torch.Tensor) -> torch.Tensor:
    """Float bins -> int64, as the reference's float32 -> int32 cast
    under XLA: NaN -> 0, and +-inf or a value beyond the int32 range ->
    that range's end.  A plain ``.to(int64)`` is undefined for NaN and
    inf (the CPU gives INT64_MIN)."""
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    q = q.clamp(-2.0 ** 31, 2.0 ** 31)          # both ends exact in f32
    return q.to(torch.int64).clamp(-2 ** 31, 2 ** 31 - 1)


def events_to_voxel_batch(evs: EventStream, *, time_steps: int,
                          height: int, width: int, window: float = 1.0,
                          binary: bool = True, mode: Optional[str] = None,
                          oob: str = "clip") -> torch.Tensor:
    """Batched encoding, batch-major: leaves [B, N] -> [B, T, H, W, 2].
    ``mode`` overrides the legacy ``binary`` flag."""
    mode = resolve_mode(mode, binary)
    check_oob(oob)
    B = evs.t.shape[0]
    # divide by a float32 tensor, not a Python scalar: on a CUDA tensor
    # torch turns division by a scalar into a multiply by its reciprocal
    div = torch.full((), window, dtype=torch.float32, device=evs.t.device)
    tbin = saturate_int32(torch.floor(evs.t / div * time_steps))
    x, y, p = (a.to(torch.int64) for a in (evs.x, evs.y, evs.p))
    ok = (evs.valid & (x >= 0) & (x < width) & (y >= 0) & (y < height)
          & (p >= 0) & (p < 2))
    if oob == "drop":
        ok = ok & (tbin >= 0) & (tbin < time_steps)
    tbin = tbin.clamp(0, time_steps - 1)
    size = time_steps * height * width * 2
    b = torch.arange(B, device=evs.t.device)[:, None]
    flat = b * size + ((tbin * height + y) * width + x) * 2 + p
    flat = torch.where(ok, flat, B * size)      # dead events -> dump slot
    grid = torch.zeros(B * size + 1, dtype=torch.float32,
                       device=evs.t.device)
    grid.index_put_((flat.reshape(-1),),
                    torch.ones(flat.numel(), dtype=torch.float32,
                               device=evs.t.device), accumulate=True)
    grid = grid[:-1].reshape(B, time_steps, height, width, 2)
    if mode == "binary":
        grid = (grid > 0).to(torch.float32)
    elif mode == "signed":
        grid = torch.stack([grid[..., 1] - grid[..., 0],
                            grid[..., 1] + grid[..., 0]], dim=-1)
    return grid


def events_to_voxel(ev: EventStream, **kw) -> torch.Tensor:
    """One window ([N] leaves) -> voxel grid [T, H, W, 2]."""
    return events_to_voxel_batch(
        EventStream(*(a[None] for a in ev)), **kw)[0]


def voxel_batch(evs: EventStream, *, backend: str = "torch",
                **kw) -> torch.Tensor:
    """Batched encoding on the encoding ``backend``, time-major for the
    multi-step SNN layers: leaves [B, N] -> [T, B, H, W, 2] (a view of
    the batch-major grid)."""
    if backend == "cuda":
        # imported here: the kernel module imports this one
        from repro_torch.kernels.event_voxel import event_voxel
        vox = event_voxel(evs, **kw)
    elif backend == "torch":
        vox = events_to_voxel_batch(evs, **kw)
    else:
        raise ValueError(f"unknown encoding backend {backend!r}; known: "
                         f"{ENCODING_BACKENDS}")
    return vox.transpose(0, 1)


def encode_batch(evs: EventStream, voxels: torch.Tensor,
                 from_events: torch.Tensor, *, backend: str = "torch",
                 **kw) -> torch.Tensor:
    """The tick's encode on the encoding ``backend``: leaves [B, N], the
    staged voxel windows [T, B, H, W, 2] and ``from_events`` [B] bool ->
    [T, B, H, W, 2], window b's grid from its events where
    ``from_events[b]``, else its staged grid.  ``"torch"``: the plain
    scatter and a ``torch.where``; ``"cuda"``: one launch of the
    voxelization kernel, which copies a staged window in place of
    binning it (the [T, B] view of a batch-major grid, as
    ``voxel_batch``'s)."""
    if backend == "cuda":
        # imported here: the kernel module imports this one
        from repro_torch.kernels.event_voxel import event_voxel_encode
        return event_voxel_encode(evs, voxels, from_events, **kw)
    enc = voxel_batch(evs, backend=backend, **kw)
    return torch.where(from_events[None, :, None, None, None], enc, voxels)


# ---------------------------------------------------------------------------
# EventStream budgeting
# ---------------------------------------------------------------------------

def pad_stream(ev: EventStream, capacity: int) -> EventStream:
    """Grow a stream ([N] or [B, N] leaves) to ``capacity`` with invalid
    padding; shrinking goes through ``budget_events``."""
    n = ev.capacity
    if n == capacity:
        return ev
    if n > capacity:
        raise ValueError(
            f"stream has capacity {n} > {capacity}; budget it first "
            f"(repro_torch.core.encoding.budget_events)")
    grow = (0, capacity - n)
    return EventStream(t=F.pad(ev.t, grow), x=F.pad(ev.x, grow),
                       y=F.pad(ev.y, grow), p=F.pad(ev.p, grow),
                       valid=F.pad(ev.valid, grow, value=False))


def stack_streams(streams: Sequence[EventStream],
                  capacity: Optional[int] = None) -> EventStream:
    """Stack single-window ([N]-leaf) streams of ragged capacity into one
    batched stream with [B, max_N] leaves and validity-mask padding."""
    if not streams:
        raise ValueError("stack_streams needs at least one stream")
    cap = capacity if capacity is not None \
        else max(s.capacity for s in streams)
    padded = [pad_stream(s, cap) for s in streams]
    return EventStream(*(torch.stack(ls) for ls in zip(*padded)))


def concat_streams(*streams: EventStream) -> EventStream:
    """Merge event buffers along the capacity axis (e.g. several sensor
    FIFO drains landing in one window).  Leaves may be [N] or [B, N]."""
    if not streams:
        raise ValueError("concat_streams needs at least one stream")
    return EventStream(*(torch.cat(ls, dim=-1) for ls in zip(*streams)))


def budget_events(ev: EventStream, budget: int,
                  rng: Optional[torch.Generator] = None) -> EventStream:
    """Compact a window ([N] leaves, or [B, N] budgeted per window) to
    exactly ``budget`` capacity, keeping at most ``budget`` live events:
    the EARLIEST ones (a FIFO drop-tail, ties broken by buffer
    position), or with ``rng`` a uniform random subsample of the live
    ones.  Under-full windows keep every live event.  ``rng`` draws
    other numbers than the reference's JAX key does."""
    if budget <= 0:
        raise ValueError(f"budget must be positive, got {budget}")
    n = ev.capacity
    dev = ev.t.device
    if rng is None:
        key = ev.t
    else:
        key = torch.rand(ev.t.shape, generator=rng,
                         device=rng.device).to(dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    order = torch.sort(torch.where(ev.valid, key, inf), dim=-1,
                       stable=True).indices
    keep = order[..., :budget] if budget <= n \
        else F.pad(order, (0, budget - n))
    rank_ok = torch.arange(budget, device=dev) < min(n, budget)

    def take(a):
        return torch.gather(a, -1, keep)
    return EventStream(t=take(ev.t), x=take(ev.x), y=take(ev.y),
                       p=take(ev.p), valid=take(ev.valid) & rank_ok)


def fit_stream(ev: EventStream, capacity: int,
               rng: Optional[torch.Generator] = None) -> EventStream:
    """Coerce a stream ([N] or [B, N] leaves) to EXACTLY ``capacity``:
    overfull buffers are budgeted (see ``budget_events``), under-full
    ones padded with invalid events."""
    if ev.capacity > capacity:
        return budget_events(ev, capacity, rng)
    return pad_stream(ev, capacity)
