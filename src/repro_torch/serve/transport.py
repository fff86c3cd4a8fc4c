"""Host-side transport of the cognitive serving tick, the counterpart of
``repro.serve.transport``: the staging bank a submit copies into, the
double buffer that overlaps packing with compute, and the request
validation and staging shared by every submit path.

A :class:`StagingBank` lives in ONE contiguous host byte buffer (pinned
when the engine serves a GPU) with a numpy view per field, so a tick
uploads the whole bank with one host->device copy and the device side
takes its fields as views of that one copy (``StagingBank.device_views``).
The fleet stages into a :class:`ShardedBank`: one such bank per device
of its engine (one device without a serving mesh), each with that
device's rows, so one copy per device.

The pinned-bank rule: ``EngineCore.upload`` copies a pinned bank with
``non_blocking=True``, so the bank is not free when ``upload`` returns.
The upload records a CUDA event behind the copy on the bank
(:meth:`StagingBank.mark_copied`), and every write into the bank first
waits for that event (:meth:`StagingBank.wait_copied`): a bank is
re-packed only once its last copy has landed.  (The reference needs no
such rule: JAX's ``device_put`` donation hands the buffer over.)

:class:`DoubleBuffer` holds two banks: while tick N computes on the
device copy of bank A, the fleet packs tick N+1 into bank B.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import EncodingConfig, SNNConfig
from repro_torch.core.encoding import EventStream, as_stream, fit_stream

_ALIGN = 64
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.bool_): torch.bool}


class StagingBank:
    """Host slot buffers for one tick batch: DVS voxel windows, Bayer
    frames, per-slot bounded event FIFOs and the per-slot
    encoded-vs-submitted flag.  Inactive slots hold stale or zero data
    and ride along in the fixed-shape tick."""

    def __init__(self, cfg: SNNConfig, batch: int,
                 frame_hw: Tuple[int, int], event_capacity: int,
                 pin_memory: bool = False):
        H, W = frame_hw
        cap = event_capacity
        self.batch = batch
        fields = [
            ("voxels", (cfg.time_steps, batch, cfg.height, cfg.width,
                        cfg.in_channels), np.float32),
            ("bayer", (batch, H, W), np.float32),
            ("ev_t", (batch, cap), np.float32),
            ("ev_x", (batch, cap), np.int32),
            ("ev_y", (batch, cap), np.int32),
            ("ev_p", (batch, cap), np.int32),
            ("ev_valid", (batch, cap), np.bool_),
            ("from_events", (batch,), np.bool_),
        ]
        self._layout: Dict[str, tuple] = {}
        off = 0
        for name, shape, dtype in fields:
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            self._layout[name] = (off, nbytes, shape, np.dtype(dtype))
            off += -(-nbytes // _ALIGN) * _ALIGN
        self.buffer = torch.zeros(off, dtype=torch.uint8,
                                  pin_memory=pin_memory)
        host = self.buffer.numpy()
        v = {name: host[o:o + n].view(dt).reshape(shape)
             for name, (o, n, shape, dt) in self._layout.items()}
        self.voxels = v["voxels"]
        self.bayer = v["bayer"]
        self.events = EventStream(t=v["ev_t"], x=v["ev_x"], y=v["ev_y"],
                                  p=v["ev_p"], valid=v["ev_valid"])
        self.from_events = v["from_events"]
        self._copied = None         # the event behind the last upload

    @property
    def shards(self) -> Tuple["StagingBank", ...]:
        """The banks a tick uploads, one per device: this one."""
        return (self,)

    def mark_copied(self, event) -> None:
        """Record ``event`` (recorded behind this bank's host->device
        copy) as the copy that the next write waits for."""
        self._copied = event

    def wait_copied(self) -> None:
        """Block until the bank's last upload has landed on the device;
        every writer calls this first."""
        if self._copied is not None:
            self._copied.synchronize()
            self._copied = None

    def stage_voxels(self, slot: int, voxels, bayer) -> None:
        self.wait_copied()
        self.voxels[:, slot] = np.asarray(voxels, np.float32)
        self.bayer[slot] = np.asarray(bayer, np.float32)
        self.from_events[slot] = False

    def stage_events(self, slot: int, ev: EventStream, bayer) -> None:
        """``ev`` must already fit the bank's FIFO capacity (see
        :func:`stage_request`, which budgets overfull windows)."""
        self.wait_copied()
        self.events.t[slot] = np.asarray(ev.t, np.float32)
        self.events.x[slot] = np.asarray(ev.x, np.int32)
        self.events.y[slot] = np.asarray(ev.y, np.int32)
        self.events.p[slot] = np.asarray(ev.p, np.int32)
        self.events.valid[slot] = np.asarray(ev.valid, bool)
        self.bayer[slot] = np.asarray(bayer, np.float32)
        self.from_events[slot] = True

    def set_inert(self, slot: int) -> None:
        """An unfilled slot rides the tick on its stale or zero voxels."""
        self.wait_copied()
        self.from_events[slot] = False

    def fill_voxels(self, slot: int, value: float) -> None:
        """Overwrite a slot's voxel window with ``value`` (fault
        injection's corrupt input)."""
        self.wait_copied()
        self.voxels[:, slot] = value

    def device_views(self, dev_buffer: torch.Tensor):
        """Typed views ``(voxels, bayer, events, from_events)`` of a
        device copy of :attr:`buffer`."""
        v = {}
        for name, (o, n, shape, dt) in self._layout.items():
            v[name] = dev_buffer[o:o + n].view(_TORCH_DTYPES[dt]).view(shape)
        events = EventStream(t=v["ev_t"], x=v["ev_x"], y=v["ev_y"],
                             p=v["ev_p"], valid=v["ev_valid"])
        return v["voxels"], v["bayer"], events, v["from_events"]


class ShardedBank:
    """A tick's slots split by rows over the engine's devices (one
    without a serving mesh): one :class:`StagingBank` (its own
    contiguous, pinned buffer) per shard,
    slot ``s`` in shard ``s // (batch / shards)``, so each device's rows
    go up in one host->device copy of its own.  Writers use the same
    calls as on a :class:`StagingBank`; each waits for its shard's last
    copy."""

    def __init__(self, cfg: SNNConfig, batch: int,
                 frame_hw: Tuple[int, int], event_capacity: int,
                 n_shards: int, pin_memory: bool = False):
        if batch % n_shards:
            raise ValueError(f"tick batch={batch} does not split over "
                             f"{n_shards} shards")
        self.batch = batch
        self.per = batch // n_shards
        self.shards = tuple(StagingBank(cfg, self.per, frame_hw,
                                        event_capacity, pin_memory)
                            for _ in range(n_shards))

    def _at(self, slot: int) -> Tuple[StagingBank, int]:
        return self.shards[slot // self.per], slot % self.per

    def stage_voxels(self, slot: int, voxels, bayer) -> None:
        bank, j = self._at(slot)
        bank.stage_voxels(j, voxels, bayer)

    def stage_events(self, slot: int, ev: EventStream, bayer) -> None:
        bank, j = self._at(slot)
        bank.stage_events(j, ev, bayer)

    def set_inert(self, slot: int) -> None:
        bank, j = self._at(slot)
        bank.set_inert(j)

    def fill_voxels(self, slot: int, value: float) -> None:
        bank, j = self._at(slot)
        bank.fill_voxels(j, value)

    def wait_copied(self) -> None:
        for bank in self.shards:
            bank.wait_copied()


class DoubleBuffer:
    """Two staging banks, flipped every dispatched tick.  ``front`` is
    the bank being packed for the next tick; ``flip()`` after its upload
    makes the other the front (its writers wait for its own copy's
    event, :meth:`StagingBank.wait_copied`)."""

    def __init__(self, make_bank, enabled: bool = True):
        self.banks = [make_bank(), make_bank()] if enabled else [make_bank()]
        self.idx = 0

    @property
    def front(self) -> StagingBank:
        return self.banks[self.idx]

    def flip(self) -> None:
        self.idx = (self.idx + 1) % len(self.banks)


def validate_request(req, in_channels: int,
                     events_only: bool = False, *,
                     time_steps: int = None,
                     voxel_hw: Tuple[int, int] = None,
                     frame_hw: Tuple[int, int] = None) -> str:
    """Payload validation shared by every submit path.  Returns the
    staging kind ``"voxels"`` | ``"events"`` or raises ValueError with
    the reference's messages.  When given, the keyword shapes harden the
    edge: a voxel payload must be exactly ``[time_steps, H, W,
    in_channels]`` and the bayer frame ``frame_hw``, so shape garbage
    fails here, not inside the serving loop."""
    if events_only or req.voxels is None:
        if req.events is None:
            if events_only:
                raise ValueError(f"request {req.rid} carries no events")
            raise ValueError(f"request {req.rid}: neither voxels nor "
                             f"events")
        if req.bayer is None:
            raise ValueError(f"request {req.rid} carries no bayer frame")
        if in_channels != 2:
            raise ValueError("event ingestion needs in_channels=2 "
                             "(DVS polarity channels)")
        for leaf in (req.events.t, req.events.x, req.events.y,
                     req.events.p):
            if np.ndim(leaf) != 1:
                raise ValueError(
                    f"request {req.rid}: event stream leaves must be "
                    f"1-D [N], got ndim={np.ndim(leaf)}")
        _check_bayer(req, frame_hw)
        return "events"
    if req.bayer is None:
        raise ValueError(f"request {req.rid} carries no bayer frame")
    vox = tuple(np.shape(req.voxels))
    if len(vox) != 4:
        raise ValueError(
            f"request {req.rid}: voxels must be [T, H, W, C], got "
            f"shape {vox}")
    want = (time_steps if time_steps is not None else vox[0],
            voxel_hw[0] if voxel_hw is not None else vox[1],
            voxel_hw[1] if voxel_hw is not None else vox[2],
            in_channels)
    if vox != want:
        raise ValueError(
            f"request {req.rid}: voxel shape {vox} does not match the "
            f"engine's [T, H, W, C]={want}")
    _check_bayer(req, frame_hw)
    return "voxels"


def _check_bayer(req, frame_hw=None) -> None:
    shape = tuple(np.shape(req.bayer))
    if len(shape) != 2:
        raise ValueError(
            f"request {req.rid}: bayer frame must be 2-D [H, W], got "
            f"shape {shape}")
    if frame_hw is not None and shape != tuple(frame_hw):
        raise ValueError(
            f"request {req.rid}: bayer frame {shape} does not match "
            f"the engine's frame_hw={tuple(frame_hw)}")


def stage_request(bank: StagingBank, slot: int, req, kind: str,
                  enc_cfg: EncodingConfig) -> None:
    """Stage a validated request into a bank slot (host copies only).
    Event windows are coerced to the per-slot FIFO: under-full windows
    validity-padded, overfull ones budgeted to the
    ``enc_cfg.event_capacity`` earliest events."""
    if kind == "events":
        bank.stage_events(slot, fit_stream(as_stream(req.events),
                                           enc_cfg.event_capacity),
                          req.bayer)
    else:
        bank.stage_voxels(slot, req.voxels, req.bayer)
