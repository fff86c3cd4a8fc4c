"""Mesh construction, the counterpart of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
device and no process group.  The serving mesh spans this process's
cards (``local_mesh``); the production and elastic meshes span the
ranks of the default process group (``rank_mesh``), which the caller
initialises (``torchrun`` on cards).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import Mesh, local_mesh, rank_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh over the ranks of the process
    group: ``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` with a
    ``"pod"`` axis.  Raises unless the group holds its 256 or 512 ranks."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return rank_mesh(shape, axes)


def _visible_cards():
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_serving_mesh(batch: Optional[int] = None,
                      devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """1-D ``("data",)`` mesh for the cognitive serving tick: the largest
    count of ``devices`` (default: every visible card) that divides the
    tick ``batch`` (the per-slot math is batch-parallel, so the only
    constraint is an even slot split).  Returns ``None`` when a single
    device (or batch=1) makes sharding pointless: callers take the local
    path.  (The reference's ``max_devices`` cap is ``devices[:cap]``.)"""
    devices = list(devices) if devices is not None else _visible_cards()
    n = len(devices)
    if batch is not None:
        while n > 1 and batch % n:
            n -= 1
    if n <= 1:
        return None
    return local_mesh(devices[:n], ("data",))


def elastic_shape(devices: int, model_parallel: Optional[int] = None
                  ) -> Tuple[int, int]:
    """The largest ``(data, model)`` shape over ``devices``: the model
    axis ``model_parallel`` (default ``min(16, devices)``) halved until it
    divides them."""
    model_parallel = model_parallel or min(16, devices)
    while devices % model_parallel:
        model_parallel //= 2
    return devices // model_parallel, model_parallel


def make_mesh_for(devices: int, model_parallel: Optional[int] = None
                  ) -> Mesh:
    """Elastic mesh: the largest ``("data", "model")`` mesh over whatever
    device count survives a failure (``distributed.fault_tolerance``
    ``plan_restart``), over the ranks of the process group."""
    return rank_mesh(elastic_shape(devices, model_parallel),
                     ("data", "model"))
