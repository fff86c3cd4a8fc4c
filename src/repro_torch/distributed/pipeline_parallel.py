"""Pipeline parallelism: a GPipe-style microbatch executor over the ranks
of a process group, the counterpart of ``repro.distributed.pipeline_
parallel`` (whose ring is a ``pipe`` mesh axis under ``shard_map`` and
``ppermute``).

Layers are partitioned into S stages, stage s on the group's rank s;
microbatches flow through the stage ring, activations passed to the next
rank by ``dist.batch_isend_irecv``.  The schedule is the classic GPipe
fill-drain loop over ``M + S - 1`` ticks: rank 0 injects microbatch
``t``, the last rank records microbatch ``t - (S - 1)``.

Bubble fraction = (S-1)/(M+S-1); the runner picks M >= 4*S by default.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.sharding import tree_map


def pipeline_forward(stage_fn: Callable, params_stacked, x_micro: torch.Tensor,
                     group) -> torch.Tensor:
    """Run microbatches through the stage ring of ``group``.

    ``stage_fn(stage_params, x) -> x`` (same shape in and out);
    ``params_stacked``: a tree whose leaves have a leading dim of
    n_stages (rank s of the group takes slice s); ``x_micro``: ``[M, mb,
    ...]`` microbatches (read on rank 0).  Returns ``y_micro [M, mb,
    ...]``, the finished microbatches, on every rank (broadcast from the
    last stage: the reference's ``gathered[-1]``)."""
    import torch.distributed as dist
    S = dist.get_world_size(group)
    rank = dist.get_rank(group)
    M = x_micro.shape[0]
    params = tree_map(lambda p: p[rank], params_stacked)
    nxt = dist.get_global_rank(group, (rank + 1) % S)
    prv = dist.get_global_rank(group, (rank - 1) % S)
    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(M + S - 1):
        if rank == 0 and t < M:
            buf = x_micro[t]                 # stage 0 injects microbatch t
        y = stage_fn(params, buf).contiguous()
        if rank == S - 1 and t >= S - 1:
            outs[t - (S - 1)] = y            # the last stage's finished one
        if S == 1:
            buf = y
            continue
        # rotate activations around the ring
        buf = torch.empty_like(y)
        ops = [dist.P2POp(dist.isend, y, nxt, group),
               dist.P2POp(dist.irecv, buf, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    dist.broadcast(outs, dist.get_global_rank(group, S - 1), group=group)
    return outs


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
