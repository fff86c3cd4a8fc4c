"""Mesh-axis plumbing and parameter sharding rules, the counterpart of
``repro.distributed.sharding``.

Conventions (the reference's)
-----------------------------
Mesh axes: single pod ``("data", "model")``; multi-pod ``("pod", "data",
"model")``; the serving mesh ``("data",)``.  Batch rows shard over every
data-parallel axis (``dp``); tensor or expert parallelism uses ``tp``
("model").  :class:`MeshAxes` and :func:`from_mesh` give the reference's
values for the same axis names and shape; with ``mesh=None`` every
helper is the identity, so the same code runs on one device.

Two execution models
--------------------
The reference runs every mesh under one controller.  The port splits
them by what PyTorch offers:

* **The serving mesh is one process over local devices**
  (:func:`local_mesh`).  The fleet keeps one admission queue and one
  supervisor, so one process keeps them.  Each device of the ``("data",)``
  axis holds a parameter copy; each tick's slots are split by rows along
  the axis (staged host-side, one bank a device:
  ``serve.transport.ShardedBank``), each shard's tick runs on its own
  device and current stream, and the outputs are gathered in slot order
  (``repro_torch.serve.engine_core``).  A mesh
  whose entries are all ``torch.device("cpu")`` stands in on the CPU for
  the reference's forced host devices.
* **Training collectives use one rank per device** over
  ``torch.distributed`` (:func:`rank_mesh`): one Python host per card, so
  a host-bound step does not run N times on one host.  Ranks start under
  ``torchrun`` on cards (NCCL), under ``torch.multiprocessing`` on the CPU
  (gloo).  ``psum`` / ``pmean`` become ``dist.all_reduce`` on an axis's
  process group (:func:`maybe_psum`), ``all_gather`` ``dist.all_gather``,
  ``axis_index`` ``dist.get_rank(group)``; ``ppermute`` becomes
  ``dist.batch_isend_irecv`` (``pipeline_parallel``).

A placement (:class:`Sharding`) maps a tensor onto the mesh:
:meth:`Sharding.place` returns one tensor per device on a local mesh, and
this rank's piece on a rank mesh (a replicated one: rank 0's tensor,
broadcast).  The reference's ``shard``
(``with_sharding_constraint``) is not ported: only its LM model code
calls it (ROADMAP.md queue 1 item 5.7).
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.optim.adamw import tree_leaves, tree_unflatten

AxisName = Union[str, Tuple[str, ...]]


class Mesh:
    """Named axes of ``shape`` (an ordered name -> size mapping, as JAX's
    ``mesh.shape``).  It spans local ``devices`` (one process, in
    row-major order over the axes), or the ranks of the default process
    group (``rank_mesh``: a process group for each set of axes a caller
    asks for), or neither (a shape only, which the parameter rules
    read)."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int], *,
                 devices: Optional[Sequence[torch.device]] = None):
        if len(axis_names) != len(sizes):
            raise ValueError(f"mesh axes {tuple(axis_names)} and sizes "
                             f"{tuple(sizes)} differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: "OrderedDict[str, int]" = OrderedDict(
            zip(self.axis_names, (int(s) for s in sizes)))
        self.size = math.prod(self.shape.values())
        self.devices: Optional[List[torch.device]] = None
        if devices is not None:
            self.devices = [torch.device(d) for d in devices]
            if len(self.devices) != self.size:
                raise ValueError(f"a {dict(self.shape)} mesh needs "
                                 f"{self.size} devices, got "
                                 f"{len(self.devices)}")
        self._groups: Dict[Tuple[str, ...], Any] = {}
        self.rank: Optional[int] = None      # set by rank_mesh

    def __repr__(self):
        where = (f"devices={[str(d) for d in self.devices]}"
                 if self.devices is not None else
                 f"rank={self.rank}" if self.rank is not None else "shape")
        return f"Mesh({dict(self.shape)}, {where})"

    @property
    def spans_ranks(self) -> bool:
        return self.rank is not None

    def _axes(self, axes: AxisName) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not in {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def coords(self, flat: int) -> Dict[str, int]:
        """The axis coordinates of entry ``flat`` (a rank, or a device's
        position in ``devices``), row-major as JAX lays out a mesh."""
        out = {}
        for name in reversed(self.axis_names):
            flat, out[name] = divmod(flat, self.shape[name])
        return {a: out[a] for a in self.axis_names}

    def index(self, flat: int, axes: AxisName) -> int:
        """Entry ``flat``'s position along ``axes`` (row-major over them),
        the piece of a row split over those axes that it holds."""
        c = self.coords(flat)
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def axis_size(self, axes: AxisName) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def group(self, axes: AxisName):
        """This rank's process group over ``axes`` (a name or a tuple of
        names): the ranks that differ from it only along those axes.
        Collective the first time a set of axes is asked for: every rank
        then builds one group for each bucket of ranks that agree on the
        other axes, in the same order (``dist.new_group`` is collective
        over the world), so every rank asks for the same axes in the same
        order, as the SPMD code that reduces over them does."""
        if not self.spans_ranks:
            raise ValueError(f"{self!r} spans no ranks: it has no process "
                             f"groups")
        axes = self._axes(axes)
        if axes not in self._groups:
            import torch.distributed as dist
            others = [a for a in self.axis_names if a not in axes]
            buckets: Dict[tuple, List[int]] = {}
            for r in range(self.size):
                c = self.coords(r)
                buckets.setdefault(tuple(c[a] for a in others), []).append(r)
            for ranks in buckets.values():
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axes] = g
        return self._groups[axes]


def local_mesh(devices: Sequence, axis_names: Sequence[str] = ("data",)
               ) -> Mesh:
    """A one-axis mesh over ``devices`` of this process (the serving
    model)."""
    devices = list(devices)
    return Mesh(axis_names, (len(devices),), devices=devices)


def rank_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh over every rank of the default process group, which must be
    initialised and hold ``prod(shape)`` ranks.  Its process groups are
    built when first asked for (:meth:`Mesh.group`)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("rank_mesh needs torch.distributed initialised "
                           "(torchrun on cards; torch.multiprocessing with "
                           "the gloo backend on the CPU)")
    mesh = Mesh(axis_names, shape)
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"a {dict(mesh.shape)} mesh needs {mesh.size} "
                         f"ranks; the process group holds {world}")
    mesh.rank = dist.get_rank()
    return mesh


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Which mesh axes play which logical role. ``mesh=None`` => local."""
    mesh: Optional[Mesh] = None
    dp: Tuple[str, ...] = ()       # data-parallel axes, e.g. ("pod","data")
    tp: Optional[str] = None       # tensor/expert-parallel axis ("model")
    zero: bool = True              # ZeRO-shard params over dp (False =>
    #                                replicate: small-model fast path)

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        n = 1
        for a in self.dp:
            n *= self.mesh.shape[a]
        return n

    @property
    def tp_size(self) -> int:
        if self.mesh is None or self.tp is None:
            return 1
        return self.mesh.shape[self.tp]

    @property
    def dp_spec(self) -> Optional[AxisName]:
        """Spec entry for a batch or token dim."""
        if not self.dp:
            return None
        return self.dp if len(self.dp) > 1 else self.dp[0]


def from_mesh(mesh: Optional[Mesh]) -> MeshAxes:
    """Derive roles from a mesh by axis name."""
    if mesh is None:
        return MeshAxes()
    names = mesh.axis_names
    dp = tuple(n for n in names if n in ("pod", "data", "replica"))
    tp = "model" if "model" in names else None
    return MeshAxes(mesh=mesh, dp=dp, tp=tp)


# ---------------------------------------------------------------------------
# Placement: rows split over the data axes, or a copy per device
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's placement on ``mesh``: dim ``dim`` split into equal
    pieces over ``axes`` (row-major over them, as a JAX spec entry
    ``("pod", "data")`` splits), or replicated when ``axes`` is empty."""
    mesh: Mesh
    axes: Tuple[str, ...] = ()
    dim: int = 0

    def piece(self, x: torch.Tensor, flat: int) -> torch.Tensor:
        """Entry ``flat``'s piece of ``x`` (a view on ``x``'s device)."""
        if not self.axes:
            return x
        n = self.mesh.axis_size(self.axes)
        rows = x.shape[self.dim]
        if rows % n:
            raise ValueError(f"dim {self.dim} of size {rows} does not "
                             f"split over {self.axes} ({n} pieces)")
        per = rows // n
        return x.narrow(self.dim, self.mesh.index(flat, self.axes) * per,
                        per)

    def place(self, x: torch.Tensor):
        """A local mesh: one tensor per device, each on its device.  A
        rank mesh: this rank's piece, on ``x``'s device; replicated, the
        mesh's first rank's ``x`` on every rank (a broadcast: collective,
        every rank of the mesh calls it)."""
        if self.mesh.spans_ranks:
            if not self.axes:
                import torch.distributed as dist
                group = self.mesh.group(self.mesh.axis_names)
                out = x.clone()
                dist.broadcast(out, dist.get_global_rank(group, 0),
                               group=group)
                return out
            return self.piece(x, self.mesh.rank)
        if self.mesh.devices is None:
            raise ValueError(f"{self.mesh!r} spans no devices or ranks")
        return [self.piece(x, i).to(d)
                for i, d in enumerate(self.mesh.devices)]


def batch_sharding(ax: MeshAxes, batch_dim: int = 0) -> Optional[Sharding]:
    """``batch_dim`` split over the data-parallel axes; ``None`` without a
    mesh."""
    if ax.mesh is None or not ax.dp:
        return None
    return Sharding(ax.mesh, tuple(ax.dp), batch_dim)


def replicated_sharding(ax: MeshAxes) -> Optional[Sharding]:
    """A copy per device or rank (parameters, a train state); ``None``
    without a mesh."""
    if ax.mesh is None:
        return None
    return Sharding(ax.mesh)


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor leaf of a tree of dicts, NamedTuples, lists
    and tuples (the structures ``optim.adamw.tree_leaves`` walks)."""
    return tree_unflatten(tree, [fn(x) for _, x in tree_leaves(tree)])


# ---------------------------------------------------------------------------
# Collectives over an axis's process group; the identity without one
# ---------------------------------------------------------------------------

def maybe_psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks (a new tensor); ``x``
    without a group."""
    if group is None:
        return x
    import torch.distributed as dist
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def maybe_all_gather(x: torch.Tensor, group, gather_axis: int
                     ) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``gather_axis``
    in rank order (JAX's ``all_gather(tiled=True)``); ``x`` without a
    group."""
    if group is None:
        return x
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=gather_axis)


def axis_index(group) -> int:
    """This rank's position in ``group``; 0 without a group."""
    if group is None:
        return 0
    import torch.distributed as dist
    return dist.get_rank(group)


# ---------------------------------------------------------------------------
# Parameter sharding rules (path-name based), the reference's
# ---------------------------------------------------------------------------

# Substring rules applied to the '/'-joined param path.  First match wins.
# Specs are written for the *unstacked* layer params; stacked leading
# dims get a leading None each.  "DP" / "TP" resolve against the
# MeshAxes.
_RULES: Sequence[Tuple[str, Optional[Tuple]]] = (
    # embeddings / output head: (vocab, d_model)
    ("tok_embed",        ("TP", "DP")),
    ("lm_head",          ("TP", "DP")),
    ("pos_embed",        (None, "TP")),
    ("frontend_proj",    ("DP", "TP")),
    # attention
    ("attn/wq",          ("DP", "TP")),
    ("attn/wk",          ("DP", "TP")),
    ("attn/wv",          ("DP", "TP")),
    ("attn/wo",          ("TP", "DP")),
    ("attn/bq",          ("TP",)),
    ("attn/bk",          ("TP",)),
    ("attn/bv",          ("TP",)),
    # MLA
    ("mla/wq_a",         ("DP", None)),
    ("mla/wq_b",         ("DP", "TP")),
    ("mla/wkv_a",        ("DP", None)),
    ("mla/wkv_b",        ("DP", "TP")),
    ("mla/wo",           ("TP", "DP")),
    # dense mlp
    ("mlp/wi",           ("DP", "TP")),
    ("mlp/wg",           ("DP", "TP")),
    ("mlp/wo",           ("TP", "DP")),
    # MoE: experts sharded over TP (expert parallelism), ZeRO over DP
    ("moe/router",       (None, None)),
    ("moe/wi",           ("TP", "DP", None)),
    ("moe/wg",           ("TP", "DP", None)),
    ("moe/wo",           ("TP", None, "DP")),
    ("moe/shared_wi",    ("DP", "TP")),
    ("moe/shared_wg",    ("DP", "TP")),
    ("moe/shared_wo",    ("TP", "DP")),
    # mamba: d_inner sharded over TP
    ("mamba/in_proj",    ("DP", "TP")),
    ("mamba/conv_w",     (None, "TP")),
    ("mamba/conv_b",     ("TP",)),
    ("mamba/x_proj",     ("TP", "DP")),
    ("mamba/dt_proj",    ("DP", "TP")),
    ("mamba/dt_bias",    ("TP",)),
    ("mamba/A_log",      ("TP", None)),
    ("mamba/D",          ("TP",)),
    ("mamba/out_proj",   ("TP", "DP")),
    # xlstm
    ("mlstm/w_qkv",      ("DP", "TP")),
    ("mlstm/w_gates",    ("DP", "TP")),
    ("mlstm/out_proj",   ("TP", "DP")),
    ("slstm/",           (None, None)),
    # norms / scalars: replicated
    ("norm",             None),
    ("scale",            None),
    ("bias",             None),
)

Spec = Tuple[Optional[AxisName], ...]


def _resolve(entry, ax: MeshAxes):
    if entry == "DP":
        return ax.dp_spec if ax.zero else None
    if entry == "TP":
        return ax.tp
    return entry


def spec_for_path(path: str, shape: Tuple[int, ...], ax: MeshAxes) -> Spec:
    """The spec of one parameter: per dimension an axis name, a tuple of
    names, or None (the reference's ``PartitionSpec`` entries); ``()``
    (replicated) when no rule matches."""
    ndim = len(shape)
    for key, rule in _RULES:
        if key in path:
            if rule is None:
                return ()
            # stacked params carry extra leading dims
            pad = ndim - len(rule)
            full = (None,) * pad + tuple(_resolve(r, ax) for r in rule)
            # drop a shard on a dim the axis size does not divide
            out = []
            for dim, s in zip(shape, full):
                if s is None:
                    out.append(None)
                    continue
                size = 1
                for a in (s if isinstance(s, tuple) else (s,)):
                    size *= ax.mesh.shape[a] if ax.mesh else 1
                out.append(s if size > 0 and dim % size == 0 else None)
            return tuple(out)
    return ()


def param_sharding_rules(params, ax: MeshAxes):
    """A tree shaped like ``params`` holding each leaf's spec (None for
    every leaf without a mesh).  Paths are ``optim.adamw.tree_leaves``'s,
    JAX's path strings."""
    leaves = tree_leaves(params)
    if ax.mesh is None:
        return tree_unflatten(params, [None] * len(leaves))
    return tree_unflatten(params, [spec_for_path(p, tuple(x.shape), ax)
                                   for p, x in leaves])
