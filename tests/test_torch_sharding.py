"""The port's mesh plumbing (``repro_torch.distributed.sharding``,
``repro_torch.launch.mesh``) held to the reference's on the CPU:

- ``MeshAxes`` / ``from_mesh`` / ``dp_size`` / ``tp_size`` / ``dp_spec``
  on the reference's axis layouts, the reference given a duck-typed mesh
  (``SimpleNamespace(shape=..., axis_names=...)``: it reads only those);
- ``spec_for_path`` on every ``_RULES`` path, on divisible and
  indivisible shapes, with stacked leading dims and with ``zero=False``,
  equal to the reference's ``PartitionSpec`` entries;
- ``param_sharding_rules`` on the port's reduced qwen2-7b parameter tree
  (as numpy for the reference, on an ``AbstractMesh``) against the
  reference's ``.spec`` leaf by leaf;
- ``make_serving_mesh``'s and ``make_mesh_for``'s divisor search against
  the reference's, with ``jax.devices`` / ``jax.make_mesh`` replaced by
  counters;
- a local mesh's placement: rows split over its devices in order, a copy
  per device, the refusals.

The rank meshes and their collectives run on 4 gloo ranks in
tests/test_torch_distributed.py.
"""
import dataclasses
import itertools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.distributed import sharding as ref
from repro.launch import mesh as ref_mesh
from repro_torch.configs.registry import reduced
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (Mesh, MeshAxes, Sharding,
                                              batch_sharding, local_mesh,
                                              replicated_sharding)
from repro_torch.launch import mesh as port_mesh
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import tree_leaves

LAYOUTS = [
    (("data", "model"), (2, 4)),
    (("pod", "data", "model"), (2, 16, 16)),
    (("pod", "data", "model"), (2, 2, 2)),
    (("data",), (8,)),
    (("replica", "data"), (2, 2)),
    (("model",), (4,)),
    (("data", "model"), (1, 1)),
]


def _axes(names, sizes, zero=True):
    """(port MeshAxes, reference MeshAxes) of one layout; names None is
    no mesh."""
    if names is None:
        return MeshAxes(), ref.MeshAxes()
    duck = types.SimpleNamespace(shape=dict(zip(names, sizes)),
                                 axis_names=tuple(names))
    p, r = sharding.from_mesh(Mesh(names, sizes)), ref.from_mesh(duck)
    return (dataclasses.replace(p, zero=zero),
            dataclasses.replace(r, zero=zero))


@pytest.mark.parametrize("names,sizes", LAYOUTS + [(None, None)])
def test_mesh_axes_match_reference(names, sizes):
    p, r = _axes(names, sizes)
    assert (p.dp, p.tp, p.zero) == (r.dp, r.tp, r.zero)
    assert (p.dp_size, p.tp_size, p.dp_spec) == \
        (r.dp_size, r.tp_size, r.dp_spec)
    if names is not None:
        assert dict(p.mesh.shape) == dict(zip(names, sizes))
        assert p.mesh.axis_names == tuple(names)


def test_rules_are_the_reference_rules():
    assert [(k, None if v is None else tuple(v))
            for k, v in sharding._RULES] == \
        [(k, None if v is None else tuple(v)) for k, v in ref._RULES]


def _rule_cases():
    """(path, shape) of every rule: divisible (64s), indivisible (3s),
    mixed, and with one and two stacked leading dims."""
    for key, rule in sharding._RULES:
        nd = 2 if rule is None else len(rule)
        path = f"layers/0/{key}" if "/" in key else key
        for dims in ((64,) * nd, (3,) * nd, (64, 3, 64)[:nd],
                     (3, 64, 3)[:nd], (5,) + (64,) * nd,
                     (2, 6) + (48,) * nd):
            yield path, dims
    yield "unmatched/leaf", (64, 64)


@pytest.mark.parametrize("zero", [True, False])
@pytest.mark.parametrize("names,sizes", LAYOUTS + [(None, None)])
def test_spec_for_path_matches_reference(names, sizes, zero):
    p, r = _axes(names, sizes, zero)
    n = 0
    for path, shape in _rule_cases():
        want = tuple(ref.spec_for_path(path, shape, r))
        assert sharding.spec_for_path(path, shape, p) == want, (path, shape)
        n += 1
    assert n == 6 * len(sharding._RULES) + 1


def test_spec_for_path_pads_stacked_dims_and_drops_indivisible():
    p, _ = _axes(("data", "model"), (2, 4))
    assert sharding.spec_for_path("layers/0/attn/wq", (5, 64, 64), p) == \
        (None, "data", "model")
    assert sharding.spec_for_path("layers/0/attn/wq", (64, 6), p) == \
        ("data", None)
    assert sharding.spec_for_path("final/scale", (64,), p) == ()
    q, _ = _axes(("pod", "data", "model"), (2, 2, 2))
    assert sharding.spec_for_path("tok_embed", (8, 8), q) == \
        ("model", ("pod", "data"))


@pytest.mark.parametrize("names,sizes", [(("data", "model"), (2, 4)),
                                         (("pod", "data", "model"),
                                          (2, 2, 4)), (None, None)])
def test_param_sharding_rules_match_reference_on_qwen2(names, sizes):
    cfg = dataclasses.replace(reduced("qwen2-7b"), dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    tree = jax.tree_util.tree_map(lambda t: t.numpy(), params)
    if names is None:
        got = sharding.param_sharding_rules(params, MeshAxes())
        want = ref.param_sharding_rules(tree, ref.MeshAxes())
        assert all(v is None for _, v in tree_leaves(got))
        assert all(v is None for v in jax.tree_util.tree_leaves(
            want, is_leaf=lambda x: x is None))
        return
    p = sharding.from_mesh(Mesh(names, sizes))
    r = ref.from_mesh(AbstractMesh(sizes, names))
    got = sharding.param_sharding_rules(params, p)
    want = dict((jax.tree_util.keystr(k, simple=True, separator="/"),
                 tuple(v.spec)) for k, v in
                jax.tree_util.tree_flatten_with_path(
                    ref.param_sharding_rules(tree, r))[0])
    spec_paths = [k for k, _ in tree_leaves(params)]
    assert len(spec_paths) == len(want) > 10
    sharded = 0
    for path in spec_paths:
        spec = _leaf_at(got, path)
        assert spec == want[path], path
        sharded += any(s is not None for s in spec)
    assert sharded > 0


def _leaf_at(tree, path):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


@pytest.mark.parametrize("n", range(1, 10))
def test_serving_mesh_divisor_search_matches_reference(monkeypatch, n):
    monkeypatch.setattr(jax, "devices", lambda *a: list(range(n)))
    monkeypatch.setattr(jax, "make_mesh",
                        lambda shape, axes, **kw: (tuple(shape), tuple(axes)))
    cpu = [torch.device("cpu")] * n
    for batch, cap in itertools.product((None, 1, 2, 3, 4, 6, 7, 8, 12),
                                        (None, 1, 2, 3, 5)):
        # the reference's max_devices cap is the port's first devices
        want = ref_mesh.make_serving_mesh(batch, cap)
        got = port_mesh.make_serving_mesh(batch, devices=cpu[:cap])
        if want is None:
            assert got is None, (batch, cap)
            continue
        assert (tuple(got.shape.values()), got.axis_names) == want
        assert got.devices == cpu[:want[0][0]]


def test_serving_mesh_counts_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = port_mesh.make_serving_mesh(6)          # 3 of 4 divide 6
    assert mesh.devices == [torch.device("cuda", i) for i in range(3)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert port_mesh.make_serving_mesh(8) is None


def test_mesh_for_divisor_search_matches_reference(monkeypatch):
    monkeypatch.setattr(jax, "make_mesh",
                        lambda shape, axes, **kw: (tuple(shape), tuple(axes)))
    for devices in list(range(1, 33)) + [48, 64, 128, 192, 240, 256, 512]:
        for mp in (None, 1, 2, 3, 4, 8, 16):
            want = ref_mesh.make_mesh_for(devices, mp)
            assert (port_mesh.elastic_shape(devices, mp),
                    ("data", "model")) == want, (devices, mp)


def test_rank_meshes_need_a_process_group():
    with pytest.raises(RuntimeError, match="torch.distributed"):
        port_mesh.make_mesh_for(4)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        port_mesh.make_production_mesh(multi_pod=True)
    assert port_mesh.PRODUCTION_SHAPES[True][0] == (2, 16, 16)


def test_local_mesh_placement():
    cpu = torch.device("cpu")
    mesh = local_mesh([cpu] * 4)
    ax = sharding.from_mesh(mesh)
    x = torch.arange(24.0).reshape(8, 3)
    pieces = batch_sharding(ax).place(x)
    assert [p.shape for p in pieces] == [(2, 3)] * 4
    assert torch.equal(torch.cat(pieces), x)
    cols = batch_sharding(ax, 1).place(torch.arange(8.0)[None].repeat(2, 1))
    assert [p[0].tolist() for p in cols] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    reps = replicated_sharding(ax).place(x)
    assert len(reps) == 4 and all(torch.equal(r, x) for r in reps)
    assert batch_sharding(MeshAxes()) is None
    assert replicated_sharding(MeshAxes()) is None
    with pytest.raises(ValueError, match="does not split"):
        batch_sharding(ax).place(torch.zeros(6))


def test_mesh_layout_is_row_major():
    m = Mesh(("pod", "data", "model"), (2, 3, 4))
    for flat in range(m.size):
        c = m.coords(flat)
        assert (c["pod"], c["data"], c["model"]) == np.unravel_index(
            flat, (2, 3, 4))
        assert m.index(flat, ("pod", "data")) == c["pod"] * 3 + c["data"]
        assert m.index(flat, "model") == c["model"]
    assert m.axis_size(("data", "model")) == 12


def test_mesh_refusals():
    with pytest.raises(ValueError, match="needs 4 devices"):
        Mesh(("data",), (4,), devices=[torch.device("cpu")] * 3)
    with pytest.raises(ValueError, match="differ in length"):
        Mesh(("data", "model"), (4,))
    m = local_mesh([torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="spans no ranks"):
        m.group("data")
    with pytest.raises(ValueError, match="not in"):
        m.axis_size("model")
    with pytest.raises(ValueError, match="spans no devices"):
        Sharding(Mesh(("data",), (2,)), ("data",)).place(torch.zeros(2))


def test_collectives_are_the_identity_without_a_group():
    x = torch.arange(4.0)
    assert sharding.maybe_psum(x, None) is x
    assert sharding.maybe_all_gather(x, None, 0) is x
    assert sharding.axis_index(None) == 0
