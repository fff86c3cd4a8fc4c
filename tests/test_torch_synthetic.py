"""Port parity: the synthetic scene generator (``repro_torch.data.synthetic``)
against the JAX package's ``repro.data.synthetic`` on the CPU.

The port never reproduces JAX's PRNG: each generator splits into a draw
function (the port's own ``torch.Generator``) and a builder of the scene
from the draws.  These tests make the reference's draws with the
reference's key splits (``jax.random``, here only), feed them to the
port's builders and hold the result to the reference's generator, jitted
once per shape: boxes, ``valid`` and ``clean_rgb`` equal, ``bayer``
within 1e-6, the events' ``t`` equal and ``x``/``y``/``p``/``valid``
equal except for an event whose float position lies within 1e-6 of a
pixel edge (counted; under 0.1% of the events).  The scenarios and the
token stream likewise.  Then the reference's generator regressions
(``tests/test_detector_training.py``: the whole event budget used, noise
uniform over the field of view), the scenario properties of
``tests/test_properties.py``, determinism in the seed, and the training
and eval streams' seeds disjoint by construction.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic as R
from repro_torch.configs.registry import TRAIN_CONFIGS
from repro_torch.data import synthetic as S
from repro_torch.train.detector import make_data_fn, resolve_snn_config

EDGE_TOL = 1e-6
MAX_EDGE_SHARE = 1e-3
SCENE_SHAPES = {"64x64": dict(height=64, width=64, max_boxes=4,
                              n_events=2048, batch=4),
                "32x32": dict(height=32, width=32, max_boxes=4,
                              n_events=512, batch=3),
                "37x53": dict(height=37, width=53, max_boxes=3,
                              n_events=700, batch=3)}
SCEN_KW = dict(height=37, width=53, n_events=1000)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the reference's draws, by its own key splits
# ---------------------------------------------------------------------------

def _jax_scene_draws(key, *, max_boxes, n_events, height, width):
    """``repro.data.synthetic.make_scene``'s draws for ``key``."""
    M, N = max_boxes, n_events
    ks = jax.random.split(key, 9)
    k1, k2, k3, k4, k5, k6 = jax.random.split(ks[5], 6)
    return dict(
        n_obj=jax.random.randint(ks[0], (), 1, M + 1),
        cls=jax.random.bernoulli(ks[1], 0.5, (M,)),
        cxy=jax.random.uniform(ks[2], (M, 2), minval=0.2, maxval=0.8),
        wh=jax.random.uniform(ks[3], (M, 2), minval=0.12, maxval=0.35),
        vel=jax.random.uniform(ks[4], (M, 2), minval=-1.0, maxval=1.0),
        motion=dict(t=jax.random.uniform(k1, (N,)),
                    u=jax.random.uniform(k2, (N,)),
                    side=jax.random.randint(k3, (N,), 0, 4),
                    noise_u=jax.random.uniform(k4, (N,)),
                    nu=jax.random.uniform(k5, (N, 2)),
                    coin=jax.random.bernoulli(k6, 0.5, (N,))),
        normal=jax.random.normal(ks[6], (height, width)),
        defect_u=jax.random.uniform(ks[7], (height, width)),
        hot_u=jax.random.uniform(ks[8], (height, width)))


def _scene_draws(d) -> S.SceneDraws:
    motion = S.MotionDraws(**{k: _t(v) for k, v in d["motion"].items()})
    return S.SceneDraws(**{k: motion if k == "motion" else _t(v)
                           for k, v in d.items()})


def _jax_scenario_draws(name, key, *, n_events, window=1.0, **kw):
    """The draws of the reference's ``SCENARIOS[name]`` at its defaults
    (but ``n_events``/``window``) for ``key``, as the port's draw type."""
    N = n_events
    if name == "moving_bar":
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        return S.BarDraws(
            t=jax.random.uniform(k1, (N,), maxval=window),
            along=jax.random.uniform(k2, (N,)),
            lead=jax.random.bernoulli(k3, 0.5, (N,)),
            noise=jax.random.bernoulli(k4, 0.02, (N,)),
            nx=jax.random.uniform(k5, (N, 2)))
    if name == "flicker":
        k1, k2, k3, k4 = jax.random.split(key, 4)
        return S.FlickerDraws(
            centre=jax.random.uniform(k1, (2,), minval=0.25, maxval=0.75),
            edge=jax.random.randint(k2, (N,), 0, S._transitions(3.0, window)),
            jitter=jax.random.normal(k3, (N,)),
            offs=jax.random.normal(k4, (N, 2)))
    if name == "noise_burst":
        k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
        return S.BurstDraws(
            t_bg=jax.random.uniform(k1, (N,), maxval=window),
            burst_t0=jax.random.uniform(k2, (), maxval=window * (1 - 0.08)),
            in_burst=jax.random.bernoulli(k3, 0.6, (N,)),
            streak=jax.random.randint(k4, (N,), 0, 12),
            streak_x=jax.random.uniform(k5, (12,)),
            u=jax.random.uniform(k6, (N, 3)))
    ks = jax.random.split(key, 5)
    per = N // 3
    return S.CrossingDraws(
        side=jax.random.randint(ks[0], (3,), 0, 4),
        lane=jax.random.uniform(ks[1], (3,), minval=0.2, maxval=0.8),
        t=jax.random.uniform(ks[2], (3, per), maxval=window),
        u=jax.random.uniform(ks[3], (3, per, 2)),
        perm=jax.random.permutation(ks[4], per * 3))


_BUILDERS = {
    "moving_bar": (S.build_moving_bar, dict(rate=1.0, speed=0.6,
                                            bar_width=0.08, vertical=True)),
    "flicker": (S.build_flicker, dict(rate=0.12, flicker_hz=3.0,
                                      source_radius=0.08)),
    "noise_burst": (S.build_noise_burst, dict(rate=1.0, burst_width=0.08)),
    "crossing": (S.build_crossing, dict(rate=0.8, obj_size=0.12)),
}


@functools.lru_cache(maxsize=None)
def _jit_scene_batch(batch, height, width, max_boxes, n_events):
    return jax.jit(functools.partial(
        R.make_scene_batch, batch=batch, height=height, width=width,
        max_boxes=max_boxes, n_events=n_events))


def _edge_positions(draws: S.SceneDraws, boxes, width, height):
    """The events' float positions (ex * W, ey * H) in float64 from the
    draws by the reference's formula, for the near-edge rule."""
    d = draws.motion
    M = boxes.shape[-2]
    obj = np.arange(d.t.shape[-1]) % M
    b = boxes.numpy().astype(np.float64)[..., obj, :]
    v = draws.vel.numpy().astype(np.float64)[..., obj, :]
    t, u, side = (x.numpy().astype(np.float64) for x in (d.t, d.u, d.side))
    cx = b[..., 1] + v[..., 0] * (t - 0.5) * 0.2
    cy = b[..., 2] + v[..., 1] * (t - 0.5) * 0.2
    bw, bh = b[..., 3], b[..., 4]
    ex = np.where(side % 2 == 0, cx + (u - 0.5) * bw,
                  cx + np.where(side == 1, bw / 2, -bw / 2))
    ey = np.where(side % 2 == 1, cy + (u - 0.5) * bh,
                  cy + np.where(side == 0, -bh / 2, bh / 2))
    noise = d.noise_u.numpy() < 0.02
    nu = d.nu.numpy().astype(np.float64)
    ex = np.where(noise, nu[..., 0], ex)
    ey = np.where(noise, nu[..., 1], ey)
    return ex * width, ey * height


def _near_edge(pos, scale):
    return np.abs(pos - np.round(pos)) < EDGE_TOL * scale


def _check_events(got, want, near):
    """x/y/p/valid equal except where ``near``; t equal; the events
    counted near an edge under MAX_EDGE_SHARE."""
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))
    diff = np.zeros(got.x.shape, bool)
    for f in ("x", "y", "p", "valid"):
        diff |= getattr(got, f).numpy() != np.asarray(getattr(want, f))
    assert not (diff & ~near).any(), f"{int((diff & ~near).sum())} events " \
        "differ away from a pixel edge"
    assert near.mean() < MAX_EDGE_SHARE, near.mean()


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SCENE_SHAPES))
def test_scene_batch_builder_matches_reference(shape):
    kw = SCENE_SHAPES[shape]
    B, H, W = kw["batch"], kw["height"], kw["width"]
    key = jax.random.PRNGKey(7)
    ref = _jit_scene_batch(B, H, W, kw["max_boxes"], kw["n_events"])(key)
    d = jax.vmap(lambda k: _jax_scene_draws(
        k, max_boxes=kw["max_boxes"], n_events=kw["n_events"], height=H,
        width=W))(jax.random.split(key, B))
    draws = _scene_draws(d)
    ev, bayer, boxes, valid, clean = S.build_scene(draws, height=H, width=W)
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(ref.boxes))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(clean.numpy(), np.asarray(ref.clean_rgb))
    np.testing.assert_allclose(bayer.numpy(), np.asarray(ref.bayer),
                               rtol=0, atol=1e-6)
    px, py = _edge_positions(draws, boxes, W, H)
    _check_events(ev, ref.events, _near_edge(px, W) | _near_edge(py, H))


def test_make_scene_builder_matches_reference():
    """One scene, unbatched, at a non-default photometry."""
    H, W, M, N = 37, 53, 4, 600
    kw = dict(height=H, width=W, max_boxes=M, n_events=N, lighting=0.7,
              wb_drift=(1.2, 0.8), noise_sigma=0.05, defect_rate=0.01)
    key = jax.random.PRNGKey(11)
    ref = jax.jit(functools.partial(R.make_scene, **kw))(key)
    draws = _scene_draws(_jax_scene_draws(key, max_boxes=M, n_events=N,
                                          height=H, width=W))
    ev, bayer, boxes, valid, clean = S.build_scene(
        draws, height=H, width=W, lighting=0.7, wb_drift=(1.2, 0.8),
        noise_sigma=0.05, defect_rate=0.01)
    r_ev, r_bayer, r_boxes, r_valid, r_clean = ref
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(r_boxes))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(r_valid))
    np.testing.assert_array_equal(clean.numpy(), np.asarray(r_clean))
    np.testing.assert_allclose(bayer.numpy(), np.asarray(r_bayer), rtol=0,
                               atol=1e-6)
    px, py = _edge_positions(draws, boxes, W, H)
    _check_events(ev, r_ev, _near_edge(px, W) | _near_edge(py, H))


@pytest.mark.parametrize("name", sorted(S.SCENARIOS))
def test_scenario_builder_matches_reference(name):
    B = 3
    key = jax.random.PRNGKey(5)
    ref = jax.jit(functools.partial(R.make_scenario_batch, name, batch=B,
                                    **SCEN_KW))(key)
    d = jax.vmap(lambda k: _jax_scenario_draws(
        name, k, n_events=SCEN_KW["n_events"]))(jax.random.split(key, B))
    build, kw = _BUILDERS[name]
    got = build(type(d)(*(_t(x) for x in d)), window=1.0, **SCEN_KW, **kw)
    for f in ("x", "y", "p", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=0,
                               atol=1e-6)
    # the public generator gives the same window layout
    one = S.make_scenario(name, torch.Generator().manual_seed(0),
                          device="cpu", **SCEN_KW)
    assert [tuple(x.shape) for x in one] == [(SCEN_KW["n_events"],)] * 5
    assert [x.dtype for x in one] == [x.dtype for x in got]


def test_token_batch_builder_matches_reference():
    key = jax.random.PRNGKey(3)
    b, s, V = 3, 17, 50
    ref = R.make_token_batch(key, b, s, V)
    k1, k2 = jax.random.split(key)
    got = S.build_token_batch(
        _t(jax.random.randint(k1, (b, s), 0, V)).long(),
        _t(jax.random.bernoulli(k2, 0.5, (b, s))), V)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    out = S.make_token_batch(torch.Generator().manual_seed(1), b, s, V,
                             device="cpu")
    assert out["tokens"].shape == (b, s)
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < V)).all())
    torch.testing.assert_close(out["labels"][:, :-1], out["tokens"][:, 1:])


# ---------------------------------------------------------------------------
# the reference's generator regressions (test_detector_training.py:149-183)
# ---------------------------------------------------------------------------

def _boxes(M=4):
    return torch.cat([torch.zeros(M, 1), torch.full((M, 2), 0.5),
                      torch.full((M, 2), 0.2)], -1)


def test_event_budget_fully_used():
    """n_events % M is not dropped: 10 events over 4 moving valid boxes
    -> all 10 live."""
    d = S._motion_draws(torch.Generator().manual_seed(0), (10,))
    ev = S._events_from_motion(d, _boxes(4), torch.ones(4, dtype=torch.bool),
                               torch.full((4, 2), 0.5), 64, 64)
    assert ev.valid.shape == (10,)
    assert int(ev.valid.sum()) == 10


def test_noise_events_uniform_not_box_locked():
    """With every box invalid only background noise fires, uniform over
    the field of view with a fair-coin polarity."""
    d = S._motion_draws(torch.Generator().manual_seed(1), (8192,))
    ev = S._events_from_motion(d, _boxes(4), torch.zeros(4, dtype=torch.bool),
                               torch.full((4, 2), 0.5), 64, 64)
    v = ev.valid.numpy()
    x = ev.x.numpy()[v] / 64.0
    y = ev.y.numpy()[v] / 64.0
    assert 50 < v.sum() < 1000             # ~2% noise rate
    assert x.std() > 0.2 and y.std() > 0.2
    for q in (x < 0.25, x > 0.75, y < 0.25, y > 0.75):
        assert q.mean() > 0.1
    p = ev.p.numpy()[v]
    assert 0.3 < p.mean() < 0.7


# ---------------------------------------------------------------------------
# scenario properties (test_properties.py:82-120), seeded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(S.SCENARIOS))
def test_scenarios_in_bounds_budgeted_and_deterministic(name):
    rng = np.random.default_rng(0)
    for _ in range(6):
        seed = int(rng.integers(0, 2 ** 20))
        h, w = (int(v) for v in rng.integers(8, 49, 2))
        n = int(rng.integers(16, 513))
        kw = dict(height=h, width=w, n_events=n, device="cpu")
        ev = S.make_scenario(name, torch.Generator().manual_seed(seed), **kw)
        assert ev.capacity == n
        assert int(ev.num_events()) <= n
        assert bool(((ev.x >= 0) & (ev.x < w)).all())
        assert bool(((ev.y >= 0) & (ev.y < h)).all())
        assert bool(((ev.p >= 0) & (ev.p <= 1)).all())
        assert bool(((ev.t >= 0.0) & (ev.t < 1.0)).all())
        again = S.make_scenario(name, torch.Generator().manual_seed(seed),
                                **kw)
        assert all(torch.equal(a, b) for a, b in zip(ev, again))
        other = S.make_scenario(name,
                                torch.Generator().manual_seed(seed + 1), **kw)
        assert any(not torch.equal(a, c) for a, c in zip(ev, other))
    batch = S.make_scenario_batch(name, torch.Generator().manual_seed(2), 3,
                                  **SCEN_KW, device="cpu")
    assert [tuple(x.shape) for x in batch] == [(3, SCEN_KW["n_events"])] * 5


# ---------------------------------------------------------------------------
# determinism and the data streams
# ---------------------------------------------------------------------------

def test_scene_batch_deterministic_in_the_seed():
    kw = dict(batch=2, height=32, width=32, n_events=256, device="cpu")
    a = S.make_scene_batch(torch.Generator().manual_seed(3), **kw)
    b = S.make_scene_batch(torch.Generator().manual_seed(3), **kw)
    c = S.make_scene_batch(torch.Generator().manual_seed(4), **kw)
    la, lb, lc = (jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, x)) for x in (a, b, c))
    assert all(np.array_equal(x, y) for x, y in zip(la, lb))
    assert not all(np.array_equal(x, y) for x, y in zip(la, lc))
    ev, bayer, boxes, valid, clean = S.make_scene(
        torch.Generator().manual_seed(3), height=32, width=32,
        n_events=256, device="cpu")
    assert ev.t.shape == (256,) and bayer.shape == (32, 32)
    assert boxes.shape == (4, 5) and clean.shape == (32, 32, 3)
    assert bool(valid[0]) and 0.0 <= float(bayer.min()) <= \
        float(bayer.max()) <= 1.0


def test_train_and_eval_streams_disjoint():
    """Every training step's seed differs from every eval batch's, also
    when the two roots are equal; the training data is a function of
    the step alone."""
    tc = TRAIN_CONFIGS["detector_smoke"]
    train = {S.stream_generator(tc.seed, s).initial_seed()
             for s in range(tc.steps)}
    for root in (tc.eval_seed, tc.seed):
        ev = {S.stream_generator(root, i, S.EVAL_STREAM).initial_seed()
              for i in range(tc.eval_batches)}
        assert len(ev) == tc.eval_batches and not train & ev
    assert len(train) == tc.steps
    cfg = resolve_snn_config(tc)
    data = make_data_fn(tc, cfg, device="cpu")
    a, b, c = data(5), data(5), data(6)
    assert torch.equal(a.bayer, b.bayer) and torch.equal(a.events.x,
                                                         b.events.x)
    assert not torch.equal(a.bayer, c.bayer)
    assert a.bayer.shape == (tc.batch, cfg.height, cfg.width)
    assert a.events.t.shape == (tc.batch, tc.n_events)
    assert a.boxes.shape == (tc.batch, tc.max_boxes, 5)

