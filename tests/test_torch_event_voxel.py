"""Port parity: the event-voxelization kernel's wrapper
(``repro_torch.kernels.event_voxel``, its plain version on the CPU) and
the ``"cuda"`` encoding backend against the JAX package's jnp reference,
bit-exact — the case list of tests/test_event_voxel.py: every mode and
out-of-range policy, empty streams, boundary timestamps, the signed
channels and a shape sweep — plus the batched EventStream plumbing
(stacking, concatenation, padding, budgeting with and without a
generator).  A generator draws other numbers than a JAX key, so the
random budget is held to its properties instead."""
import jax
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro_torch.core.encoding import (OOB_POLICIES, VOXEL_MODES,
                                       EventStream, budget_events,
                                       concat_streams, events_to_voxel,
                                       events_to_voxel_batch, fit_stream,
                                       pad_stream, stack_streams,
                                       voxel_batch)
from repro_torch.kernels.event_voxel import event_voxel

T, H, W = 5, 16, 12


def _leaves(seed, batch=2, n=96, ragged=0.7, oob=True):
    """Numpy [B, N] leaves with ragged masks and, with ``oob``,
    out-of-range coordinates, timestamps and polarities."""
    rng = np.random.default_rng(seed)
    lo, hi = (-3, 3) if oob else (0, 0)
    t_lo, t_hi = (-0.4, 1.5) if oob else (0.0, 1.0)
    return (rng.uniform(t_lo, t_hi, (batch, n)).astype(np.float32),
            rng.integers(lo, W + hi, (batch, n)).astype(np.int32),
            rng.integers(lo, H + hi, (batch, n)).astype(np.int32),
            rng.integers(-1 if oob else 0, 3 if oob else 2,
                         (batch, n)).astype(np.int32),
            rng.random((batch, n)) < ragged)


def _torch(leaves):
    return EventStream(*(torch.tensor(a) for a in leaves))


def _jax_grid(leaves, time_steps=T, **kw):
    fn = jax.jit(lambda e: jenc.events_to_voxel_batch(
        e, time_steps=time_steps, height=H, width=W, **kw))
    return np.asarray(fn(jenc.EventStream(*leaves)))


def _kernel(leaves, time_steps=T, **kw):
    return event_voxel(_torch(leaves), time_steps=time_steps, height=H,
                       width=W, **kw).numpy()


@pytest.mark.parametrize("mode", VOXEL_MODES)
@pytest.mark.parametrize("oob", OOB_POLICIES)
def test_backend_parity_all_modes(mode, oob):
    leaves = _leaves(VOXEL_MODES.index(mode) * 10 + OOB_POLICIES.index(oob))
    got = _kernel(leaves, mode=mode, oob=oob)
    assert got.shape == (2, T, H, W, 2)
    np.testing.assert_array_equal(got, _jax_grid(leaves, mode=mode, oob=oob))


def test_empty_stream_is_zero_grid():
    leaves = _leaves(3, ragged=0.0)
    for mode in VOXEL_MODES:
        got = _kernel(leaves, mode=mode)
        assert np.abs(got).sum() == 0.0
        np.testing.assert_array_equal(got, _jax_grid(leaves, mode=mode))


def test_single_window_and_time_major_forms():
    """events_to_voxel per window == the batch == the time-major
    ``voxel_batch`` on both encoding backends == JAX voxel_batch."""
    leaves = _leaves(11, batch=3)
    kw = dict(time_steps=T, height=H, width=W, mode="count")
    ev = _torch(leaves)
    batch = events_to_voxel_batch(ev, **kw)
    one = torch.stack([events_to_voxel(EventStream(*(a[i] for a in ev)),
                                       **kw) for i in range(3)])
    assert torch.equal(one, batch)
    want = np.asarray(jenc.voxel_batch(jenc.EventStream(*leaves), **kw))
    for backend in ("torch", "cuda"):
        tm = voxel_batch(ev, backend=backend, **kw)
        assert tm.shape == (T, 3, H, W, 2)
        np.testing.assert_array_equal(tm.numpy(), want)
    with pytest.raises(ValueError, match="encoding backend"):
        voxel_batch(ev, backend="pallas", **kw)


def test_boundary_timestamp_policy_explicit():
    """t == window aliases into the last bin under "clip" and is
    dropped under "drop"; t < 0 aliases into bin 0 or is dropped."""
    def one(tval):
        return (np.full((1, 1), tval, np.float32), np.full((1, 1), 2, np.int32),
                np.full((1, 1), 3, np.int32), np.ones((1, 1), np.int32),
                np.ones((1, 1), bool))

    at_window = _kernel(one(1.0), mode="count", oob="clip")
    assert at_window[0, T - 1, 3, 2, 1] == 1.0 and at_window.sum() == 1.0
    assert _kernel(one(1.0), mode="count", oob="drop").sum() == 0.0
    assert _kernel(one(-0.3), mode="count", oob="clip")[0, 0, 3, 2, 1] == 1.0
    assert _kernel(one(-0.3), mode="count", oob="drop").sum() == 0.0
    np.testing.assert_array_equal(_kernel(one(0.5), mode="count", oob="clip"),
                                  _kernel(one(0.5), mode="count", oob="drop"))
    for tval in (1.0, -0.3, 0.5):
        for oob in OOB_POLICIES:
            np.testing.assert_array_equal(
                _kernel(one(tval), mode="count", oob=oob),
                _jax_grid(one(tval), mode="count", oob=oob))


def test_signed_mode_channels():
    """signed: channel 0 = ON - OFF, channel 1 = ON + OFF."""
    leaves = _leaves(5, oob=False)
    cnt = _kernel(leaves, mode="count")
    sgn = _kernel(leaves, mode="signed")
    np.testing.assert_array_equal(sgn[..., 0], cnt[..., 1] - cnt[..., 0])
    np.testing.assert_array_equal(sgn[..., 1], cnt[..., 1] + cnt[..., 0])
    np.testing.assert_array_equal(_kernel(leaves, mode="binary"),
                                  (cnt > 0).astype(np.float32))


@pytest.mark.parametrize("shape", [(1, 1), (1, 300), (4, 257), (2, 1024)])
@pytest.mark.parametrize("tsteps", [1, 4, 9])
def test_backend_parity_shape_sweep(shape, tsteps):
    B, N = shape
    leaves = _leaves(B * 1000 + N + tsteps, batch=B, n=N)
    for mode in VOXEL_MODES:
        np.testing.assert_array_equal(
            _kernel(leaves, time_steps=tsteps, mode=mode, oob="drop"),
            _jax_grid(leaves, time_steps=tsteps, mode=mode, oob="drop"))


def test_legacy_binary_flag():
    leaves = _leaves(8, batch=1)
    one_t = EventStream(*(torch.tensor(a[0]) for a in leaves))
    one_j = jenc.EventStream(*(a[0] for a in leaves))
    kw = dict(time_steps=T, height=H, width=W)
    for binary in (True, False):
        np.testing.assert_array_equal(
            events_to_voxel(one_t, binary=binary, **kw).numpy(),
            np.asarray(jenc.events_to_voxel(one_j, binary=binary, **kw)))
    assert torch.equal(events_to_voxel(one_t, binary=False, **kw),
                       events_to_voxel(one_t, mode="count", **kw))
    # an explicit mode overrides the flag
    assert torch.equal(events_to_voxel(one_t, binary=False, mode="binary",
                                       **kw),
                       events_to_voxel(one_t, **kw))


def test_pad_stream_batched_pads_capacity_axis_only():
    leaves = _leaves(2, batch=2, n=10)
    ev = _torch(leaves)
    out = pad_stream(ev, 32)
    assert out.t.shape == (2, 32)
    assert torch.equal(out.num_events(), ev.num_events())
    np.testing.assert_array_equal(
        ev.num_events().numpy(),
        np.asarray(jenc.EventStream(*leaves).num_events()))
    assert not bool(out.valid[:, 10:].any())
    assert fit_stream(ev, 10).t.shape == (2, 10)
    kw = dict(time_steps=T, height=H, width=W, mode="count")
    assert torch.equal(events_to_voxel_batch(out, **kw),
                       events_to_voxel_batch(ev, **kw))


@pytest.mark.parametrize("budget", [8, 40, 64])
def test_budget_events_batched_matches_jax(budget):
    """Earliest-first budgeting of a [B, N] stream, per window, equals
    the reference's leaf for leaf (ties broken by buffer position)."""
    leaves = list(_leaves(4, batch=3, n=40, ragged=0.8))
    leaves[0][:, 5:9] = leaves[0][:, 0:1]            # tied timestamps
    got = budget_events(_torch(leaves), budget)
    want = jenc.budget_events(jenc.EventStream(*leaves), budget)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.t.shape == (3, budget)
    fit = fit_stream(_torch(leaves), budget)
    wfit = jenc.fit_stream(jenc.EventStream(*leaves), budget)
    for g, w in zip(fit, wfit):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("batched", [False, True])
def test_budget_events_random_subsample_properties(batched):
    """With a generator: exactly min(live, budget) live events survive,
    each one of the window's live events, and the same seed gives the
    same result."""
    leaves = _leaves(6, batch=3, n=50, ragged=0.6)
    ev = _torch(leaves)
    windows = [ev] if batched else [EventStream(*(a[i] for a in ev))
                                    for i in range(3)]
    for w in windows:
        for budget in (5, 29, 80):
            sub = budget_events(w, budget, torch.Generator().manual_seed(7))
            again = budget_events(w, budget,
                                  torch.Generator().manual_seed(7))
            for a, b in zip(sub, again):
                assert torch.equal(a, b)
            assert sub.capacity == budget
            live = w.num_events()
            assert torch.equal(sub.num_events(),
                               torch.clamp(live, max=budget))
            rows = zip(*(a.reshape(-1, a.shape[-1]) for a in w),
                       *(a.reshape(-1, budget) for a in sub))
            for t, x, y, p, v, st, sx, sy, sp, sv in rows:
                src = {(float(a), int(b), int(c), int(d)) for a, b, c, d, e
                       in zip(t, x, y, p, v) if e}
                kept = [(float(a), int(b), int(c), int(d)) for a, b, c, d, e
                        in zip(st, sx, sy, sp, sv) if e]
                assert set(kept) <= src and len(set(kept)) == len(kept)
    other = budget_events(ev, 5, torch.Generator().manual_seed(8))
    assert not torch.equal(other.t, budget_events(
        ev, 5, torch.Generator().manual_seed(7)).t)


def test_stack_and_concat_streams_match_jax():
    rng = np.random.default_rng(9)
    singles = [tuple(a[0] for a in _leaves(int(s), batch=1, n=n))
               for s, n in zip(rng.integers(0, 100, 3), (7, 20, 13))]
    got = stack_streams([_torch(s) for s in singles])
    want = jenc.stack_streams([jenc.EventStream(*s) for s in singles])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert stack_streams([_torch(singles[0])], capacity=32).t.shape == (1, 32)
    a, b = _leaves(1, batch=2, n=5), _leaves(2, batch=2, n=9)
    got = concat_streams(_torch(a), _torch(b))
    want = jenc.concat_streams(jenc.EventStream(*a), jenc.EventStream(*b))
    assert got.t.shape == (2, 14)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        stack_streams([])
    with pytest.raises(ValueError):
        concat_streams()


def test_invalid_args_rejected():
    ev = _torch(_leaves(1))
    kw = dict(time_steps=T, height=H, width=W)
    with pytest.raises(ValueError, match="mode"):
        event_voxel(ev, mode="typo", **kw)
    with pytest.raises(ValueError, match="oob"):
        event_voxel(ev, oob="typo", **kw)
    with pytest.raises(ValueError, match="mode"):
        events_to_voxel(EventStream(*(a[0] for a in ev)), mode="typo", **kw)
    with pytest.raises(TypeError, match="valid"):
        event_voxel(ev._replace(valid=ev.valid.to(torch.int32)), **kw)
    with pytest.raises(ValueError, match=r"\[B, N\]"):
        event_voxel(EventStream(*(a[0] for a in ev)), **kw)
    with pytest.raises(ValueError, match="budget"):
        budget_events(ev, 0)


# timestamps the reference bins by XLA's saturating float32 -> int32 cast
NONFINITE_T = (np.nan, np.inf, -np.inf, 1e10, -1e10, 3e9, -3e9)


@pytest.mark.parametrize("mode", VOXEL_MODES)
@pytest.mark.parametrize("oob", OOB_POLICIES)
def test_nonfinite_timestamps_match_jax(mode, oob):
    """NaN bins to 0, +inf and values past the int32 range to its top
    and -inf to its bottom, as the reference's cast: under ``drop`` a
    NaN event is kept in bin 0, under ``clip`` a +inf event lands in
    bin T-1 (a plain int64 cast gives INT64_MIN for all three)."""
    t, x, y, p, valid = _leaves(40 + VOXEL_MODES.index(mode), n=64,
                                oob=False)
    for i, v in enumerate(NONFINITE_T):
        t[:, 3 * i:3 * i + 3] = v
    leaves = (t, x, y, p, np.ones_like(valid))
    got = _kernel(leaves, mode=mode, oob=oob)
    np.testing.assert_array_equal(got, _jax_grid(leaves, mode=mode, oob=oob))
    # each special timestamp alone, so its own bin is pinned
    for v in NONFINITE_T:
        one = (np.full((1, 1), v, np.float32), np.zeros((1, 1), np.int32),
               np.zeros((1, 1), np.int32), np.ones((1, 1), np.int32),
               np.ones((1, 1), bool))
        np.testing.assert_array_equal(_kernel(one, mode=mode, oob=oob),
                                      _jax_grid(one, mode=mode, oob=oob),
                                      err_msg=str(v))
