"""Port parity: DVS event encoding against the JAX package's jnp
reference (repro.core.encoding), bit-exact — every mode and out-of-range
policy, ragged validity masks, out-of-bounds coordinates and
timestamps, empty streams — plus the stream budgeting that admission
uses."""
import jax
import numpy as np
import pytest
import torch

from repro.core.encoding import EventStream as JaxEventStream
from repro.core.encoding import events_to_voxel_batch as jax_voxel_batch
from repro.core.encoding import fit_stream as jax_fit_stream
from repro_torch.core.encoding import (EventStream, events_to_voxel,
                                       events_to_voxel_batch, fit_stream,
                                       pad_stream)

T, H, W = 3, 16, 12


def _events(seed, B, N, *, empty_rows=(), window=1.0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-0.05, 1.05, (B, N)).astype(np.float32) * window
    t[:, :3] = np.float32(window)            # boundary timestamps
    x = rng.integers(-2, W + 2, (B, N)).astype(np.int32)
    y = rng.integers(-2, H + 2, (B, N)).astype(np.int32)
    p = rng.integers(-1, 3, (B, N)).astype(np.int32)
    valid = rng.random((B, N)) < 0.8         # ragged validity
    for b in empty_rows:
        valid[b] = False                     # an empty stream
    return t, x, y, p, valid


@pytest.mark.parametrize("mode", ["binary", "count", "signed"])
@pytest.mark.parametrize("oob", ["clip", "drop"])
@pytest.mark.parametrize("window", [1.0, 0.5])
def test_voxel_batch_bitexact(mode, oob, window):
    leaves = _events(7, 4, 600, empty_rows=(2,), window=window)
    kw = dict(time_steps=T, height=H, width=W, window=window, mode=mode,
              oob=oob)
    want = np.asarray(jax.jit(lambda e: jax_voxel_batch(e, **kw))(
        JaxEventStream(*leaves)))
    got = events_to_voxel_batch(
        EventStream(*(torch.tensor(a) for a in leaves)), **kw).numpy()
    assert got.shape == (4, T, H, W, 2)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[2]).sum() == 0          # the empty stream
    assert np.abs(got).sum() > 0


def test_single_window_matches_batch():
    leaves = _events(3, 2, 100)
    ev = EventStream(*(torch.tensor(a) for a in leaves))
    batch = events_to_voxel_batch(ev, time_steps=T, height=H, width=W)
    one = events_to_voxel(EventStream(*(a[1] for a in ev)), time_steps=T,
                          height=H, width=W)
    torch.testing.assert_close(one, batch[1], rtol=0, atol=0)
    with pytest.raises(ValueError):
        events_to_voxel_batch(ev, time_steps=T, height=H, width=W,
                              mode="onehot")


@pytest.mark.parametrize("n,capacity", [(50, 64), (64, 64), (200, 64)])
def test_fit_stream_matches_jax(n, capacity):
    t, x, y, p, valid = (a[0] for a in _events(n, 1, n))
    want = jax_fit_stream(JaxEventStream(t, x, y, p, valid), capacity)
    got = fit_stream(EventStream(*(torch.tensor(a)
                                   for a in (t, x, y, p, valid))), capacity)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert got.capacity == capacity


def test_pad_stream_rejects_shrink():
    ev = EventStream(*(torch.zeros(4, dtype=d) for d in
                       (torch.float32, torch.int32, torch.int32, torch.int32,
                        torch.bool)))
    assert pad_stream(ev, 6).valid.tolist() == [False] * 6
    with pytest.raises(ValueError):
        pad_stream(ev, 2)
