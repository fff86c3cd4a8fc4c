"""The parity rule for spikes, shared by the tests and ``chip_smoke.py``.

Two implementations of a spiking layer agree when their pre-activations
agree to float rounding, so a spike can only flip where the reference
membrane sits within that rounding of the threshold.  After a neuron's
first flip its two trajectories legitimately diverge (the hard reset
differs), so the rule looks at each neuron's FIRST mismatch only: there
the reference membrane must lie within ``tol`` of ``v_th``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.lif import f32_decay


def lif_trajectory(currents, *, tau: float = 2.0, v_th: float = 1.0,
                   v_reset: float = 0.0):
    """Replay the LIF over currents [T, ...] in float32 -> (x, s): the
    pre-threshold distance ``u_t - v_th`` and the spikes, each [T, ...]."""
    z = np.asarray(currents, np.float32)
    decay = np.float32(f32_decay(tau))
    vr, vt = np.float32(v_reset), np.float32(v_th)
    u = np.full(z.shape[1:], vr, np.float32)
    xs, ss = [], []
    for t in range(z.shape[0]):
        u = decay * (u - vr) + vr + z[t]
        x = u - vt
        s = (x >= 0).astype(np.float32)
        u = u * (np.float32(1) - s) + vr * s
        xs.append(x)
        ss.append(s)
    return np.stack(xs), np.stack(ss)


def spike_mismatch(ref_currents, spikes, *, tol: float, tau: float = 2.0,
                   v_th: float = 1.0, v_reset: float = 0.0) -> Dict[str, int]:
    """Hold ``spikes`` [T, ...] to the reference LIF over
    ``ref_currents`` [T, ...] under the near-threshold rule.  Returns
    counts of neurons: ``flipped`` (any mismatch), ``far`` (first
    mismatch with the reference membrane further than ``tol`` from
    threshold — a real disagreement) and ``near`` (membrane within
    ``tol`` of threshold at some step)."""
    if isinstance(spikes, torch.Tensor):
        spikes = spikes.detach().cpu().numpy()
    if isinstance(ref_currents, torch.Tensor):
        ref_currents = ref_currents.detach().cpu().numpy()
    x, s_ref = lif_trajectory(ref_currents, tau=tau, v_th=v_th,
                              v_reset=v_reset)
    T = x.shape[0]
    x = x.reshape(T, -1)
    diff = (s_ref.reshape(T, -1) != np.asarray(spikes).reshape(T, -1))
    flipped = diff.any(axis=0)
    first = diff.argmax(axis=0)
    x_first = x[first, np.arange(x.shape[1])]
    far = flipped & (np.abs(x_first) > tol)
    near = (np.abs(x) <= tol).any(axis=0)
    return {"flipped": int(flipped.sum()), "far": int(far.sum()),
            "near": int(near.sum())}
