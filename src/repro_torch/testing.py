"""The parity rule for spikes, shared by the tests and ``chip_smoke.py``,
a plain replay of the norm kernels' statistics contract, and the slab
occupancy mask that ``chip_smoke.py`` counts the fused conv's live work
with.

Two implementations of a spiking layer agree when their pre-activations
agree to float rounding, so a spike can only flip where the reference
membrane sits within that rounding of the threshold.  After a neuron's
first flip its two trajectories legitimately diverge (the hard reset
differs), so the rule looks at each neuron's FIRST mismatch only: there
the reference membrane must lie within ``tol`` of ``v_th``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.layers import NORM_EPS
from repro_torch.core.lif import f32_decay
from repro_torch.kernels.blocks import CANONICAL_K_BLOCK, DEFAULT_BM

CLASSES = 32                # row classes of the statistics contract


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


def norm_lif_contract_stats(y: torch.Tensor, eps: float = NORM_EPS
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The statistics of the norm kernels' contract (``csrc/
    lif_common.cuh``), replayed on the CPU: y [T, B, HW, C] -> (mu, r),
    each float32 [B, C].  Per (b, c) the rows i = t * HW + hw fall into
    32 classes, i mod 32; each class is summed in increasing i in
    float64, one row at a time; the 32 class sums are added in class
    order; the total over the row count rounds to float32.  The variance
    sums (y - mu)^2, each term in float32, the same way; r = 1 /
    sqrt(var + eps) in float32."""
    T, B, HW, C = y.shape
    R = T * HW
    rows = y.detach().to("cpu", torch.float32).permute(1, 0, 2, 3) \
        .reshape(B, R, C)
    pad = (-R) % CLASSES
    # rows past R are zeros: adding +0.0 leaves a sum (never -0.0) as it is
    rows = torch.cat([rows, rows.new_zeros(B, pad, C)], dim=1) \
        .reshape(B, -1, CLASSES, C)

    def total(terms):
        acc = torch.zeros(B, CLASSES, C, dtype=torch.float64)
        for j in range(terms.shape[1]):
            acc = acc + terms[:, j].double()
        tot = torch.zeros(B, C, dtype=torch.float64)
        for k in range(CLASSES):
            tot = tot + acc[:, k]
        return tot

    mu = (total(rows) / R).float()
    d = rows - mu[:, None, None, :]
    # padded rows must add nothing: their (0 - mu)^2 is replaced by 0
    live = (torch.arange(rows.shape[1] * CLASSES) < R).reshape(
        1, -1, CLASSES, 1)
    var = (total(torch.where(live, d * d, torch.zeros(()))) / R).float()
    one = torch.ones((), dtype=torch.float32)
    r = one / torch.sqrt(var + torch.tensor(eps, dtype=torch.float32))
    return mu, r


def norm_affine_lif_contract(y: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, *, tau: float = 2.0,
                             v_th: float = 1.0, v_reset: float = 0.0,
                             eps: float = NORM_EPS) -> torch.Tensor:
    """The norm kernels' spikes, replayed on the CPU as separate float32
    torch ops in the kernels' order (``norm_lif_contract_stats``, then
    ``repro::norm_lif_step`` per step): y [T, B, HW, C] -> spikes
    [T, B, HW, C] on the CPU.  The bit-level oracle of
    ``norm_affine_lif``'s kernel."""
    T, B, HW, C = y.shape
    mu, r = norm_lif_contract_stats(y, eps)
    f32 = dict(dtype=torch.float32)
    mu, r = mu[:, None, :], r[:, None, :]
    sc = scale.detach().to("cpu", torch.float32)
    bi = bias.detach().to("cpu", torch.float32)
    decay = torch.tensor(f32_decay(tau), **f32)
    vr, vt = torch.tensor(v_reset, **f32), torch.tensor(v_th, **f32)
    one = torch.ones((), **f32)
    yc = y.detach().to("cpu", torch.float32)
    u = torch.full((B, HW, C), float(vr), **f32)
    out = []
    for t in range(T):
        z = (yc[t] - mu) * r
        z = z * sc + bi
        u = decay * (u - vr) + vr + z
        s = ((u - vt) >= 0).to(torch.float32)
        u = u * (one - s) + vr * s
        out.append(s)
    return torch.stack(out)


def slab_occupancy_mask(x3: torch.Tensor, *,
                        bm: int = DEFAULT_BM) -> torch.Tensor:
    """Per-(batch, row chunk, canonical K block) occupancy of the batched
    patch slab x3 [B, T*HW, K]: int32 [B, ceil(T*HW/bm), ceil(K/128)],
    1 where the tile holds a live activation (a copy of the reference's
    ``slab_occupancy_mask``; K is padded here, not by the caller)."""
    B, THW, K = x3.shape
    pr, pk = (-THW) % bm, (-K) % CANONICAL_K_BLOCK
    if pr or pk:
        x3 = F.pad(x3, (0, pk, 0, pr))
    t = x3.reshape(B, (THW + pr) // bm, bm, (K + pk) // CANONICAL_K_BLOCK,
                   CANONICAL_K_BLOCK)
    return (t != 0).any(dim=4).any(dim=2).to(torch.int32)
