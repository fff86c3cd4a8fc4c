"""Leaky Integrate-and-Fire neurons with surrogate gradients (paper
§IV-B), the plain PyTorch counterpart of ``repro.core.lif``.

    u_t = decay * (u_{t-1} - v_reset) + v_reset + I_t      (integrate+leak)
    s_t = H(u_t - v_th)                                     (fire)
    u_t = u_t * (1 - s_t) + v_reset * s_t                   (hard reset)

``decay`` is ``exp(-1/tau)`` evaluated in float32 (``f32_decay``), the
value the reference and the CUDA kernels use; Python's ``math.exp``
rounds in float64 first and can differ in the last bit.  Every step is
a separate elementwise op, so each intermediate rounds to float32 —
the kernels replay exactly this order with non-contracting intrinsics.

The Heaviside H has no derivative; its backward is the sigmoid surrogate
H'(x) ~ beta * sigma(beta x) * (1 - sigma(beta x)), so autograd through
``lif_scan`` is the BPTT the paper trains with.  The spike enters the
hard reset too, so the reset carries its surrogate gradient as well.
"""
from __future__ import annotations

from typing import Tuple

import torch


def f32_decay(tau: float) -> float:
    """exp(-1/tau) evaluated in float32, returned as the Python float of
    that float32 value (exact, so ``decay * tensor`` multiplies by the
    float32 constant without a device copy)."""
    return float(torch.exp(torch.tensor(-1.0 / tau, dtype=torch.float32)))


def surrogate_grad(x: torch.Tensor, beta: float) -> torch.Tensor:
    """H'(x) ~ beta * sigma(beta x) * (1 - sigma(beta x))."""
    s = torch.sigmoid(beta * x)
    return beta * s * (1.0 - s)


class _Spike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, beta):
        ctx.save_for_backward(x)
        ctx.beta = beta
        return (x >= 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        s = torch.sigmoid(ctx.beta * x)
        # the reference's order: g * beta * s * (1 - s)
        return g * ctx.beta * s * (1.0 - s), None


def spike(x: torch.Tensor, beta: float = 4.0) -> torch.Tensor:
    """Heaviside H(x) = [x >= 0] with the sigmoid surrogate gradient."""
    return _Spike.apply(x, beta)


def lif_step(u, i_t, *, decay: float, v_th: float, v_reset: float,
             beta: float = 4.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LIF timestep. u: membrane potential; i_t: input current."""
    u = decay * (u - v_reset) + v_reset + i_t
    s = spike(u - v_th, beta)
    u = u * (1.0 - s) + v_reset * s
    return u, s


def lif_scan(currents: torch.Tensor, *, tau: float = 2.0, v_th: float = 1.0,
             v_reset: float = 0.0, beta: float = 4.0) -> torch.Tensor:
    """Multi-step LIF. currents: [T, ...] -> spikes [T, ...]."""
    decay = f32_decay(tau)
    u = torch.full_like(currents[0], v_reset)
    out = []
    for t in range(currents.shape[0]):
        u, s = lif_step(u, currents[t], decay=decay, v_th=v_th,
                        v_reset=v_reset, beta=beta)
        out.append(s)
    return torch.stack(out)
