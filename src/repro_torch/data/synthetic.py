"""Synthetic GEN1-like scenes: moving objects -> DVS events + Bayer frame
+ detection ground truth, the counterpart of ``repro.data.synthetic``;
also the four DVS scenario windows and the LM token stream.

Every generator comes in two parts:

- a private ``_*_draws`` function makes the raw random draws (uniforms,
  normals, integers, coin flips, a permutation) from an explicit CPU
  ``torch.Generator``; the port never reproduces JAX's PRNG;
- a ``build_*`` function computes the scene from those draws, on the
  draws' device, with the reference's float32 arithmetic in the
  reference's order (a divisor is a float32 tensor, not a Python scalar,
  which a card would turn into a multiply by its reciprocal).

So the reference's own draws, carried across as numpy, give the
reference's scene, and one seed gives the same events, boxes and
``valid`` on the CPU and on the card (the frame's ``** 2.2`` may differ
in its last bit).  Builders take any leading batch shape.

Data keyed on a step (``stream_generator``) is seeded from
``(root, index)`` in a named stream, so the training stream and the
held-out eval stream never share a seed, whatever their roots.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.encoding import EventStream, pad_stream
from repro_torch.device import resolve_device
from repro_torch.isp.demosaic import bayer_phases

F32 = torch.float32
TRAIN_STREAM, EVAL_STREAM = 0, 1


class SceneBatch(NamedTuple):
    events: EventStream      # leaves [B, N]
    bayer: torch.Tensor      # [B, H, W] RGGB mosaic (noisy, miscoloured)
    boxes: torch.Tensor      # [B, M, 5] (cls, cx, cy, w, h) normalised
    valid: torch.Tensor      # [B, M] bool
    clean_rgb: torch.Tensor  # [B, H, W, 3] ground-truth image (for PSNR)


def stream_generator(root: int, index: int,
                     stream: int = TRAIN_STREAM) -> torch.Generator:
    """A CPU generator for item ``index`` of ``stream`` under ``root``
    (e.g. a training step under ``TrainConfig.seed``): seeded through
    ``np.random.SeedSequence([root, index])`` with ``stream`` as its
    spawn key, so two streams differ even at equal roots."""
    ss = np.random.SeedSequence([root, index], spawn_key=(stream,))
    return torch.Generator().manual_seed(
        int(ss.generate_state(1, np.uint64)[0]))


def _on(draws, device):
    return type(draws)(*(d.to(device) for d in draws))


def _div(x: torch.Tensor, d) -> torch.Tensor:
    return x / torch.tensor(d, dtype=F32, device=x.device)


def _uniform(gen, shape, lo=0.0, hi=1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def _coin(gen, shape, p=0.5) -> torch.Tensor:
    return torch.rand(shape, generator=gen) < p


def _linspace01(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in float32: i * (1 / (n - 1)), the last
    point exactly 1 (``torch.linspace`` counts its second half down
    from the end, other bits)."""
    if n == 1:
        return torch.zeros(1, dtype=F32, device=device)
    step = _div(torch.ones((), dtype=F32, device=device), float(n - 1))
    return torch.cat([torch.arange(n - 1, dtype=F32, device=device) * step,
                      torch.ones(1, dtype=F32, device=device)])


def _remainder(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.remainder``: fmod, moved to the divisor's sign."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


# ---------------------------------------------------------------------------
# Detection scenes
# ---------------------------------------------------------------------------

class MotionDraws(NamedTuple):
    """``_events_from_motion``'s draws, leaves [..., N]."""
    t: torch.Tensor          # uniform [0, 1): the event's time
    u: torch.Tensor          # uniform: position along the edge
    side: torch.Tensor       # int in [0, 4): which edge
    noise_u: torch.Tensor    # uniform: < 0.02 makes a noise event
    nu: torch.Tensor         # [..., N, 2] uniform: a noise event's place
    coin: torch.Tensor       # bool: a noise event's polarity


class SceneDraws(NamedTuple):
    n_obj: torch.Tensor      # [...] int in [1, M]
    cls: torch.Tensor        # [..., M] bool
    cxy: torch.Tensor        # [..., M, 2] uniform [0.2, 0.8)
    wh: torch.Tensor         # [..., M, 2] uniform [0.12, 0.35)
    vel: torch.Tensor        # [..., M, 2] uniform [-1, 1)
    motion: MotionDraws      # leaves [..., N]
    normal: torch.Tensor     # [..., H, W] standard normal: sensor noise
    defect_u: torch.Tensor   # [..., H, W] uniform: < rate is defective
    hot_u: torch.Tensor      # [..., H, W] uniform: > 0.5 reads hot


def _motion_draws(gen, shape) -> MotionDraws:
    return MotionDraws(
        t=_uniform(gen, shape), u=_uniform(gen, shape),
        side=torch.randint(0, 4, shape, generator=gen),
        noise_u=_uniform(gen, shape), nu=_uniform(gen, shape + (2,)),
        coin=_coin(gen, shape))


def _scene_draws(gen, shape, *, max_boxes, n_events, height,
                 width) -> SceneDraws:
    M = max_boxes
    return SceneDraws(
        n_obj=torch.randint(1, M + 1, shape, generator=gen),
        cls=_coin(gen, shape + (M,)),
        cxy=_uniform(gen, shape + (M, 2), 0.2, 0.8),
        wh=_uniform(gen, shape + (M, 2), 0.12, 0.35),
        vel=_uniform(gen, shape + (M, 2), -1.0, 1.0),
        motion=_motion_draws(gen, shape + (n_events,)),
        normal=torch.randn(shape + (height, width), generator=gen),
        defect_u=_uniform(gen, shape + (height, width)),
        hot_u=_uniform(gen, shape + (height, width)))


def _render_boxes(boxes, valid, height: int, width: int) -> torch.Tensor:
    """Filled boxes [..., M, 5] painted in order -> rgb [..., H, W, 3]."""
    dev = boxes.device
    yy, xx = torch.meshgrid(_linspace01(height, dev),
                            _linspace01(width, dev), indexing="ij")
    img = torch.full(boxes.shape[:-2] + (height, width, 3), 0.45,
                     dtype=F32, device=dev)
    pedestrian = torch.tensor([0.85, 0.3, 0.25], dtype=F32, device=dev)
    car = torch.tensor([0.25, 0.45, 0.85], dtype=F32, device=dev)
    for m in range(boxes.shape[-2]):
        cls, cx, cy, bw, bh = (boxes[..., m, i, None, None] for i in range(5))
        inside = (((xx - cx).abs() < bw / 2) & ((yy - cy).abs() < bh / 2)
                  & valid[..., m, None, None])
        color = torch.where(cls[..., None] > 0.5, pedestrian, car)
        img = torch.where(inside[..., None], color, img)
    return img


def _events_from_motion(d: MotionDraws, boxes, valid, vel, height: int,
                        width: int) -> EventStream:
    """Events at moving object edges: a point on one edge of each box
    (round-robin over the M boxes, the whole budget used) at its event
    time, ON on the leading edge and OFF on the trailing one; 2% of the
    budget is background noise, uniform over the field of view with a
    coin-flip polarity (never locked to a box, valid or not)."""
    M = boxes.shape[-2]
    obj = torch.arange(d.t.shape[-1], device=boxes.device) % M
    b = boxes[..., obj, :]
    v = vel[..., obj, :]
    t, u, side = d.t, d.u, d.side
    cx = b[..., 1] + v[..., 0] * (t - 0.5) * 0.2
    cy = b[..., 2] + v[..., 1] * (t - 0.5) * 0.2
    bw, bh = b[..., 3], b[..., 4]
    ex = torch.where(side % 2 == 0, cx + (u - 0.5) * bw,
                     cx + torch.where(side == 1, bw / 2, -bw / 2))
    ey = torch.where(side % 2 == 1, cy + (u - 0.5) * bh,
                     cy + torch.where(side == 0, -bh / 2, bh / 2))
    lead = (ex - cx) * v[..., 0] + (ey - cy) * v[..., 1] > 0
    pol = lead.to(torch.int32)
    ok = valid[..., obj] & (v.abs().sum(-1) > 0.05)
    noise = d.noise_u < 0.02
    ex = torch.where(noise, d.nu[..., 0], ex)
    ey = torch.where(noise, d.nu[..., 1], ey)
    pol = torch.where(noise, d.coin.to(torch.int32), pol)
    ok = ok | noise
    x = torch.clamp((ex * width).to(torch.int32), 0, width - 1)
    y = torch.clamp((ey * height).to(torch.int32), 0, height - 1)
    return EventStream(t=t, x=x, y=y, p=pol, valid=ok)


def build_scene(d: SceneDraws, *, height: int, width: int,
                lighting: float = 1.0,
                wb_drift: Tuple[float, float] = (1.0, 1.0),
                noise_sigma: float = 0.02, defect_rate: float = 0.002):
    """Scenes from their draws -> (events, bayer, boxes, valid, clean),
    each with the draws' leading shape."""
    dev = d.cxy.device
    M = d.cls.shape[-1]
    boxes = torch.cat([d.cls.to(F32)[..., None], d.cxy, d.wh], dim=-1)
    valid = torch.arange(M, device=dev) < d.n_obj[..., None]
    events = _events_from_motion(d.motion, boxes, valid, d.vel, height,
                                 width)
    clean = _render_boxes(boxes, valid, height, width)
    # photometric corruption the ISP must undo: clean_rgb is the
    # display-referred truth, the sensor captures linear light
    # (display^2.2), which the ISP's default gamma LUT decodes back
    lit = torch.clamp(clean * lighting, 0.0, 1.0)
    drift = torch.tensor([wb_drift[0], 1.0, wb_drift[1]], dtype=F32,
                         device=dev)
    shifted = torch.clamp(lit * drift, 0.0, 1.0) ** 2.2
    is_r, _, _, is_b = bayer_phases(height, width, device=dev)
    mosaic = torch.where(is_r, shifted[..., 0],
                         torch.where(is_b, shifted[..., 2], shifted[..., 1]))
    mosaic = mosaic + noise_sigma * d.normal
    defects = d.defect_u < defect_rate
    mosaic = torch.where(defects, (d.hot_u > 0.5).to(F32), mosaic)
    mosaic = torch.clamp(mosaic, 0.0, 1.0)
    return events, mosaic, boxes, valid, clean


def make_scene(gen: torch.Generator, *, height: int = 64, width: int = 64,
               max_boxes: int = 4, n_events: int = 2048,
               time_steps: int = 5, lighting: float = 1.0,
               wb_drift: Tuple[float, float] = (1.0, 1.0),
               noise_sigma: float = 0.02, defect_rate: float = 0.002,
               device="cuda"):
    """One scene -> (events [N], bayer [H, W], boxes [M, 5], valid [M],
    clean [H, W, 3]) on ``device``.  ``time_steps`` is accepted for the
    reference's signature; events carry a continuous time."""
    return _scene(gen, (), height=height, width=width, max_boxes=max_boxes,
                  n_events=n_events, lighting=lighting, wb_drift=wb_drift,
                  noise_sigma=noise_sigma, defect_rate=defect_rate,
                  device=device)


def make_scene_batch(gen: torch.Generator, batch: int = 8, *,
                     height: int = 64, width: int = 64, max_boxes: int = 4,
                     n_events: int = 2048, time_steps: int = 5,
                     lighting: float = 1.0,
                     wb_drift: Tuple[float, float] = (1.0, 1.0),
                     noise_sigma: float = 0.02, defect_rate: float = 0.002,
                     device="cuda") -> SceneBatch:
    """``batch`` scenes (``make_scene``'s) as a SceneBatch on ``device``."""
    ev, bayer, boxes, valid, clean = _scene(
        gen, (batch,), height=height, width=width, max_boxes=max_boxes,
        n_events=n_events, lighting=lighting, wb_drift=wb_drift,
        noise_sigma=noise_sigma, defect_rate=defect_rate, device=device)
    return SceneBatch(events=ev, bayer=bayer, boxes=boxes, valid=valid,
                      clean_rgb=clean)


def _scene(gen, shape, *, height, width, max_boxes, n_events, device,
           **photometry):
    d = _scene_draws(gen, shape, max_boxes=max_boxes, n_events=n_events,
                     height=height, width=width)
    dev = resolve_device(device)
    d = SceneDraws(*(_on(x, dev) if isinstance(x, MotionDraws) else x.to(dev)
                     for x in d))
    return build_scene(d, height=height, width=width, **photometry)


# ---------------------------------------------------------------------------
# DVS scenario windows (paper §IV-A ingestion regimes)
# ---------------------------------------------------------------------------
#
# Each emits one bounded event window per sample for a named sensing
# regime: ego-motion (dense, coherent), night flicker (sparse, bursty),
# rain/noise bursts (dense, incoherent) and multi-object crossings
# (several coherent sources).  Coordinates are in bounds, the live
# fraction of the ``n_events`` budget is ``rate``.  ``batch=None`` gives
# [N] leaves, ``batch=B`` [B, N].

def _finish_events(t, x, y, p, n_live: int, *, height: int, width: int,
                   window: float) -> EventStream:
    """Clip into bounds, mask to the live budget."""
    n = t.shape[-1]
    valid = torch.arange(n, device=t.device) < n_live
    return EventStream(
        t=torch.clamp(t, 0.0, window * (1.0 - 1e-6)).to(F32),
        x=torch.clamp(x.to(torch.int32), 0, width - 1),
        y=torch.clamp(y.to(torch.int32), 0, height - 1),
        p=torch.clamp(p.to(torch.int32), 0, 1),
        valid=valid.expand(t.shape).contiguous())


class BarDraws(NamedTuple):
    t: torch.Tensor          # [..., N] uniform [0, window)
    along: torch.Tensor      # [..., N] uniform: position along the bar
    lead: torch.Tensor       # [..., N] bool: leading (ON) edge
    noise: torch.Tensor      # [..., N] bool: a noise event
    nx: torch.Tensor         # [..., N, 2] uniform: a noise event's place


def build_moving_bar(d: BarDraws, *, height: int, width: int,
                     n_events: int, window: float, rate: float,
                     speed: float, bar_width: float,
                     vertical: bool) -> EventStream:
    centre = _remainder(0.1 + _div(speed * d.t, window), 1.0)
    across = centre + torch.where(d.lead, bar_width / 2, -bar_width / 2)
    across = torch.where(d.noise, d.nx[..., 0], across)
    along = torch.where(d.noise, d.nx[..., 1], d.along)
    xf, yf = (across, along) if vertical else (along, across)
    return _finish_events(d.t, xf * width, yf * height, d.lead,
                          int(n_events * rate), height=height, width=width,
                          window=window)


def dvs_moving_bar(gen: torch.Generator, *, height: int = 64,
                   width: int = 64, n_events: int = 2048,
                   window: float = 1.0, rate: float = 1.0,
                   speed: float = 0.6, bar_width: float = 0.08,
                   vertical: bool = True, noise_frac: float = 0.02,
                   batch=None, device="cuda") -> EventStream:
    """Ego-motion sweep: a bar crosses the field of view at ``speed``
    FOV/window; ON events at its leading edge, OFF at its trailing
    edge."""
    s = _shape(batch, n_events)
    d = BarDraws(t=_uniform(gen, s, 0.0, window), along=_uniform(gen, s),
                 lead=_coin(gen, s), noise=_coin(gen, s, noise_frac),
                 nx=_uniform(gen, s + (2,)))
    return build_moving_bar(_on(d, resolve_device(device)), height=height,
                            width=width, n_events=n_events, window=window,
                            rate=rate, speed=speed, bar_width=bar_width,
                            vertical=vertical)


class FlickerDraws(NamedTuple):
    centre: torch.Tensor     # [..., 2] uniform [0.25, 0.75)
    edge: torch.Tensor       # [..., N] int in [0, n_trans)
    jitter: torch.Tensor     # [..., N] standard normal
    offs: torch.Tensor       # [..., N, 2] standard normal


def _transitions(flicker_hz: float, window: float) -> int:
    return max(1, int(2 * flicker_hz * window))


def build_flicker(d: FlickerDraws, *, height: int, width: int,
                  n_events: int, window: float, rate: float,
                  flicker_hz: float, source_radius: float) -> EventStream:
    n_trans = _transitions(flicker_hz, window)
    jitter = d.jitter * (window / n_trans * 0.05)
    t = _div(d.edge.to(F32) + 0.5, n_trans) * window + jitter
    offs = d.offs * source_radius
    return _finish_events(
        t, (d.centre[..., 0:1] + offs[..., 0]) * width,
        (d.centre[..., 1:2] + offs[..., 1]) * height, d.edge % 2,
        int(n_events * rate), height=height, width=width, window=window)


def dvs_flicker(gen: torch.Generator, *, height: int = 64, width: int = 64,
                n_events: int = 2048, window: float = 1.0,
                rate: float = 0.12, flicker_hz: float = 3.0,
                source_radius: float = 0.08, batch=None,
                device="cuda") -> EventStream:
    """Night / low light: one small source flickers; events cluster at
    its on/off transitions with alternating polarity, far under the
    budget."""
    s = _shape(batch, n_events)
    lead = s[:-1]
    d = FlickerDraws(
        centre=_uniform(gen, lead + (2,), 0.25, 0.75),
        edge=torch.randint(0, _transitions(flicker_hz, window), s,
                           generator=gen),
        jitter=torch.randn(s, generator=gen),
        offs=torch.randn(s + (2,), generator=gen))
    return build_flicker(_on(d, resolve_device(device)), height=height,
                         width=width, n_events=n_events, window=window,
                         rate=rate, flicker_hz=flicker_hz,
                         source_radius=source_radius)


class BurstDraws(NamedTuple):
    t_bg: torch.Tensor       # [..., N] uniform [0, window)
    burst_t0: torch.Tensor   # [...] uniform [0, window * (1 - burst_width))
    in_burst: torch.Tensor   # [..., N] bool
    streak: torch.Tensor     # [..., N] int in [0, n_streaks)
    streak_x: torch.Tensor   # [..., n_streaks] uniform
    u: torch.Tensor          # [..., N, 3] uniform


def build_noise_burst(d: BurstDraws, *, height: int, width: int,
                      n_events: int, window: float, rate: float,
                      burst_width: float) -> EventStream:
    t0 = d.burst_t0[..., None]
    t = torch.where(d.in_burst,
                    t0 + _div(d.t_bg, window) * burst_width * window,
                    d.t_bg)
    xf = torch.where(d.in_burst, torch.gather(d.streak_x, -1, d.streak),
                     d.u[..., 0])
    yf = torch.where(d.in_burst, _div(t - t0, burst_width * window),
                     d.u[..., 1])
    return _finish_events(t, xf * width, yf * height, d.u[..., 2] > 0.5,
                          int(n_events * rate), height=height, width=width,
                          window=window)


def dvs_noise_burst(gen: torch.Generator, *, height: int = 64,
                    width: int = 64, n_events: int = 2048,
                    window: float = 1.0, rate: float = 1.0,
                    burst_frac: float = 0.6, burst_width: float = 0.08,
                    n_streaks: int = 12, batch=None,
                    device="cuda") -> EventStream:
    """Rain / sensor-noise storm: incoherent background noise plus a
    temporal burst of vertical streaks that overfills the window."""
    s = _shape(batch, n_events)
    lead = s[:-1]
    d = BurstDraws(
        t_bg=_uniform(gen, s, 0.0, window),
        burst_t0=_uniform(gen, lead, 0.0, window * (1 - burst_width)),
        in_burst=_coin(gen, s, burst_frac),
        streak=torch.randint(0, n_streaks, s, generator=gen),
        streak_x=_uniform(gen, lead + (n_streaks,)),
        u=_uniform(gen, s + (3,)))
    return build_noise_burst(_on(d, resolve_device(device)), height=height,
                             width=width, n_events=n_events, window=window,
                             rate=rate, burst_width=burst_width)


class CrossingDraws(NamedTuple):
    side: torch.Tensor       # [..., n_objects] int in [0, 4): entry edge
    lane: torch.Tensor       # [..., n_objects] uniform [0.2, 0.8)
    t: torch.Tensor          # [..., n_objects, per] uniform [0, window)
    u: torch.Tensor          # [..., n_objects, per, 2] uniform
    perm: torch.Tensor       # [..., n_objects * per] a permutation


def build_crossing(d: CrossingDraws, *, height: int, width: int,
                   n_events: int, window: float, rate: float,
                   obj_size: float) -> EventStream:
    side, lane = d.side, d.lane
    zero, one = torch.zeros_like(lane), torch.ones_like(lane)
    # start on an edge; the velocity points across the field of view
    sx = torch.where(side == 0, zero, torch.where(side == 1, one, lane))
    sy = torch.where(side == 0, lane, torch.where(
        side == 1, lane, torch.where(side == 2, zero, one)))
    vx, vy = (0.5 - sx)[..., None], (0.5 - sy)[..., None]
    u = d.u - 0.5
    cx = sx[..., None] + _div(vx * 2.0 * d.t, window)
    cy = sy[..., None] + _div(vy * 2.0 * d.t, window)
    ex = cx + u[..., 0] * obj_size
    ey = cy + u[..., 1] * obj_size
    lead = (u[..., 0] * vx + u[..., 1] * vy) > 0
    n_used = d.perm.shape[-1]

    def take(a):                 # interleave the objects
        return torch.gather(a.flatten(-2), -1, d.perm)
    ev = _finish_events(take(d.t), take(ex) * width, take(ey) * height,
                        take(lead), int(n_used * rate), height=height,
                        width=width, window=window)
    return pad_stream(ev, n_events)      # uniform capacity across scenarios


def dvs_crossing(gen: torch.Generator, *, height: int = 64, width: int = 64,
                 n_events: int = 2048, window: float = 1.0,
                 rate: float = 0.8, n_objects: int = 3,
                 obj_size: float = 0.12, batch=None,
                 device="cuda") -> EventStream:
    """Multi-object crossing: ``n_objects`` squares enter from the edges
    of the field of view and cross paths near its centre."""
    lead = _shape(batch, n_events)[:-1]
    per = n_events // n_objects
    d = CrossingDraws(
        side=torch.randint(0, 4, lead + (n_objects,), generator=gen),
        lane=_uniform(gen, lead + (n_objects,), 0.2, 0.8),
        t=_uniform(gen, lead + (n_objects, per), 0.0, window),
        u=_uniform(gen, lead + (n_objects, per, 2)),
        perm=torch.argsort(_uniform(gen, lead + (per * n_objects,)), -1))
    return build_crossing(_on(d, resolve_device(device)), height=height,
                          width=width, n_events=n_events, window=window,
                          rate=rate, obj_size=obj_size)


def _shape(batch, n_events: int) -> Tuple[int, ...]:
    return ((batch,) if batch is not None else ()) + (n_events,)


SCENARIOS = {
    "moving_bar": dvs_moving_bar,
    "flicker": dvs_flicker,
    "noise_burst": dvs_noise_burst,
    "crossing": dvs_crossing,
}


def make_scenario(name: str, gen: torch.Generator, **kw) -> EventStream:
    """One window of the named scenario ([n_events] leaves)."""
    return SCENARIOS[name](gen, **kw)


def make_scenario_batch(name: str, gen: torch.Generator, batch: int,
                        **kw) -> EventStream:
    """``batch`` windows ([batch, n_events] leaves)."""
    return SCENARIOS[name](gen, batch=batch, **kw)


# ---------------------------------------------------------------------------
# LM token stream (synthetic, deterministic)
# ---------------------------------------------------------------------------

def build_token_batch(base: torch.Tensor, rep: torch.Tensor, vocab: int):
    """Copy structure on random tokens: where ``rep``, token[t] is
    token_base[t-1] + 1 (mod ``vocab``); labels are the tokens shifted
    by one (wrapping)."""
    shifted = torch.cat([base[:, :1], (base[:, :-1] + 1) % vocab], dim=1)
    tokens = torch.where(rep, shifted, base)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    return {"tokens": tokens, "labels": labels}


def make_token_batch(gen: torch.Generator, batch: int, seq: int,
                     vocab: int, device="cuda"):
    """Markov-ish synthetic tokens: learnable structure, not uniform."""
    dev = resolve_device(device)
    base = torch.randint(0, vocab, (batch, seq), generator=gen)
    rep = _coin(gen, (batch, seq))
    return build_token_batch(base.to(dev), rep.to(dev), vocab)
