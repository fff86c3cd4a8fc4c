"""Training launcher, the counterpart of ``repro.launch.train``.

  python -m repro_torch.launch.train --arch spiking_yolo --steps 100 \\
      [--reduced] [--ckpt-dir DIR] [--device cuda|cpu]

The SNN archs (``spiking_*``) train the detector on synthetic scenes
through :func:`repro_torch.train.detector.train_detector` (``train_snn``),
on the kernel-backed spiking layers (``backend="cuda"``; on the CPU their
wrappers take the plain versions); the LM archs raise, their training is
not ported.  The reference's flags of the SNN path, plus ``--device``
(default the card; no fallback); the LM path's (``--seq``, ``--lr``,
``--remat``, ``--production-mesh``) come with it.  The default ``--arch``
is ``spiking_yolo`` (the reference's is an LM).  The recipe is
:class:`TrainConfig`'s (AdamW under the warmup-cosine schedule), with
parameters and the batch of step ``s`` drawn from seed 0; a run with
``--ckpt-dir`` resumes from the newest checkpoint there.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.train.detector import train_detector


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="spiking_yolo")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.arch in registry.SNN_ARCHS:
        return train_snn(args)
    raise NotImplementedError(
        f"{args.arch}: LM training is not ported (ROADMAP.md queue 1 "
        f"item 5.5); the SNN archs are {sorted(registry.SNN_ARCHS)}")


def train_snn(args):
    """The detector on ``args.arch`` (reduced dims with ``--reduced``),
    trained and evaluated by ``train_detector``.  Returns the final
    state."""
    tc = TrainConfig(name="launch", arch=args.arch, backend="cuda",
                     reduced=args.reduced, steps=args.steps,
                     batch=args.batch, ckpt_every=args.ckpt_every)
    report = train_detector(tc, ckpt_dir=args.ckpt_dir, device=args.device)
    final = report.history[-1]
    print(f"final: step={final['step']} loss={final['loss']:.4f}")
    return report.state


if __name__ == "__main__":
    main()
