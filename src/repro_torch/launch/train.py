"""Training launcher, the counterpart of ``repro.launch.train``.

  python -m repro_torch.launch.train --arch spiking_yolo --steps 100 \\
      [--reduced] [--ckpt-dir DIR] [--device cuda|cpu]
  torchrun --nproc-per-node N -m repro_torch.launch.train ...

Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment) each rank
joins the launcher's process group, NCCL on the card ``LOCAL_RANK``
(gloo with ``--device cpu``), and ``train_detector`` trains
data-parallel over the ranks (``--batch`` is the global batch; the
world must divide it); rank 0 logs and writes the checkpoints.

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
import os

import torch

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
        device = join_process_group(args.device)
        try:
            return train_snn(args, device)
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
    raise NotImplementedError(
        f"{args.arch}: LM training is not ported (ROADMAP.md queue 1 "
        f"item 5.5); the SNN archs are {sorted(registry.SNN_ARCHS)}")


def join_process_group(device):
    """Under ``torchrun`` (``WORLD_SIZE`` > 1): join its process group
    (``env://``), NCCL with one card a rank (``LOCAL_RANK``), gloo on the
    CPU; returns this rank's device.  Otherwise ``device`` as it is."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    torch.distributed.init_process_group(
        "nccl" if device.type == "cuda" else "gloo")
    return device


def train_snn(args, device=None):
    """The detector on ``args.arch`` (reduced dims with ``--reduced``),
    trained and evaluated by ``train_detector`` on ``device`` (default
    ``args.device``).  Returns the final state; rank 0 prints the last
    step."""
    tc = TrainConfig(name="launch", arch=args.arch, backend="cuda",
                     reduced=args.reduced, steps=args.steps,
                     batch=args.batch, ckpt_every=args.ckpt_every)
    report = train_detector(tc, ckpt_dir=args.ckpt_dir,
                            device=device if device is not None
                            else args.device)
    final = report.history[-1]
    if not (torch.distributed.is_initialized()
            and torch.distributed.get_rank()):
        print(f"final: step={final['step']} loss={final['loss']:.4f}")
    return report.state


if __name__ == "__main__":
    main()
