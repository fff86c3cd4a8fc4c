"""Serving launcher: batched requests through the slot engine.

  python -m repro_torch.launch.serve --arch qwen2-7b            # reduced
  python -m repro_torch.launch.serve --arch qwen2-7b --full     # full width

The reference's flags (``--arch``, ``--reduced``, ``--requests``,
``--batch``, ``--max-new``), plus ``--full`` (the reference's
``--reduced`` is on by default and cannot be turned off) and
``--device`` (default the card; no fallback).  Parameters are drawn from a ``torch.Generator``
on the device seeded 0; request i's prompt, of 4 + i % 4 tokens, from a
numpy generator seeded i.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Request, ServeEngine


def make_requests(n: int, vocab: int, max_new: int):
    return [Request(rid=i,
                    prompt=np.random.default_rng(i).integers(
                        0, vocab, 4 + i % 4),
                    max_new=max_new)
            for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (overrides --reduced)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (registry.get_config(args.arch) if args.full
           else registry.reduced(args.arch))
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_params(gen, cfg, device=device)
    eng = ServeEngine(params, cfg, batch=args.batch, max_len=128)

    reqs = make_requests(args.requests, cfg.vocab_size, args.max_new)
    t0 = time.time()
    done = eng.run_to_completion(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total_toks = sum(len(r.out_tokens) for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req{r.rid}: {r.out_tokens}")
    print(f"served {len(done)} requests, {total_toks} tokens "
          f"in {dt:.2f}s ({total_toks / dt:.1f} tok/s) on {device}")
    return done


if __name__ == "__main__":
    main()
