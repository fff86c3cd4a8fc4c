"""Batched LM serving: slot-based continuous batching (the counterpart
of ``repro.serve.engine``, with its slot semantics).

A fixed pool of ``batch`` slots shares one decode step.  A request is
prefilled into a free slot's cache region by running the decode step
once per prompt token, the other slots at position -1 (inactive: they
write nothing); every tick then decodes one token, greedy argmax, for
every active slot at its own position.  A slot frees when its budget
of ``max_new`` tokens is spent or it emits ``eos_id``, and the next
request reuses it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.lm import serve_decode


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [S] int token ids
    max_new: int = 16
    out_tokens: Optional[List[int]] = None


class ServeEngine:
    """Serves ``params`` of ``cfg`` on the parameters' device; the cache
    (``cfg.dtype``, updated in place) and the last tokens live there, the
    positions and budgets on the host."""

    def __init__(self, params, cfg: ModelConfig, batch: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None):
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = params["tok_embed"].device
        self.cache = tfm.init_cache(cfg, batch, max_len,
                                    dtype=params["tok_embed"].dtype,
                                    device=self.device)
        self.pos = np.zeros((batch,), np.int64)
        self.active: List[Optional[Request]] = [None] * batch
        self.budget = np.zeros((batch,), np.int64)
        self.last_tok = torch.zeros((batch, 1), dtype=torch.int64,
                                    device=self.device)

    def _decode(self, tokens, posv: np.ndarray):
        logits, self.cache = serve_decode(
            self.params, self.cfg, self.cache, tokens,
            torch.as_tensor(posv, device=self.device))
        return logits

    # ------------------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def submit(self, req: Request) -> bool:
        """Prefill a request into a free slot. False if engine is full."""
        slot = self._free_slot()
        if slot is None:
            return False
        req.out_tokens = []
        toks = np.asarray(req.prompt).reshape(-1)
        for t in range(toks.shape[0]):
            posv = np.full((self.batch,), -1, np.int64)
            posv[slot] = t
            tok = torch.zeros((self.batch, 1), dtype=torch.int64,
                              device=self.device)
            tok[slot, 0] = int(toks[t])
            logits = self._decode(tok, posv)
        self.pos[slot] = toks.shape[0]
        nxt = int(torch.argmax(logits[slot]))
        self.last_tok[slot, 0] = nxt
        req.out_tokens.append(nxt)
        self.budget[slot] = req.max_new - 1
        self.active[slot] = req
        return True

    # ------------------------------------------------------------------
    def tick(self) -> List[Request]:
        """One decode step for all active slots; returns finished reqs."""
        if not any(r is not None for r in self.active):
            return []
        act = np.array([r is not None for r in self.active])
        posv = np.where(act, self.pos, -1)
        logits = self._decode(self.last_tok, posv)
        self.pos = np.where(act, self.pos + 1, self.pos)
        nxt = torch.argmax(logits, dim=-1)
        act_t = torch.as_tensor(act, device=self.device)
        self.last_tok = torch.where(act_t, nxt, self.last_tok[:, 0])[:, None]
        nxt = nxt.cpu().tolist()
        finished = []
        for i, r in enumerate(self.active):
            if r is None:
                continue
            tok = nxt[i]
            r.out_tokens.append(tok)
            self.budget[i] -= 1
            done = self.budget[i] <= 0 or \
                (self.eos_id is not None and tok == self.eos_id)
            if done:
                finished.append(r)
                self.active[i] = None
        return finished

    def run_to_completion(self, requests: List[Request],
                          max_ticks: int = 10000) -> List[Request]:
        done: List[Request] = []
        pending = list(requests)
        ticks = 0
        while (pending or any(r is not None for r in self.active)) \
                and ticks < max_ticks:
            while pending and self._free_slot() is not None:
                self.submit(pending.pop(0))
            done.extend(self.tick())
            ticks += 1
        return done
