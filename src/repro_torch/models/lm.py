"""The LM serving entry points (the counterpart of ``repro.models.lm``'s
``serve_prefill`` and ``serve_decode``).  The losses and the MTP head
come with LM training."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


def serve_decode(params, cfg: ModelConfig, cache, tokens, pos):
    """One decode step against an existing KV cache (updated in place):
    tokens [B, 1], pos a scalar or per-slot [B] -> (logits [B, V], cache)."""
    return tfm.forward_decode(params, cfg, tokens, cache, pos)


def serve_prefill(params, cfg: ModelConfig, batch, cache_len=None):
    """Prefill batch["tokens"] [B, S] -> (last logits [B, V], the cache
    padded to ``cache_len``); every layer's attention runs the
    flash_attention kernel on the card."""
    return tfm.forward_prefill(params, cfg, batch, cache_len=cache_len)
