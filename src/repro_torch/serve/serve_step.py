"""Serving steps — the port of ``repro.serve.serve_step``.

serve_step consumes one token per sequence and the KV cache, returning the
next tokens and the cache (updated in place).  Sampling is greedy or
temperature on top.  ``generate`` is prefill then a loop of serve steps
under ``torch.inference_mode()`` (the reference's ``scan``).
"""

from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.models.config import ArchConfig


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """[B, T, V] -> [B, 1] int32: the first index of the largest last-position logit."""
    return logits[:, -1].argmax(-1).to(torch.int32)[:, None]


def temperature_sample(logits: torch.Tensor, gen: torch.Generator, temp: float = 0.8) -> torch.Tensor:
    """[B, T, V] -> [B, 1] int32 drawn from softmax(last logits / temp) with ``gen``."""
    probs = torch.softmax(logits[:, -1].float() / temp, dim=-1)
    return torch.multinomial(probs, 1, generator=gen).to(torch.int32)


def make_prefill_step(cfg: ArchConfig, ctx=None):
    def prefill_step(params, batch, state):
        logits, state = api.prefill_fn(cfg, params, batch, state, ctx=ctx)
        return greedy_sample(logits), state

    return prefill_step


def make_serve_step(cfg: ArchConfig, ctx=None):
    """One decode iteration: tokens [B,1] + state -> (next tokens, state)."""

    def serve_step(params, tokens, state):
        logits, state = api.decode_fn(cfg, params, tokens, state, ctx=ctx)
        return greedy_sample(logits), state

    return serve_step


def generate(cfg: ArchConfig, params, batch: dict, max_new: int, ctx=None, *,
             on_step=None):
    """Prefill then decode: ([B, max_new] int32 greedy tokens, final state).

    The cache is made on the device of ``batch["tokens"]``.  If given,
    ``on_step(tokens, logits)`` is called after the prefill and after each
    decode step with that step's tokens [B, 1] and its last-position logits
    [B, V], as a server streams each token (or a check records the logits)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    with torch.inference_mode():
        state = api.init_decode_state(cfg, b, s + max_new, device=tokens.device)
        logits, state = api.prefill_fn(cfg, params, batch, state, ctx=ctx)
        tok = greedy_sample(logits)
        out = [tok]
        if on_step is not None:
            on_step(tok, logits[:, -1])
        for _ in range(max_new - 1):
            logits, state = api.decode_fn(cfg, params, tok, state, ctx=ctx)
            tok = greedy_sample(logits)
            out.append(tok)
            if on_step is not None:
                on_step(tok, logits[:, -1])
    return torch.cat(out, dim=1), state
