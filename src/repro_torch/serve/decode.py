"""Serving substrate: prefill + batched single-token decode steps.

``make_serve_step(model)`` returns serve_step: one new token per sequence
against the KV caches, greedy or sampled at a temperature.
``generate`` drives prefill and the decode loop from the host.

Sampling at ``temperature > 0`` draws with ``torch.multinomial`` over the
softmax from an explicit ``torch.Generator``; it cannot reproduce the bits
of the reference's ``jax.random.categorical``.
"""
from __future__ import annotations

import time

import torch

from repro_torch.models.transformer import Model


def make_serve_step(model: Model, temperature: float = 0.0):
    """serve_step(caches, tokens, pos, generator) -> (next_tokens (B, 1), caches)."""

    def serve_step(caches, tokens: torch.Tensor, pos: int, generator: torch.Generator | None = None):
        logits, caches = model.decode_step(caches, tokens, pos)
        last = logits[:, -1]
        if temperature > 0.0:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        return nxt.to(torch.int32)[:, None], caches

    return serve_step


def make_prefill(model: Model, cache_len: int):
    def prefill(batch: dict[str, torch.Tensor]):
        return model.prefill(batch, cache_len=cache_len)

    return prefill


def _sync(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def generate(
    model: Model,
    prompt: torch.Tensor,  # (B, L) int
    steps: int,
    cache_len: int | None = None,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    batch_extra: dict[str, torch.Tensor] | None = None,
    timings: dict | None = None,
) -> torch.Tensor:
    """Greedy/temperature generation loop (host-driven) -> (B, steps) int32.

    With a ``timings`` dict, records ``prefill_s`` and ``decode_s``: host
    seconds, each ending in a device synchronize.
    """
    b, l = prompt.shape
    cache_len = cache_len or (l + steps)
    batch = {"tokens": prompt}
    if batch_extra:
        batch.update(batch_extra)
    prefill = make_prefill(model, cache_len)
    step = make_serve_step(model, temperature)
    t0 = _sync(prompt.device)
    logits, caches = prefill(batch)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    t1 = _sync(prompt.device)
    out = [tok]
    for i in range(steps - 1):
        tok, caches = step(caches, tok, l + i, generator)
        out.append(tok)
    tokens = torch.cat(out, dim=1)
    t2 = _sync(prompt.device)
    if timings is not None:
        timings.update(prefill_s=t1 - t0, decode_s=t2 - t1)
    return tokens
