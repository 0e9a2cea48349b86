"""Serving substrate: prefill + batched single-token decode steps.

``make_serve_step(model)`` returns serve_step: one new token per sequence
against the KV caches, greedy or sampled at a temperature.
``generate`` drives prefill and the decode loop from the host.

On a ``(data, model)`` or ``(pod, data, model)`` mesh (a ``Model`` made
with ``mesh=``) every rank runs ``generate`` on its rows of the prompt: the
ranks of a model group compute the same whole logits, so they return the
same tokens, and each (pod, data) rank returns its block of the batch's
rows.

Sampling at ``temperature > 0`` draws by inverse CDF over the softmax,
one uniform a row from an explicit ``torch.Generator`` (it cannot
reproduce the bits of the reference's ``jax.random.categorical``). As the
reference samples the whole batch with one replicated key, every rank
draws the uniforms of the whole global batch from its generator (seeded
alike on every rank) and takes its own rows' (``_sample``), so the tokens
do not depend on how the batch is cut and a model group still agrees.
"""
from __future__ import annotations

import time

import torch

from repro_torch.models.layers import P
from repro_torch.models.transformer import Model


def _sample(logits: torch.Tensor, generator: torch.Generator | None, blocks: int = 1,
            index: int = 0) -> torch.Tensor:
    """One token a row of ``logits`` (B, V), drawn from its softmax by inverse
    CDF: the first token whose cumulative probability exceeds the row's
    uniform (a zero-probability token is never drawn). ``blocks`` rows of B
    (the global batch) draw their uniforms at once, and these rows take
    block ``index``'s."""
    b = logits.shape[0]
    u = torch.rand((blocks * b,), generator=generator, device=logits.device)[index * b:(index + 1) * b]
    cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    nxt = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)[:, 0]
    return nxt.clamp(max=logits.shape[-1] - 1)


def make_serve_step(model: Model, temperature: float = 0.0):
    """serve_step(caches, tokens, pos, generator) -> (next_tokens (B, 1), caches)."""
    sh = model.sh
    blocks, index = (sh.batch_count, sh.batch_index) if sh is not None and sh.batch_split else (1, 0)

    def serve_step(caches, tokens: torch.Tensor, pos: int, generator: torch.Generator | None = None):
        logits, caches = model.decode_step(caches, tokens, pos)
        last = logits[:, -1]
        if temperature > 0.0:
            nxt = _sample(last / temperature, generator, blocks, index)
        else:
            nxt = torch.argmax(last, dim=-1)
        return nxt.to(torch.int32)[:, None], caches

    return serve_step


def make_prefill(model: Model, cache_len: int):
    def prefill(batch: dict[str, torch.Tensor]):
        return model.prefill(batch, cache_len=cache_len)

    return prefill


def decode_input_specs(model: Model) -> dict[str, P]:
    """The reference's decode-step input specs: tokens cut by batch, the
    position and the sampling key (here the generator) whole on every rank."""
    ax = model.ax
    return {"tokens": P(ax.b, None), "pos": P(), "key": P()}


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
    seconds, each ending in a synchronize of this rank's device.
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
