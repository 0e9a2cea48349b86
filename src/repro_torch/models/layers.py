"""Shared layers of the LM substrate: initializers, RMSNorm, SwiGLU MLP,
embedding and LM head.

Parameters live in ``nn.ParameterDict``s (nested in ``nn.ModuleDict``s)
under the reference's names and einsum layouts, so the functions read like
the reference's (``rmsnorm(params["norm1"], x)``) and a reference parameter
tree converts by copying (``repro_torch.convert``). Every parameter is
created with ``requires_grad=False``, as serving wants it; training turns
gradients on for the tree it trains (``train.train_step``).

The reference's sharding helpers (``Axes``, ``shard``, the ``*_specs``
functions) have no counterpart: on one card they are no-ops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def frozen(**tensors: torch.Tensor) -> nn.ParameterDict:
    """A ParameterDict of inference-only parameters."""
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False) for k, t in tensors.items()})


# -----------------------------------------------------------------------------
# initializers — fan-in scaled normal, drawn in order from one generator
# -----------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape: tuple[int, ...], fan_in: int | None = None,
               dtype=torch.float32) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (fan_in**-0.5 * w).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=gen.device, dtype=torch.float32).to(dtype)


# -----------------------------------------------------------------------------
# RMSNorm
# -----------------------------------------------------------------------------
def rmsnorm_init(d: int, device) -> nn.ParameterDict:
    return frozen(scale=torch.ones((d,), dtype=torch.float32, device=device))


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)


# -----------------------------------------------------------------------------
# SwiGLU MLP
# -----------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype=torch.float32) -> nn.ParameterDict:
    return frozen(
        w_gate=dense_init(gen, (d, d_ff), d, dtype),
        w_up=dense_init(gen, (d, d_ff), d, dtype),
        w_down=dense_init(gen, (d_ff, d), d_ff, dtype),
    )


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# -----------------------------------------------------------------------------
# Embedding / LM head
# -----------------------------------------------------------------------------
def embedding_init(gen: torch.Generator, vocab: int, d: int, tie: bool, dtype=torch.float32) -> nn.ParameterDict:
    p = {"table": embed_init(gen, vocab, d, dtype)}
    if not tie:
        p["lm_head"] = dense_init(gen, (d, vocab), d, dtype)
    return frozen(**p)


def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def lm_logits(params, x: torch.Tensor) -> torch.Tensor:
    """(B, L, d) -> (B, L, V), fp32 logits."""
    if "lm_head" in params:
        logits = x @ params["lm_head"].to(x.dtype)
    else:
        logits = x @ params["table"].to(x.dtype).T
    return logits.float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_id: int = -1) -> torch.Tensor:
    """Mean token NLL; labels == ignore_id are masked."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (labels != ignore_id).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
