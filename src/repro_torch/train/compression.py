"""Gradient compression, as the round trip a data-parallel all-reduce's
wire format would make: a bf16 cast, or blockwise symmetric int8 with one
float32 scale a block of 256.

``torch.round`` rounds half to even, as ``jnp.round`` does, so ``q`` and
the scales are the reference's bit for bit on the same float32 input.
"""
from __future__ import annotations

from typing import Mapping

import torch

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8: returns (q (blocks, 256) int8, scales (blocks, 1) float32)."""
    flat = x.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    """``g`` quantized in blocks of 256 of its flattened order and back."""
    return dequantize_int8(*quantize_int8(g), g.shape, g.dtype)


def compress_tree(grads: Mapping[str, torch.Tensor], mode: str = "none") -> Mapping[str, torch.Tensor]:
    """Apply lossy compression to named gradients (``none``, ``bf16``, ``int8``)."""
    if mode == "none":
        return grads
    if mode == "bf16":
        return {k: g.to(torch.bfloat16) for k, g in grads.items()}
    if mode == "int8":
        return {k: int8_roundtrip(g) for k, g in grads.items()}
    raise ValueError(f"unknown compression mode {mode!r}")
