"""Deterministic synthetic token pipeline (restart-exact).

An index-based source: ``batch_at(step)`` draws a step's global batch from
numpy's ``default_rng(seed * 1_000_003 + step)`` with the reference's calls
in the reference's order, so any worker can materialize any step without
coordination, a restart continues exactly, and the batches are the
reference's bit for bit. Targets are next-token labels (shifted).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    ignore_id: int = -1


class SyntheticTokenSource:
    """step -> {tokens, labels[, embeds]} with Zipf-ish token marginals."""

    def __init__(self, arch: ArchConfig, shape: ShapeConfig, dcfg: DataConfig = DataConfig()):
        self.arch = arch
        self.shape = shape
        self.dcfg = dcfg

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(np.uint64(self.dcfg.seed * 1_000_003 + step))
        b, l = self.shape.global_batch, self.shape.seq_len
        v = self.arch.vocab_size
        # Zipf-like marginal over the vocabulary, uneven like real text
        ranks = rng.zipf(1.3, size=(b, l + 1)).astype(np.int64)
        tokens = np.minimum(ranks - 1, v - 1).astype(np.int32)
        out = {
            "tokens": tokens[:, :l],
            "labels": tokens[:, 1 : l + 1],  # next-token targets, all valid
        }
        if self.arch.input_mode == "embeddings":
            out["embeds"] = rng.standard_normal((b, l, self.arch.d_model)).astype(np.float32) * 0.02
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def device_put_batch(batch: dict[str, np.ndarray], device: str | torch.device) -> dict[str, torch.Tensor]:
    """The batch as tensors on ``device``; int32 token ids widen to int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = (t.long() if t.dtype == torch.int32 else t).to(device)
    return out
