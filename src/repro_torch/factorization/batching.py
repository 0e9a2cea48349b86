"""Shared lane layout for the mask-padded batched entry points.

The batched fits (``nmf_batched``, ``nmfk_score_batched``) promise the
same contract: lane i draws from ``lane_seed(seed, ks[i])`` — the per-k
evaluators' schedule — and every lane runs at a common padded rank
``k_pad >= max(ks)``, with its init drawn at ``k_pad``. Keeping the
validation and seed derivation here stops the schedule (which the
batched-vs-per-k tests depend on) from drifting between entry points.

This module also owns the shape-bucketing policy the evaluation planes use
to pick a padded batch size (``bucket_batch``): pow2 rounding with a floor
keeps the set of distinct ``(batch, k_pad)`` shapes small and stable across
searches, and an already-dispatched bucket is reused where it fits.

``WarmStartCache`` holds the completed W factors the elastic plane seeds
refilled lanes from.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import torch

from repro_torch.random import lane_seed


class WarmStartCache:
    """Completed-fit W factors keyed by (k, perturbation) for cross-k warm starts.

    Binary Bleed's pre-order visit order clusters nearby k's in time, so a
    freshly drained lane usually has a recently-completed neighbor whose
    W is a far better starting point than a random draw. ``nearest``
    prefers the same perturbation index (its noise realization matches the
    new lane's), breaking distance ties toward smaller k (truncating a
    larger fit discards information; padding a smaller one keeps it all).

    Stores one entry per (k, perturbation) and evicts whole k's FIFO beyond
    ``max_ks``. The tensors are held as given: callers pass a tensor no one
    writes afterwards (the elastic plane clones a slot's W before caching it).
    """

    def __init__(self, window: int = 8, max_ks: int = 16):
        self.window = int(window)
        self.max_ks = int(max_ks)
        self._by_k: dict[int, dict[int, torch.Tensor]] = {}
        self.hits = 0
        self.misses = 0

    def put(self, k: int, perturbation: int, w: torch.Tensor) -> None:
        slot = self._by_k.setdefault(int(k), {})
        slot[int(perturbation)] = w
        while len(self._by_k) > self.max_ks:
            self._by_k.pop(next(iter(self._by_k)))

    def nearest(self, k: int, perturbation: int) -> tuple[int, torch.Tensor] | None:
        """Best (k_src, w_src) within ``window`` of k, or None (cold start)."""
        k, perturbation = int(k), int(perturbation)
        best = None
        for k_src, slot in self._by_k.items():
            dist = abs(k_src - k)
            if dist > self.window or not slot:
                continue
            p_src = perturbation if perturbation in slot else next(iter(slot))
            # rank: distance, then mismatched perturbation, then prefer k_src < k
            rank = (dist, 0 if p_src == perturbation else 1, 0 if k_src <= k else 1)
            if best is None or rank < best[0]:
                best = (rank, k_src, slot[p_src])
        if best is None:
            self.misses += 1
            return None
        self.hits += 1
        return best[1], best[2]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def round_up_multiple(n: int, step: int) -> int:
    return ((n + step - 1) // step) * step


def bucket_batch(
    n_real: int,
    *,
    lanes: int = 1,
    bucket_min: int = 1,
    cap: int | None = None,
    compiled: Iterable[int] = (),
) -> int:
    """Pick the padded batch size for a dispatch of ``n_real`` lanes.

    Policy (in priority order):
      1. fresh target = pow2(max(n_real, bucket_min)) rounded up to a
         multiple of ``lanes``;
      2. ``cap`` bounds the padding (never below n_real itself, rounded to
         a lane multiple — correctness beats the cap when they conflict);
      3. if the fresh target was not dispatched yet but some earlier bucket
         (``compiled``) can hold this dispatch (>= n_real, within the cap),
         reuse the smallest such bucket instead of minting a new shape.
    """
    if n_real < 1:
        raise ValueError("n_real must be >= 1")
    target = next_pow2(max(n_real, bucket_min))
    if lanes > 1:
        target = round_up_multiple(target, lanes)
    floor = round_up_multiple(n_real, lanes) if lanes > 1 else n_real
    cap_r = None
    if cap is not None:
        cap_r = round_up_multiple(cap, lanes) if lanes > 1 else cap
        target = max(floor, min(target, cap_r))
    compiled = set(compiled)
    if target in compiled:
        return target
    fits = sorted(
        b for b in compiled if b >= floor and (cap_r is None or b <= max(cap_r, floor))
    )
    if fits:
        return fits[0]
    return target


def batched_lanes(
    ks: Sequence[int], seed: int, k_pad: int | None, device: str | torch.device = "cpu"
) -> tuple[torch.Tensor, list[int], int]:
    """Validate ``ks``/``k_pad`` and derive per-lane seeds.

    Returns (ks (b,) int64 tensor on ``device``, seeds (b,) with
    seeds[i] = lane_seed(seed, ks[i]), k_pad).
    """
    ks = [int(k) for k in ks]
    if not ks:
        raise ValueError("ks must be non-empty")
    k_pad = max(ks) if k_pad is None else k_pad
    if k_pad < max(ks):
        raise ValueError(f"k_pad={k_pad} smaller than max(ks)={max(ks)}")
    seeds = [lane_seed(seed, k) for k in ks]
    return torch.tensor(ks, device=device), seeds, k_pad
