"""Chunking of the k list across resources (paper Algorithm 2 + Table II).

Algorithm 2 ("Skip Mod Resource Count") deals k values round-robin by their
rank in ascending order: element with sorted-rank r goes to resource
``r mod num_resources`` (input list order is preserved within each chunk).
Every resource then holds a spread of low *and* high k values, so a prune
broadcast from one resource still leaves useful work on all others — the
failure mode of contiguous block chunking (Table II T1/T3) is one resource
idling after a prune while another grinds an un-prunable block.

Rank-mod (rather than position-in-list mod) reproduces the paper's Table II
for both T2 (chunk after traversal sort) and T4 (chunk before), and stays
load-balanced for arbitrary, non-contiguous k lists.

Four composition orders from Table II, for the ablation benchmark:

  T1: traversal-sort whole K, then block-chunk
  T2: traversal-sort whole K, then skip-mod chunk
  T3: block-chunk, then traversal-sort each chunk       (paper: least optimal)
  T4: skip-mod chunk, then traversal-sort each chunk    (paper: best; the
      scheduler default, used in paper Figs 2-6)
"""
from __future__ import annotations

from typing import Sequence

from .traversal import Order, traversal_sort


def chunk_skip_mod(ks: Sequence[int], num_resources: int) -> list[list[int]]:
    """Algorithm 2: deal ks round-robin (by ascending rank) over resources."""
    if num_resources < 1:
        raise ValueError("num_resources must be >= 1")
    rank = {k: r for r, k in enumerate(sorted(set(ks)))}
    chunks: list[list[int]] = [[] for _ in range(num_resources)]
    for k in ks:  # preserve input order within chunks
        chunks[rank[k] % num_resources].append(k)
    return chunks


def chunk_block(ks: Sequence[int], num_resources: int) -> list[list[int]]:
    """Contiguous block split ("Chunk Ks by Resource Count", T1/T3)."""
    if num_resources < 1:
        raise ValueError("num_resources must be >= 1")
    ks = list(ks)
    n = len(ks)
    base, rem = divmod(n, num_resources)
    chunks, start = [], 0
    for r in range(num_resources):
        size = base + (1 if r < rem else 0)
        chunks.append(ks[start : start + size])
        start += size
    return chunks


def plan_worklists(
    ks: Sequence[int],
    num_resources: int,
    order: Order = "pre",
    strategy: str = "T4",
) -> list[list[int]]:
    """Produce per-resource visit-ordered worklists per Table II strategy."""
    ks = sorted(ks)
    if strategy == "T1":
        return chunk_block(traversal_sort(ks, order), num_resources)
    if strategy == "T2":
        return chunk_skip_mod(traversal_sort(ks, order), num_resources)
    if strategy == "T3":
        return [traversal_sort(sorted(c), order) for c in chunk_block(ks, num_resources)]
    if strategy == "T4":
        return [traversal_sort(sorted(c), order) for c in chunk_skip_mod(ks, num_resources)]
    raise ValueError(f"unknown strategy {strategy!r} (want T1|T2|T3|T4)")


def rebalance(
    remaining: Sequence[int],
    num_resources: int,
    order: Order = "pre",
) -> list[list[int]]:
    """Elastic re-chunk of *unvisited* k values over surviving resources.

    Used on resource failure/join: Alg 2 is stateless over any k set, so
    rebalancing is just re-running T4 on the remaining pool. Deterministic.
    """
    return plan_worklists(sorted(set(remaining)), num_resources, order=order, strategy="T4")
