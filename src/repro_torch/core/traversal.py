"""Binary-tree traversal sorts of a k list (paper Fig. 1, Table II).

A sorted list of k values is viewed as the binary-search tree over index
intervals ``[lo, hi)`` (exclusive right) with root ``mid = lo + (hi-lo)//2``
and children ``[lo, mid)`` / ``[mid+1, hi)`` — exactly Algorithm 1's
midpoint convention, so traversal-sorted worklists visit the same nodes the
recursive algorithm would. This convention reproduces the paper's Table II
exactly: pre-order of [1..11] is ``6,3,2,1,5,4,9,8,7,11,10``.

  - pre-order : root, left, right — midpoints first; maximally informative
                early visits, the paper's best performer.
  - in-order  : left, root, right — recovers ascending order; equivalent to
                naive grid search (never prunes ahead).
  - post-order: left, right, root — children before parents.
"""
from __future__ import annotations

from typing import Iterator, Sequence

Order = str  # "pre" | "in" | "post"

_ORDERS = ("pre", "in", "post")


def _check_order(order: Order) -> None:
    if order not in _ORDERS:
        raise ValueError(f"order must be one of {_ORDERS}, got {order!r}")


def traversal_sort(ks: Sequence[int], order: Order = "pre") -> list[int]:
    """Reorder `ks` (assumed sorted ascending) by BST traversal.

    Iterative to avoid Python recursion limits on large K (distributed rank
    sweeps use |K| up to 1e5).
    """
    _check_order(order)
    ks = list(ks)
    n = len(ks)
    if n <= 1:
        return ks
    if order == "in":
        return ks

    out: list[int] = []
    if order == "pre":
        # root, left, right over [lo, hi) intervals
        stack: list[tuple[int, int]] = [(0, n)]
        while stack:
            lo, hi = stack.pop()
            if lo >= hi:
                continue
            mid = lo + (hi - lo) // 2
            out.append(ks[mid])
            stack.append((mid + 1, hi))  # right pushed first ...
            stack.append((lo, mid))  # ... so left pops first
        return out

    # post-order: left, right, root — two-phase stack
    stack2: list[tuple[int, int, bool]] = [(0, n, False)]
    while stack2:
        lo, hi, expanded = stack2.pop()
        if lo >= hi:
            continue
        mid = lo + (hi - lo) // 2
        if expanded:
            out.append(ks[mid])
        else:
            stack2.append((lo, hi, True))
            stack2.append((mid + 1, hi, False))
            stack2.append((lo, mid, False))
    return out


def traversal_iter(ks: Sequence[int], order: Order = "pre") -> Iterator[int]:
    yield from traversal_sort(ks, order)


def inverse_visit_rank(ks: Sequence[int], order: Order = "pre") -> dict[int, int]:
    """Map k -> position in the traversal order (0 = visited first)."""
    return {k: i for i, k in enumerate(traversal_sort(ks, order))}
