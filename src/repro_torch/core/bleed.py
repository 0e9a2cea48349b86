"""Binary Bleed k-search, single rank & thread (paper Algorithm 1 + §III-C).

Two equivalent forms are provided:

  * ``binary_bleed_recursive`` — the paper's Algorithm 1, faithful recursive
    structure over index intervals ``[lo, hi)``: evaluate the midpoint, update
    the prune bounds on threshold crossings, recurse into both halves
    ("bleed") skipping any subtree whose k interval is fully pruned.

  * ``binary_bleed_worklist`` — iterative: walk the traversal-sorted k list
    (pre-order = same visit schedule as the recursion) and skip pruned
    entries. This is the form the multi-resource scheduler generalizes, and
    is restart-safe (the worklist position + bounds are the whole state).

Pruning state (the paper's ``k_min`` / ``k_max`` / ``ranks_seen``):

  * ``lo_bound``: highest k whose score crossed the *select* threshold T.
    Every unvisited k <= lo_bound is pruned — the objective
    ``k_opt = max{k : S(f(k)) ≥ T}`` cannot live there. (Vanilla)
  * ``hi_bound``: lowest k whose score crossed the *stop* threshold U.
    Every unvisited k >= hi_bound is pruned — domain knowledge says scores
    never recover past U. (Early Stop, §III-C)

A k is evaluated iff ``lo_bound < k < hi_bound``.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

from repro_torch.obs import get_metrics, get_tracer

from .search_space import Mode, SearchResult, SearchSpace, VisitRecord
from .traversal import Order, traversal_sort

# evaluate(k) -> score. Long-running fits may additionally accept an
# ``should_abort`` kwarg (checked between fit chunks, §III-D) — the serial
# driver never aborts, the scheduler wires it to live prune state.
# Every driver also accepts an ``EvalPlane`` (anything with
# ``evaluate_batch``) in place of the scalar callable; scalar callables are
# wrapped in a ``ScalarEvalPlane`` adapter internally.
EvalFn = Callable[[int], float]


class BleedState:
    """Mutable prune state shared by all Binary Bleed drivers.

    Instrumented: records/skips/bound-merges flow to the process tracer and
    metrics registry (``repro_torch.obs``) resolved at construction — a no-op
    ``NullTracer`` unless telemetry was installed (``ksearch --trace``).
    """

    __slots__ = (
        "space", "lo_bound", "hi_bound", "k_optimal", "visits", "_order_ctr",
        "_tracer", "_metrics",
    )

    def __init__(self, space: SearchSpace, tracer=None, metrics=None):
        self.space = space
        self.lo_bound = -math.inf  # ks <= lo_bound are pruned (select crossings)
        self.hi_bound = math.inf  # ks >= hi_bound are pruned (stop crossings)
        self.k_optimal: int | None = None
        self.visits: list[VisitRecord] = []
        self._order_ctr = 0
        self._tracer = tracer if tracer is not None else get_tracer()
        self._metrics = metrics if metrics is not None else get_metrics()
        self._metrics.set_gauge("ks_candidates", len(space.ks))

    # -- queries ---------------------------------------------------------------
    def should_visit(self, k: int) -> bool:
        return self.lo_bound < k < self.hi_bound

    def interval_alive(self, k_lo: int, k_hi: int) -> bool:
        """Does [k_lo, k_hi] (k values) intersect the open live interval?"""
        return k_hi > self.lo_bound and k_lo < self.hi_bound

    # -- updates ---------------------------------------------------------------
    def record(self, k: int, score: float, resource: int = 0) -> VisitRecord:
        """Append to ranks_seen and fold the score into the prune bounds."""
        rec = VisitRecord(k=k, score=score, resource=resource, wall_order=self._order_ctr)
        self._order_ctr += 1
        if self.space.selects(score):
            rec.pruned_lower = True
            if k > self.lo_bound:
                self.lo_bound = k
            if self.k_optimal is None or k > self.k_optimal:
                self.k_optimal = k
        if self.space.stops(score):
            rec.pruned_upper = True
            if k < self.hi_bound:
                self.hi_bound = k
        self.visits.append(rec)
        self._metrics.inc("ks_visited")
        self._tracer.event(
            "record", k=k, score=score, resource=resource,
            pruned_lower=rec.pruned_lower, pruned_upper=rec.pruned_upper,
        )
        if rec.pruned_lower or rec.pruned_upper:
            self._metrics.set_gauge("lo_bound", self.lo_bound)
            self._metrics.set_gauge("hi_bound", self.hi_bound)
        return rec

    def skip(self, k: int, reason: str = "pruned") -> None:
        """Account a k pruned before evaluation (the paper's cost saved)."""
        self._metrics.inc("ks_skipped")
        self._tracer.event("skip", k=k, reason=reason)

    def skip_interval(self, k_lo: int, k_hi: int, count: int) -> None:
        """Account a whole pruned subtree ([k_lo, k_hi], ``count`` ks) at once."""
        self._metrics.inc("ks_skipped", count)
        self._tracer.event("subtree_prune", k_lo=k_lo, k_hi=k_hi, count=count)

    def merge_bounds(self, lo_bound: float, hi_bound: float, k_optimal: int | None) -> None:
        """Fold prune bounds published by another resource (Alg 3/4 receive)."""
        lo = max(self.lo_bound, lo_bound)
        hi = min(self.hi_bound, hi_bound)
        if lo != self.lo_bound or hi != self.hi_bound:
            self._metrics.inc("bound_merges")
            self._tracer.event(
                "bound_merge", lo_before=self.lo_bound, hi_before=self.hi_bound,
                lo_after=lo, hi_after=hi,
            )
        self.lo_bound = lo
        self.hi_bound = hi
        if k_optimal is not None and (self.k_optimal is None or k_optimal > self.k_optimal):
            self.k_optimal = k_optimal

    def result(self) -> SearchResult:
        return SearchResult(
            k_optimal=self.k_optimal,
            visits=list(self.visits),
            n_candidates=len(self.space.ks),
        )


def binary_bleed_recursive(
    space: SearchSpace,
    evaluate: EvalFn,
    bleed_up_first: bool = True,
) -> SearchResult:
    """Paper Algorithm 1 — recursive Binary Bleed over ``space.ks``.

    ``bleed_up_first=True`` recurses into the upper half before the lower
    half (Alg 1 lines 16-19): for the max-k objective, finding a higher
    selecting k first prunes more of the lower half.
    """
    from .evalplane import as_eval_plane  # lazy: evalplane sits below bleed

    ks = space.ks
    state = BleedState(space)
    plane = as_eval_plane(evaluate)

    def search(lo: int, hi: int) -> None:  # [lo, hi) index interval
        if lo >= hi:
            return
        # subtree prune: whole k interval outside live bounds (Alg 1 l.16/18)
        if not state.interval_alive(ks[lo], ks[hi - 1]):
            state.skip_interval(ks[lo], ks[hi - 1], hi - lo)
            return
        mid = lo + (hi - lo) // 2
        k_mid = ks[mid]
        if state.should_visit(k_mid):  # Alg 1 line 7
            state.record(k_mid, plane.evaluate_one(k_mid))  # lines 8-15
        else:
            state.skip(k_mid)
        halves = ((mid + 1, hi), (lo, mid)) if bleed_up_first else ((lo, mid), (mid + 1, hi))
        for a, b in halves:  # lines 16-19: bleed into both directions
            search(a, b)

    # Python recursion depth is log2(|K|) — fine for any practical K, but we
    # guard absurd sizes by falling back to the worklist form.
    if len(ks) > 1 << 20:
        return binary_bleed_worklist(space, evaluate, order="pre")
    search(0, len(ks))
    return state.result()


def binary_bleed_worklist(
    space: SearchSpace,
    evaluate: EvalFn,
    order: Order = "pre",
    worklist: Sequence[int] | None = None,
    state: BleedState | None = None,
) -> SearchResult:
    """Iterative Binary Bleed: visit `worklist` (default: traversal-sorted
    ks), skipping pruned entries. With ``order="pre"`` this evaluates the
    same midpoints as the recursion; ``order="in"`` degrades to the naive
    linear grid search (the paper's Standard baseline).

    Passing an external ``state`` lets callers resume a checkpointed search
    or share bounds across resources (the scheduler does both).
    """
    from .evalplane import as_eval_plane  # lazy: evalplane sits below bleed

    if worklist is None:
        worklist = traversal_sort(sorted(space.ks), order)
    state = state if state is not None else BleedState(space)
    plane = as_eval_plane(evaluate)
    for k in worklist:
        if not state.should_visit(k):
            state.skip(k)
            continue
        state.record(k, plane.evaluate_one(k))
    return state.result()


def standard_search(space: SearchSpace, evaluate: EvalFn) -> SearchResult:
    """The paper's Standard baseline: exhaustive ascending grid search.

    Visits 100% of K and picks k_opt = max{k : S(f(k)) crosses T}.
    """
    from .evalplane import as_eval_plane  # lazy: evalplane sits below bleed

    state = BleedState(space)
    plane = as_eval_plane(evaluate)
    for k in space.ks:
        state.record(k, plane.evaluate_one(k))
        # Standard never prunes: reset bounds so every k is visited.
        state.lo_bound = -math.inf
        state.hi_bound = math.inf
    return state.result()
