"""Evaluation plane: the batched dispatch surface under every Bleed driver.

The paper treats "resources" as threads/ranks that each fit one k at a
time, so every distinct k pays its own trace/JIT/dispatch cost. On a
single accelerator the hardware-shaped alternative is to dispatch a whole
*frontier* of independent k values as one padded, vmapped fit. This module
defines the seam between the two worlds:

  * ``EvalPlane`` — protocol: ``evaluate_batch(ks) -> scores`` (plus a
    scalar ``evaluate_one`` used by the per-k drivers). Anything with an
    ``evaluate_batch`` method qualifies; the batched factorization planes
    (``repro_torch.factorization.planes``) implement it with mask-padded vmapped
    fits, one jit compilation per padded shape.
  * ``ScalarEvalPlane`` — adapter wrapping today's scalar ``evaluate(k)``
    callables (optionally accepting ``should_abort``, §III-D) so the
    serial worklist, thread scheduler, and simulator all route through the
    same interface unchanged.
  * ``WavefrontScheduler`` — the batched executor: repeatedly collect the
    frontier of live subtree midpoints (independent under Alg 3/4
    semantics — no midpoint in a wave can prune another before scores
    land), dispatch them as one batch, fold every score into
    ``BleedState``, re-prune, and descend into the surviving subtrees.

Layering note: this module sits *below* ``bleed.py`` (which lazily imports
``as_eval_plane``), so it must not import ``bleed`` at module scope.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Protocol, Sequence, runtime_checkable

from repro_torch.obs import get_metrics, get_tracer

from .search_space import SearchResult, SearchSpace

AbortFn = Callable[[], bool]


@runtime_checkable
class EvalPlane(Protocol):
    """A surface that scores candidate k values, possibly many at once."""

    def evaluate_batch(self, ks: Sequence[int]) -> list[float]:
        """Score each k in ``ks``; returns scores aligned with the input."""
        ...

    def evaluate_one(self, k: int, should_abort: AbortFn | None = None) -> float:
        """Score a single k (scalar drivers; ``should_abort`` per §III-D)."""
        ...


class ScalarEvalPlane:
    """Adapter: a scalar ``evaluate(k)`` callable as an ``EvalPlane``.

    Detects once whether the callable accepts the §III-D ``should_abort``
    kwarg and forwards it only then, preserving the historical contract of
    ``ThreadPoolScheduler.run``.
    """

    def __init__(self, fn: Callable[..., float]):
        self.fn = fn
        self.accepts_abort = False
        try:
            self.accepts_abort = "should_abort" in inspect.signature(fn).parameters
        except (TypeError, ValueError):
            pass

    def evaluate_one(self, k: int, should_abort: AbortFn | None = None) -> float:
        # forward only a real callback: passing should_abort=None would
        # override a callable default the evaluator polls unconditionally
        if should_abort is not None and self.accepts_abort:
            return float(self.fn(k, should_abort=should_abort))
        return float(self.fn(k))

    def evaluate_batch(self, ks: Sequence[int]) -> list[float]:
        return [self.evaluate_one(k) for k in ks]


class _BatchOnlyAdapter:
    """Gives batch-only planes the scalar entry point the drivers expect."""

    def __init__(self, plane):
        self.plane = plane

    def evaluate_one(self, k: int, should_abort: AbortFn | None = None) -> float:
        # A black-box batch plane exposes no chunk boundary to poll
        # mid-fit, but the §III-D callback must not be silently dropped:
        # poll it before dispatching so a k pruned while queued never pays
        # for its fit at all (NaN is a void score — no threshold selects
        # it, so prune bounds and k_optimal are untouched). Planes with a
        # resumable fit implement ``evaluate_one`` themselves and poll at
        # every chunk boundary instead.
        if should_abort is not None and should_abort():
            return float("nan")
        return float(self.plane.evaluate_batch([k])[0])

    def evaluate_batch(self, ks: Sequence[int]) -> list[float]:
        return self.plane.evaluate_batch(ks)

    @property
    def last_lane_utilization(self):
        return getattr(self.plane, "last_lane_utilization", None)


def as_eval_plane(evaluate) -> EvalPlane:
    """Coerce a scalar callable or an EvalPlane-shaped object to EvalPlane."""
    if hasattr(evaluate, "evaluate_batch"):
        if hasattr(evaluate, "evaluate_one"):
            return evaluate
        return _BatchOnlyAdapter(evaluate)
    if callable(evaluate):
        return ScalarEvalPlane(evaluate)
    raise TypeError(f"cannot use {type(evaluate).__name__} as an evaluation plane")


@dataclasses.dataclass
class Wave:
    """One dispatched frontier: the ks sent together and their scores."""

    index: int
    ks: list[int]
    scores: list[float]
    lo_bound: float  # prune bounds after folding this wave's scores
    hi_bound: float


class WavefrontScheduler:
    """Batched Binary Bleed: evaluate frontiers of live midpoints as waves.

    Walks the same binary tree over ``space.ks`` as Algorithm 1, but
    breadth-first: the midpoints of all currently-live index intervals are
    independent (none is an ancestor of another), so they are dispatched to
    the plane as one ``evaluate_batch`` call. All returned scores are folded
    into the shared ``BleedState``, subtrees falling outside the updated
    bounds are dropped, and the next wave is the midpoints of the surviving
    children. Wave w holds at most 2^w entries, so a full run issues at most
    ceil(log2(|K|))+1 batch dispatches instead of one per visited k.

    Compared to the serial driver this may evaluate ks a just-landed wave
    would have pruned (same trade as the paper's multi-resource runs — a
    wave is "resources" executing concurrently), so visits form a superset
    of the serial schedule's but remain a subset of the pre-order worklist,
    and pruning soundness (pruned ks cannot be optimal) keeps ``k_optimal``
    identical for threshold-separable score shapes.

    ``max_wave`` caps the number of ks per dispatch (e.g. device memory);
    chunks of one wave re-check the prune state between dispatches, highest
    k first (``bleed_up_first``) since for the max-k objective high
    selecting ks prune the most.
    """

    def __init__(
        self,
        space: SearchSpace,
        max_wave: int | None = None,
        bleed_up_first: bool = True,
        tracer=None,
        metrics=None,
    ):
        if max_wave is not None and max_wave < 1:
            raise ValueError("max_wave must be >= 1")
        self.space = space
        self.max_wave = max_wave
        self.bleed_up_first = bleed_up_first
        self.waves: list[Wave] = []
        self._tracer = tracer
        self._metrics = metrics

    def run(self, evaluate, state=None) -> SearchResult:
        from .bleed import BleedState  # lazy: bleed sits above this module

        tracer = self._tracer if self._tracer is not None else get_tracer()
        metrics = self._metrics if self._metrics is not None else get_metrics()
        plane = as_eval_plane(evaluate)
        # tell capacity-aware planes the dispatch bound so their batch
        # padding (a compile-reuse optimization) never exceeds it; assign
        # unconditionally so a reused plane doesn't keep a stale cap
        if hasattr(plane, "dispatch_cap"):
            plane.dispatch_cap = self.max_wave
        space = self.space
        ks = space.ks
        state = state if state is not None else BleedState(space, tracer=tracer, metrics=metrics)
        self.waves = []
        wave_idx = 0
        intervals: list[tuple[int, int]] = [(0, len(ks))]  # [lo, hi) index spans

        while intervals:
            live = []
            for lo, hi in intervals:
                if lo >= hi:
                    continue
                if state.interval_alive(ks[lo], ks[hi - 1]):
                    live.append((lo, hi))
                else:
                    state.skip_interval(ks[lo], ks[hi - 1], hi - lo)
            mids = [lo + (hi - lo) // 2 for lo, hi in live]
            pending = []
            for m in mids:
                if state.should_visit(ks[m]):
                    pending.append(ks[m])
                else:
                    state.skip(ks[m])
            pending.sort(reverse=self.bleed_up_first)
            step = self.max_wave if self.max_wave is not None else max(len(pending), 1)
            for start in range(0, len(pending), step):
                # re-filter: earlier chunks of this wave may have pruned these
                chunk = []
                for k in pending[start : start + step]:
                    if state.should_visit(k):
                        chunk.append(k)
                    else:
                        state.skip(k, reason="pruned_by_chunk")
                if not chunk:
                    continue
                with tracer.span("wave", track="wavefront", wave=wave_idx, size=len(chunk),
                                 k_lo=min(chunk), k_hi=max(chunk)):
                    scores = plane.evaluate_batch(chunk)
                if len(scores) != len(chunk):
                    raise ValueError(
                        f"evaluate_batch returned {len(scores)} scores for {len(chunk)} ks"
                    )
                metrics.observe("wave_size", len(chunk))
                # mesh-sharded planes report real/dispatched lanes of the
                # dispatch they just ran; surface it as a live gauge next to
                # the wave_size histogram
                util = getattr(plane, "last_lane_utilization", None)
                if util is not None:
                    metrics.set_gauge("lane_utilization", float(util))
                with tracer.span("publish", track="wavefront", wave=wave_idx):
                    for k, score in zip(chunk, scores):
                        state.record(k, float(score), resource=wave_idx)
                self.waves.append(
                    Wave(wave_idx, list(chunk), [float(s) for s in scores],
                         state.lo_bound, state.hi_bound)
                )
                wave_idx += 1
            # descend: children of every live interval (midpoint evaluated or
            # not — Alg 1 recurses regardless); dead ones are filtered above.
            nxt: list[tuple[int, int]] = []
            for (lo, hi), mid in zip(live, mids):
                halves = ((mid + 1, hi), (lo, mid)) if self.bleed_up_first else ((lo, mid), (mid + 1, hi))
                nxt.extend(h for h in halves if h[0] < h[1])
            intervals = nxt

        return state.result()

    @property
    def n_dispatches(self) -> int:
        """Number of batch dispatches issued by the last ``run``."""
        return len(self.waves)


class ElasticWavefrontScheduler:
    """Continuous-batching Binary Bleed: a stream of fit-chunks, not waves.

    Drives an *elastic plane* (``submit(k)`` / ``cancel(k)`` / ``tick()`` /
    ``idle`` / ``inflight_ks()`` — e.g. ``repro_torch.factorization.planes.
    NMFkElasticPlane``) instead of ``evaluate_batch``. The unit of
    scheduling is one chunk of MU sweeps across every occupied lane; the
    driver's loop between chunks is where Binary Bleed happens:

      1. **admit** — drain ks from the pre-order traversal worklist into
         the plane's lane queue while the refill policy has room, skipping
         ks the current bounds already prune (the candidate stream of the
         wavefront executor is exactly this worklist — descent happens
         regardless of scores, pruning only filters — so elastic refill
         preserves Alg 1/3/4 visit semantics);
      2. **tick** — one chunk dispatch; converged/budget-exhausted lanes
         retire inside the plane and completed ks come back scored;
      3. **record** — fold scores into ``BleedState``, updating bounds;
      4. **evict** — cancel in-flight ks the new bounds prune (§III-D
         mid-fit abort, charged to ``ks_aborted`` / ``sweeps_saved``).

    Like the wave executor, concurrency makes visits a superset of the
    serial schedule but a subset of the pre-order worklist; pruning
    soundness keeps ``k_optimal`` identical for threshold-separable score
    shapes. Every k ends either recorded (scored) or skipped (pruned at
    admission or evicted), so visited + skipped == |K|.
    """

    def __init__(self, space: SearchSpace, refill=None, tracer=None, metrics=None):
        self.space = space
        self.refill = refill
        self._tracer = tracer
        self._metrics = metrics
        self.n_ticks = 0

    def run(self, plane, state=None) -> SearchResult:
        from .bleed import BleedState  # lazy: bleed sits above this module
        from .scheduler import LaneRefillPolicy

        tracer = self._tracer if self._tracer is not None else get_tracer()
        metrics = self._metrics if self._metrics is not None else get_metrics()
        policy = self.refill if self.refill is not None else LaneRefillPolicy()
        space = self.space
        state = state if state is not None else BleedState(space, tracer=tracer, metrics=metrics)
        worklist = list(policy.worklist(space.ks))
        pos = 0
        self.n_ticks = 0

        while True:
            # 1. admit: refill the lane queue from the live worklist prefix
            while pos < len(worklist) and policy.admit(plane):
                k = worklist[pos]
                pos += 1
                if state.should_visit(k):
                    plane.submit(k)
                else:
                    state.skip(k)
            if plane.idle:
                if pos >= len(worklist):
                    break
                # a refill policy must not starve an idle plane: force one
                # admission so the loop always progresses
                k = worklist[pos]
                pos += 1
                if state.should_visit(k):
                    plane.submit(k)
                else:
                    state.skip(k)
                continue
            # 2. tick: one chunk across all occupied lanes
            with tracer.span("tick", track="wavefront", tick=self.n_ticks):
                finished = plane.tick()
            self.n_ticks += 1
            occ = getattr(plane, "last_lane_occupancy", None)
            if occ is not None:
                metrics.set_gauge("lane_utilization", float(occ))
            # 3. record: fold completed scores into the prune bounds
            with tracer.span("publish", track="wavefront", tick=self.n_ticks - 1):
                for k, score in finished:
                    state.record(k, float(score), resource=self.n_ticks - 1)
            # 4. evict: ks the updated bounds prune stop paying mid-fit
            for k in sorted(plane.inflight_ks(), reverse=True):
                if not state.should_visit(k) and plane.cancel(k):
                    metrics.inc("ks_aborted")
                    tracer.event("abort", track="wavefront", k=k)
                    state.skip(k, reason="aborted")

        return state.result()

    @property
    def n_dispatches(self) -> int:
        """Number of chunk dispatches issued by the last ``run``."""
        return self.n_ticks


__all__ = [
    "EvalPlane",
    "ScalarEvalPlane",
    "WavefrontScheduler",
    "ElasticWavefrontScheduler",
    "Wave",
    "as_eval_plane",
]
