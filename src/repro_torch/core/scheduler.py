"""Multi-resource Binary Bleed scheduler (paper Algorithms 3 & 4).

Two executors over the same plan (Alg 2 chunking + traversal sort, T4):

  * ``SimulatedScheduler`` — a deterministic discrete-event simulator used
    by the reproduction benchmarks (Figs 2-6 operation dynamics, Fig 7/8
    visit percentages, Fig 9 distributed runtimes). Each "resource" is a
    mesh slice / MPI rank / thread; fit durations come from a user model
    (e.g. measured per-k NMF times). Broadcast of prune bounds is
    instantaneous on completion, matching the paper's implementation where
    in-flight fits are NOT aborted by default ("the implementation shown
    does not prune k values after the model begins execution", Fig 4) —
    optional ``abort_in_flight`` enables §III-D early termination.

  * ``ThreadPoolScheduler`` — real concurrency: one worker per resource
    walking its worklist, sharing bounds through a Coordinator
    (InProcess for threads, File for multi-host). Supports straggler
    speculation and elastic re-chunking on resource failure.

Fault-tolerance model: k evaluations are pure/idempotent (a model fit at a
given k with fixed seed), so (a) duplicated work is safe — first finisher
wins; (b) a dead resource's unvisited chunk can be re-dealt (Alg 2) over
the survivors; (c) the journal makes restarts exact.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Callable, Sequence

from repro_torch.obs import get_metrics, get_tracer
from repro_torch.obs.trace import Tracer

from .bleed import BleedState
from .chunking import plan_worklists, rebalance
from .coordinator import Bounds, InProcessCoordinator
from .evalplane import as_eval_plane
from .search_space import SearchResult, SearchSpace, VisitRecord
from .traversal import Order

EvalFn = Callable[[int], float]
DurationFn = Callable[[int], float]


@dataclasses.dataclass
class SimVisit:
    k: int
    score: float
    resource: int
    t_start: float
    t_end: float
    aborted: bool = False  # started, then pruned mid-flight (§III-D)


@dataclasses.dataclass
class ScheduleTrace:
    """Full account of a simulated run — the benchmark's ground truth."""

    k_optimal: int | None
    visits: list[SimVisit]  # completed evaluations (cost incurred)
    aborted: list[SimVisit]  # partial evaluations (cost partially incurred)
    skipped: list[int]  # pruned before starting (cost saved)
    makespan: float
    n_candidates: int
    busy_time: float  # sum of evaluation time across resources
    num_resources: int

    @property
    def n_visited(self) -> int:
        return len(self.visits) + len(self.aborted)

    @property
    def visit_fraction(self) -> float:
        return self.n_visited / max(1, self.n_candidates)

    def to_result(self) -> SearchResult:
        recs = [
            VisitRecord(k=v.k, score=v.score, resource=v.resource, wall_order=i)
            for i, v in enumerate(sorted(self.visits, key=lambda v: v.t_end))
        ]
        return SearchResult(self.k_optimal, recs, self.n_candidates)

    def to_tracer(self) -> Tracer:
        """Replay the simulated schedule into the live trace format.

        Logical sim seconds map to trace microseconds (1 s -> 1e6 us), one
        track per resource — the same shape a live ``ThreadPoolScheduler``
        run produces, so simulated and real schedules open side by side in
        Perfetto / ``chrome://tracing``.
        """
        tracer = Tracer()
        for v in sorted(self.visits + self.aborted, key=lambda v: (v.t_start, v.k)):
            tracer.add_span(
                "fit", v.t_start * 1e6, (v.t_end - v.t_start) * 1e6,
                track=f"resource-{v.resource}", k=v.k, score=v.score, aborted=v.aborted,
            )
            if v.aborted:
                tracer.add_event("abort", v.t_end * 1e6, track=f"resource-{v.resource}", k=v.k)
        if self.skipped:
            tracer.add_event(
                "skipped", self.makespan * 1e6, track="scheduler",
                count=len(self.skipped), ks=list(self.skipped),
            )
        return tracer

    def export_perfetto(self, path: str) -> int:
        """Write the schedule as Chrome-trace JSON; returns #events."""
        return self.to_tracer().export_perfetto(path)


@dataclasses.dataclass
class ResourceEvent:
    """Elasticity event: at time t, resource `rid` fails or a new one joins."""

    t: float
    kind: str  # "fail" | "join"
    rid: int


class SimulatedScheduler:
    """Deterministic discrete-event execution of multi-resource Binary Bleed."""

    def __init__(
        self,
        space: SearchSpace,
        num_resources: int,
        order: Order = "pre",
        strategy: str = "T4",
        duration_fn: DurationFn | None = None,
        abort_in_flight: bool = False,
        speculate_stragglers: bool = False,
        events: Sequence[ResourceEvent] = (),
    ):
        self.space = space
        self.num_resources = num_resources
        self.order = order
        self.strategy = strategy
        self.duration_fn = duration_fn or (lambda k: 1.0)
        self.abort_in_flight = abort_in_flight
        self.speculate = speculate_stragglers
        self.events = sorted(events, key=lambda e: e.t)

    def run(self, evaluate: EvalFn) -> ScheduleTrace:
        plane = as_eval_plane(evaluate)
        state = BleedState(self.space)
        worklists = plan_worklists(self.space.ks, self.num_resources, self.order, self.strategy)
        queues: dict[int, list[int]] = {r: list(w) for r, w in enumerate(worklists)}
        alive: set[int] = set(queues)
        running: dict[int, tuple[int, float, float]] = {}  # rid -> (k, t_start, t_end)
        in_flight_ks: dict[int, list[int]] = {}  # k -> [rids] (speculation dups)
        visits: list[SimVisit] = []
        aborted: list[SimVisit] = []
        skipped: list[int] = []
        busy = 0.0
        now = 0.0
        next_rid = self.num_resources
        ev_i = 0
        started: set[int] = set()  # ks whose evaluation ever started
        scores: dict[int, float] = {}

        def pop_next(rid: int) -> int | None:
            q = queues.get(rid, [])
            while q:
                k = q.pop(0)
                if k in started:
                    continue
                if state.should_visit(k):
                    return k
                skipped.append(k)
            return None

        def dispatch(rid: int) -> None:
            if rid in running or rid not in alive:
                return
            k = pop_next(rid)
            if k is None and self.speculate:
                # straggler speculation: duplicate the in-flight k that will
                # finish last (idempotent fits; first finisher wins).
                cands = [
                    (t_end, kk)
                    for r2, (kk, _, t_end) in running.items()
                    if r2 != rid and state.should_visit(kk)
                ]
                if cands:
                    _, kk = max(cands)
                    dur = self.duration_fn(kk)
                    running[rid] = (kk, now, now + dur)
                    in_flight_ks.setdefault(kk, []).append(rid)
                    return
            if k is not None:
                dur = self.duration_fn(k)
                started.add(k)
                running[rid] = (k, now, now + dur)
                in_flight_ks.setdefault(k, []).append(rid)

        def handle_events_until(t: float) -> None:
            nonlocal ev_i, next_rid
            while ev_i < len(self.events) and self.events[ev_i].t <= t:
                ev = self.events[ev_i]
                ev_i += 1
                if ev.kind == "fail" and ev.rid in alive:
                    alive.discard(ev.rid)
                    # in-flight work lost: the k never completed, re-queue it
                    if ev.rid in running:
                        k, t_s, _ = running.pop(ev.rid)
                        dup_list = in_flight_ks.get(k, [])
                        if ev.rid in dup_list:
                            dup_list.remove(ev.rid)
                        if not dup_list:
                            started.discard(k)  # nobody else running it -> redo
                    # elastic re-chunk: pool unvisited ks over survivors (Alg 2)
                    pool = sorted(
                        {k for q in queues.values() for k in q if k not in started}
                    )
                    survivors = sorted(alive)
                    if survivors and pool:
                        new_lists = rebalance(pool, len(survivors), self.order)
                        for q in queues.values():
                            q.clear()
                        for r2, wl in zip(survivors, new_lists):
                            queues[r2] = list(wl)
                elif ev.kind == "join":
                    rid = next_rid
                    next_rid += 1
                    alive.add(rid)
                    queues[rid] = []
                    pool = sorted(
                        {k for q in queues.values() for k in q if k not in started}
                    )
                    survivors = sorted(alive)
                    if pool:
                        new_lists = rebalance(pool, len(survivors), self.order)
                        for q in queues.values():
                            q.clear()
                        for r2, wl in zip(survivors, new_lists):
                            queues[r2] = list(wl)

        handle_events_until(0.0)
        for rid in sorted(alive):
            dispatch(rid)

        while running:
            # advance to the earliest completion (or event)
            t_next = min(t_end for (_, _, t_end) in running.values())
            if ev_i < len(self.events) and self.events[ev_i].t < t_next:
                now = self.events[ev_i].t
                handle_events_until(now)
                for rid in sorted(alive):
                    dispatch(rid)
                continue
            now = t_next
            done = sorted(rid for rid, (_, _, te) in running.items() if te <= now)
            for rid in done:
                k, t_s, t_e = running.pop(rid)
                dup_list = in_flight_ks.get(k, [])
                if rid in dup_list:
                    dup_list.remove(rid)
                busy += t_e - t_s
                if k in scores:  # speculation duplicate finished second
                    continue
                score = plane.evaluate_one(k)
                scores[k] = score
                state.record(k, score, resource=rid)
                visits.append(SimVisit(k, score, rid, t_s, t_e))
                # duplicate runs of k elsewhere are now pointless — cancel
                for r2 in list(dup_list):
                    kk, ts2, _ = running.pop(r2)
                    busy += now - ts2
                    dup_list.remove(r2)
            if self.abort_in_flight:
                # §III-D: long fits poll prune state between chunks and exit
                for rid, (k, t_s, t_e) in list(running.items()):
                    if not state.should_visit(k):
                        running.pop(rid)
                        dup_list = in_flight_ks.get(k, [])
                        if rid in dup_list:
                            dup_list.remove(rid)
                        busy += now - t_s
                        aborted.append(SimVisit(k, float("nan"), rid, t_s, now, aborted=True))
            for rid in sorted(alive):
                dispatch(rid)

        # drain queues of never-started ks into skipped
        for q in queues.values():
            for k in q:
                if k not in started:
                    skipped.append(k)

        return ScheduleTrace(
            k_optimal=state.k_optimal,
            visits=visits,
            aborted=aborted,
            skipped=sorted(set(skipped)),
            makespan=now,
            n_candidates=len(self.space.ks),
            busy_time=busy,
            num_resources=self.num_resources,
        )


@dataclasses.dataclass
class LaneRefillPolicy:
    """When and what the elastic executor drains into freed lanes.

    The candidate stream is the Binary Bleed traversal worklist (pre-order
    by default — the order whose prefixes the serial and threaded drivers
    walk, so elastic refill preserves their visit semantics: admission only
    ever *filters* that stream against the live prune bounds, never
    reorders it). ``max_backlog`` bounds how many (k, perturbation) lanes
    may sit queued in the plane beyond its occupied slots — a small backlog
    keeps freed lanes refilling without host round-trips, while a large one
    admits ks so early that later prunes must evict them; ``None`` uses one
    slot-pool's worth (the plane's ``slots``).
    """

    order: Order = "pre"
    max_backlog: int | None = None

    def worklist(self, ks: Sequence[int]) -> list[int]:
        from .traversal import traversal_sort

        return traversal_sort(list(ks), self.order)

    def admit(self, plane) -> bool:
        cap = self.max_backlog if self.max_backlog is not None else getattr(plane, "slots", 1)
        return plane.backlog < cap


class ThreadPoolScheduler:
    """Real-concurrency Binary Bleed across thread resources (Alg 3/4).

    Each worker owns a T4 worklist; shared bounds live in a Coordinator.
    ``evaluate`` may accept a ``should_abort`` kwarg — a zero-arg callable
    it can poll between fit chunks (§III-D) to stop early when its k has
    been pruned by another resource.
    """

    def __init__(
        self,
        space: SearchSpace,
        num_resources: int,
        order: Order = "pre",
        strategy: str = "T4",
        coordinator=None,  # InProcessCoordinator | FileCoordinator (duck-typed)
    ):
        self.space = space
        self.num_resources = num_resources
        self.order = order
        self.strategy = strategy
        self.coordinator = coordinator if coordinator is not None else InProcessCoordinator()

    def run(self, evaluate: Callable[..., float], skip: set[int] | None = None) -> SearchResult:
        plane = as_eval_plane(evaluate)
        space = self.space
        coord = self.coordinator
        tracer = get_tracer()
        metrics = get_metrics()
        metrics.set_gauge("ks_candidates", len(space.ks))
        worklists = plan_worklists(space.ks, self.num_resources, self.order, self.strategy)
        errors: list[BaseException] = []

        def make_should_visit():
            def should_visit(k: int) -> bool:
                b = coord.snapshot()
                return b.lo_bound < k < b.hi_bound

            return should_visit

        def worker(rid: int, worklist: list[int]) -> None:
            track = f"resource-{rid}"
            should_visit = make_should_visit()

            def make_should_abort(k: int):
                # §III-D poll, instrumented: the first True is the abort
                # signal actually delivered to an in-flight fit — count it.
                fired = []

                def should_abort() -> bool:
                    pruned = not should_visit(k)
                    if pruned and not fired:
                        fired.append(True)
                        metrics.inc("ks_aborted")
                        tracer.event("abort", track=track, k=k)
                    return pruned

                return should_abort

            try:
                with tracer.span("worker", track=track, rid=rid, worklist_len=len(worklist)):
                    for k in worklist:
                        if skip and k in skip:  # journaled on a previous run
                            metrics.inc("ks_journaled")
                            continue
                        if not should_visit(k):
                            metrics.inc("ks_skipped")
                            tracer.event("skip", track=track, k=k, reason="pruned")
                            continue
                        t_fit = time.perf_counter()
                        with tracer.span("fit", track=track, k=k) as sp:
                            score = plane.evaluate_one(k, should_abort=make_should_abort(k))
                            sp.set(score=float(score))
                        metrics.observe("fit_seconds", time.perf_counter() - t_fit)
                        metrics.inc("ks_visited")
                        lo = k if space.selects(score) else -float("inf")
                        hi = k if space.stops(score) else float("inf")
                        k_opt = k if space.selects(score) else None
                        with tracer.span("publish", track=track, k=k):
                            coord.record_visit(k, float(score), rid)
                            coord.publish(Bounds(lo, hi, k_opt))
            except BaseException as e:  # surface worker crashes to the driver
                errors.append(e)

        threads = [
            threading.Thread(target=worker, args=(rid, wl), daemon=True)
            for rid, wl in enumerate(worklists)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

        b = coord.snapshot()
        visits = [
            VisitRecord(k=k, score=s, resource=r, wall_order=i)
            for i, (k, s, r) in enumerate(coord.visits())
        ]
        return SearchResult(b.k_optimal, visits, len(space.ks))
