"""Control-plane fault tolerance for the distributed k-search + training.

On a 1000+-node cluster the failure model is: a resource (mesh slice /
host group) stops heartbeating mid-evaluation. Because Binary Bleed's unit
of work — "fit model at k, score it" — is pure and idempotent, recovery is
scheduling, not state surgery:

  * ``HeartbeatMonitor`` tracks liveness (injectable clock for tests),
  * on failure: the dead resource's unvisited chunk re-enters the pool and
    `core.chunking.rebalance` re-deals it (Algorithm 2 is stateless),
  * its in-flight k (never completed) is re-queued,
  * pruning state is NOT lost — it lives in the coordinator/journal, so the
    restarted search never re-visits completed k.

Training fits recover via checkpoint.restore (per-fit checkpoints), search
state via FileCoordinator.replay — both exercised in tests/test_runtime.py.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.core.chunking import rebalance
from repro_torch.core.traversal import Order
from repro_torch.obs import get_metrics, get_tracer


@dataclasses.dataclass
class ResourceView:
    rid: int
    last_beat: float
    worklist: list[int]
    in_flight: int | None = None
    alive: bool = True


class HeartbeatMonitor:
    """Failure detector + elastic re-planner over resource worklists."""

    def __init__(
        self,
        worklists: dict[int, list[int]],
        timeout: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        order: Order = "pre",
    ):
        self.clock = clock
        self.timeout = timeout
        self.order = order
        now = clock()
        self.resources = {
            rid: ResourceView(rid, now, list(wl)) for rid, wl in worklists.items()
        }
        self._next_rid = max(worklists, default=-1) + 1

    # -- liveness ---------------------------------------------------------------
    def beat(self, rid: int) -> None:
        if rid in self.resources and self.resources[rid].alive:
            self.resources[rid].last_beat = self.clock()

    def mark_in_flight(self, rid: int, k: int | None) -> None:
        if rid in self.resources:
            self.resources[rid].in_flight = k

    def check(self) -> list[int]:
        """Returns newly-dead rids and re-plans their work."""
        now = self.clock()
        ages = [now - r.last_beat for r in self.resources.values() if r.alive]
        if ages:
            get_metrics().set_gauge("heartbeat_age_max", max(ages))
        dead = [
            r.rid
            for r in self.resources.values()
            if r.alive and now - r.last_beat > self.timeout
        ]
        for rid in dead:
            self.fail(rid)
        return dead

    # -- elasticity ---------------------------------------------------------------
    def fail(self, rid: int) -> None:
        r = self.resources.get(rid)
        if r is None or not r.alive:
            return
        r.alive = False
        pool = list(r.worklist)
        requeued = r.in_flight
        if r.in_flight is not None:
            pool.append(r.in_flight)  # idempotent: safe to redo
            r.in_flight = None
        r.worklist = []
        get_metrics().inc("failures")
        get_tracer().event(
            "resource_failed", track="scheduler", rid=rid,
            requeued_in_flight=requeued, pool=len(pool),
        )
        self._redistribute(pool)

    def join(self, worklist: list[int] | None = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.resources[rid] = ResourceView(rid, self.clock(), worklist or [])
        if worklist is None:
            self._rebalance_all()
        get_metrics().inc("joins")
        get_tracer().event("resource_joined", track="scheduler", rid=rid)
        return rid

    def _survivors(self) -> list[ResourceView]:
        return [r for r in self.resources.values() if r.alive]

    def _redistribute(self, pool: list[int]) -> None:
        survivors = self._survivors()
        if not survivors:
            return
        merged = sorted(set(pool) | {k for r in survivors for k in r.worklist})
        if not merged:
            return
        new_lists = rebalance(merged, len(survivors), self.order)
        for r, wl in zip(sorted(survivors, key=lambda r: r.rid), new_lists):
            r.worklist = list(wl)

    def _rebalance_all(self) -> None:
        self._redistribute([])

    def remaining(self) -> set[int]:
        out = set()
        for r in self._survivors():
            out.update(r.worklist)
            if r.in_flight is not None:
                out.add(r.in_flight)
        return out
