"""Shared prune-state coordination (paper Alg 3/4's Redis / MPI broadcast).

The paper shares ``k_min`` / ``k_max`` / ``k_optimal`` across threads via a
mutex and across MPI ranks via broadcast, suggesting "a distributed cache
such as reddis". On a TPU cluster we avoid an external service:

  * ``InProcessCoordinator`` — lock-protected state for threads in one
    process (Alg 4's mutex).
  * ``FileCoordinator`` — a tiny atomic-rename JSON KV on shared storage
    for multi-host searches (each pod slice is a host-level "rank"); also
    doubles as the fault-tolerance journal: every visit is appended to a
    log so a restarted search replays all pruning decisions (checkpoint/
    restart of the *search* itself, not just the model fits).

Both expose the same interface: ``publish(...)`` merges monotone bounds
(lo only rises, hi only falls, k_optimal only rises) and ``snapshot()``
returns the current global bounds. Monotonicity makes merges commutative —
stale publishes are harmless, which is what makes the distributed version
coordination-light (the paper's broadcast can arrive in any order).
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Iterable, NamedTuple

from repro_torch.obs import get_metrics, get_tracer


class Bounds(NamedTuple):
    lo_bound: float  # ks <= lo_bound pruned (select crossings)
    hi_bound: float  # ks >= hi_bound pruned (stop crossings)
    k_optimal: int | None

    @staticmethod
    def empty() -> "Bounds":
        return Bounds(-math.inf, math.inf, None)

    def merge(self, other: "Bounds") -> "Bounds":
        k_opt = self.k_optimal
        if other.k_optimal is not None and (k_opt is None or other.k_optimal > k_opt):
            k_opt = other.k_optimal
        return Bounds(
            max(self.lo_bound, other.lo_bound),
            min(self.hi_bound, other.hi_bound),
            k_opt,
        )


class InProcessCoordinator:
    """Mutex-guarded shared bounds for thread resources (Alg 4)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._bounds = Bounds.empty()
        self._visits: list[tuple[int, float, int]] = []  # (k, score, resource)

    def publish(self, bounds: Bounds) -> Bounds:
        metrics = get_metrics()
        t0 = time.perf_counter()
        self._lock.acquire()
        t_locked = time.perf_counter()
        try:
            self._bounds = self._bounds.merge(bounds)
            merged = self._bounds
        finally:
            self._lock.release()
        metrics.observe("lock_wait_s", t_locked - t0)
        metrics.observe("publish_latency_s", time.perf_counter() - t0)
        metrics.inc("publish_count")
        return merged

    def record_visit(self, k: int, score: float, resource: int) -> None:
        with self._lock:
            self._visits.append((k, score, resource))

    def snapshot(self) -> Bounds:
        with self._lock:
            return self._bounds

    def visits(self) -> list[tuple[int, float, int]]:
        with self._lock:
            return list(self._visits)


class FileCoordinator:
    """Atomic-rename JSON KV + append-only journal on shared storage.

    Safe for concurrent writers on POSIX filesystems: state updates are
    read-merge-write with an exclusive lockfile; the journal is O_APPEND.
    This replaces the paper's Redis suggestion with zero extra services —
    on an HPC/TPU cluster the shared filesystem already exists.
    """

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._state_path = os.path.join(root, "bounds.json")
        self._journal_path = os.path.join(root, "journal.ndjson")
        self._lock_path = os.path.join(root, "bounds.lock")

    # -- tiny lockfile (NFS-safe enough: O_CREAT|O_EXCL with stale timeout) ----
    def _acquire(self, timeout: float = 10.0, stale: float = 30.0) -> None:
        deadline = time.time() + timeout
        t_wait0 = time.perf_counter()
        while True:
            try:
                fd = os.open(self._lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                get_metrics().observe("lock_wait_s", time.perf_counter() - t_wait0)
                return
            except FileExistsError:
                try:
                    st = os.stat(self._lock_path)
                except FileNotFoundError:
                    continue
                age = time.time() - st.st_mtime
                if age > stale:
                    # Break the dead holder's lock — but only if it is still
                    # the SAME file we just stat'ed. Two waiters can both see
                    # a stale lock; the first unlinks it and wins the O_EXCL
                    # retry, and without this re-check the second would
                    # unlink the winner's FRESH lock and "acquire" too.
                    try:
                        st2 = os.stat(self._lock_path)
                        if (st2.st_ino, st2.st_mtime_ns) == (st.st_ino, st.st_mtime_ns):
                            os.unlink(self._lock_path)
                            get_metrics().inc("lock_broken")
                            get_tracer().event(
                                "lock_broken", path=self._lock_path, age_s=round(age, 3)
                            )
                    except FileNotFoundError:
                        pass  # another waiter broke it first
                    continue
                if time.time() > deadline:
                    raise TimeoutError(f"lock {self._lock_path} busy")
                time.sleep(0.005)

    def _release(self) -> None:
        try:
            os.unlink(self._lock_path)
        except FileNotFoundError:
            pass

    def _read_state(self) -> Bounds:
        try:
            with open(self._state_path) as f:
                d = json.load(f)
            return Bounds(d["lo"], d["hi"], d["k_optimal"])
        except (FileNotFoundError, json.JSONDecodeError, KeyError):
            return Bounds.empty()

    def _write_state(self, b: Bounds) -> None:
        tmp = self._state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"lo": b.lo_bound, "hi": b.hi_bound, "k_optimal": b.k_optimal}, f)
        os.replace(tmp, self._state_path)  # atomic on POSIX

    # -- public API -------------------------------------------------------------
    def publish(self, bounds: Bounds) -> Bounds:
        metrics = get_metrics()
        t0 = time.perf_counter()
        self._acquire()
        try:
            merged = self._read_state().merge(bounds)
            self._write_state(merged)
        finally:
            self._release()
        metrics.observe("publish_latency_s", time.perf_counter() - t0)
        metrics.inc("publish_count")
        return merged

    def snapshot(self) -> Bounds:
        return self._read_state()

    def record_visit(self, k: int, score: float, resource: int) -> None:
        line = json.dumps({"k": k, "score": score, "resource": resource, "t": time.time()})
        with open(self._journal_path, "a") as f:
            f.write(line + "\n")

    def visits(self) -> list[tuple[int, float, int]]:
        out = []
        try:
            with open(self._journal_path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    d = json.loads(line)
                    out.append((d["k"], d["score"], d["resource"]))
        except FileNotFoundError:
            pass
        return out

    # -- restart ------------------------------------------------------------------
    def replay(self, selects, stops) -> tuple[Bounds, set[int]]:
        """Rebuild bounds + visited set from the journal (search restart).

        ``selects`` / ``stops`` are the SearchSpace threshold predicates; we
        re-apply them so a restart with *tightened* thresholds re-prunes
        correctly rather than trusting stale bounds.
        """
        b = Bounds.empty()
        visited: set[int] = set()
        for k, score, _ in self.visits():
            visited.add(k)
            lo = k if selects(score) else -math.inf
            hi = k if stops(score) else math.inf
            k_opt = k if selects(score) else None
            b = b.merge(Bounds(lo, hi, k_opt))
        self.publish(b)
        return b, visited


def merge_all(bounds: Iterable[Bounds]) -> Bounds:
    out = Bounds.empty()
    for b in bounds:
        out = out.merge(b)
    return out
