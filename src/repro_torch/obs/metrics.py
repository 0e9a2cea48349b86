"""Process-local metrics registry for the live search path.

Counters, gauges, and histograms created on first use by name, mutated
under one registry lock (increments bracket model fits — contention is
nil), and rolled up by ``summary()`` into a JSON-safe dict whose
``search`` block derives the paper's headline number from live accounting:

    visit_fraction = ks_visited / ks_candidates

i.e. the fraction of the k grid Binary Bleed actually evaluated vs. the
naive grid search's 1.0 — previously only available from the offline
``SimulatedScheduler``, now measured on every instrumented run.

Conventional names used across the instrumented layers:

  counters   ks_visited, ks_skipped, ks_aborted, ks_journaled,
             compile_count, publish_count, bound_merges, lock_broken,
             speculations, failures, joins,
             sweeps_run / sweeps_saved / sweeps_fixed_total (the elastic
             executor's MU-sweep accounting: run + saved == fixed_total),
             warm_start_hits (elastic lanes seeded from a neighbor's W)
  gauges     ks_candidates, heartbeat_age_max, lo_bound, hi_bound,
             lane_utilization (real / dispatched lanes of the last wave),
             lane_occupancy (occupied / dispatched lanes of the last
             elastic chunk)
  histograms wave_size, fit_seconds, publish_latency_s, lock_wait_s,
             lane_utilization (per-dispatch distribution),
             lane_occupancy (per-chunk distribution)
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterator

_HIST_CAP = 4096  # values kept for percentiles; count/sum/min/max stay exact


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float | None = None


class Histogram:
    __slots__ = ("count", "total", "min", "max", "values")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.values: list[float] = []

    def _observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self.values) < _HIST_CAP:
            self.values.append(v)

    def percentile(self, q: float) -> float | None:
        if not self.values:
            return None
        vals = sorted(self.values)
        idx = min(int(q * (len(vals) - 1) + 0.5), len(vals) - 1)
        return vals[idx]


def _finite(v: float | None) -> float | None:
    """JSON-safe: non-finite values become None (json.dump stays strict)."""
    if v is None or not math.isfinite(v):
        return None
    return float(v)


class Metrics:
    """Registry of named counters/gauges/histograms (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    # -- mutation ---------------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            c.value += n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            g.value = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h._observe(float(value))

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- reads ------------------------------------------------------------------
    def counter(self, name: str) -> int:
        with self._lock:
            c = self._counters.get(name)
            return c.value if c is not None else 0

    def gauge(self, name: str) -> float | None:
        with self._lock:
            g = self._gauges.get(name)
            return g.value if g is not None else None

    def histogram(self, name: str) -> dict | None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                return None
            return self._hist_summary(h)

    @staticmethod
    def _hist_summary(h: Histogram) -> dict:
        mean = h.total / h.count if h.count else None
        return {
            "count": h.count,
            "sum": _finite(h.total),
            "mean": _finite(mean) if mean is not None else None,
            "min": _finite(h.min),
            "max": _finite(h.max),
            "p50": _finite(h.percentile(0.50)),
            "p95": _finite(h.percentile(0.95)),
        }

    def summary(self) -> dict:
        """JSON-safe rollup + the derived pruning-efficiency ``search`` block."""
        with self._lock:
            counters = {k: c.value for k, c in sorted(self._counters.items())}
            gauges = {k: _finite(g.value) for k, g in sorted(self._gauges.items())}
            hists = {k: self._hist_summary(h) for k, h in sorted(self._hists.items())}
        visited = counters.get("ks_visited", 0)
        skipped = counters.get("ks_skipped", 0)
        aborted = counters.get("ks_aborted", 0)
        candidates = gauges.get("ks_candidates")
        visit_fraction = None
        if candidates:
            visit_fraction = visited / candidates
        search = {
            "ks_candidates": int(candidates) if candidates is not None else None,
            "ks_visited": visited,
            "ks_skipped": skipped,
            "ks_aborted": aborted,
            # headline: fraction of the grid evaluated (naive grid search = 1.0)
            "visit_fraction": _finite(visit_fraction) if visit_fraction is not None else None,
            "saved_vs_grid": _finite(1.0 - visit_fraction) if visit_fraction is not None else None,
            "compile_count": counters.get("compile_count", 0),
            "publish_count": counters.get("publish_count", 0),
        }
        if counters.get("sweeps_fixed_total"):
            # elastic executor ran: surface the sweep-level savings next to
            # the k-level visit fraction (both are fractions of naive work)
            run = counters.get("sweeps_run", 0)
            fixed = counters["sweeps_fixed_total"]
            search["sweeps_run"] = run
            search["sweeps_saved"] = counters.get("sweeps_saved", 0)
            search["sweeps_fixed_total"] = fixed
            search["sweep_fraction"] = _finite(run / fixed)
            search["warm_start_hits"] = counters.get("warm_start_hits", 0)
        return {"search": search, "counters": counters, "gauges": gauges, "histograms": hists}


# -- process default ------------------------------------------------------------
_default_metrics = Metrics()
_default_lock = threading.Lock()


def get_metrics() -> Metrics:
    """The process-default registry (always live — metrics are cheap)."""
    return _default_metrics


def set_metrics(metrics: Metrics) -> Metrics:
    """Install ``metrics`` as the process default; returns the previous one."""
    global _default_metrics
    with _default_lock:
        prev = _default_metrics
        _default_metrics = metrics
    return prev


@contextlib.contextmanager
def use_metrics(metrics: Metrics) -> Iterator[Metrics]:
    """Scoped ``set_metrics``: restores the previous default on exit."""
    prev = set_metrics(metrics)
    try:
        yield metrics
    finally:
        set_metrics(prev)


__all__ = ["Metrics", "Counter", "Gauge", "Histogram", "get_metrics", "set_metrics", "use_metrics"]
