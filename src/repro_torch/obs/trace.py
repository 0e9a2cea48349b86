"""Search-wide tracing: nested spans + events, Perfetto/JSONL export.

Design constraints (this module is imported by the hot search path):

  * **dependency-free** — stdlib only, importable from any layer;
  * **allocation-free when off** — the default tracer is a singleton
    ``NullTracer`` whose ``span()`` returns one shared no-op context
    manager and whose ``event()`` is a bare ``pass``;
  * **thread-safe when on** — workers of ``ThreadPoolScheduler`` and the
    wavefront loop append to one buffer under a lock (appends are tiny
    dicts; the model fits they bracket are milliseconds-to-minutes).

Span/event records carry a ``track`` — the timeline they belong to
("resource-3", "wavefront", "device:0"). The Perfetto export maps each
track to a Chrome-trace ``tid`` with a ``thread_name`` metadata record, so
`ui.perfetto.dev` / ``chrome://tracing`` render one lane per resource.

Timestamps are microseconds relative to the tracer's creation
(``time.perf_counter`` based, injectable for tests). Simulated schedules
(logical time) inject spans directly via ``add_span`` — see
``ScheduleTrace.to_tracer``.
"""
from __future__ import annotations

import contextlib
import json
import math
import threading
import time
from typing import Any, Callable, Iterator


def _json_safe(v: Any) -> Any:
    """Strict-JSON attr values: ±inf/nan become strings, odd types str()."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    return str(v)


class Span:
    """One timed region; a context manager handed out by ``Tracer.span``."""

    __slots__ = ("name", "track", "attrs", "ts_us", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, track: str | None, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.attrs = attrs
        self.ts_us = 0.0

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes discovered mid-span (e.g. the score)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self.ts_us = self._tracer._now_us()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._complete(self)


class _NullSpan:
    """Shared no-op span: zero allocations on the disabled path."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every operation is a no-op, nothing is buffered."""

    enabled = False

    def span(self, name: str, track: str | None = None, **attrs: Any) -> _NullSpan:
        return _NULL_SPAN

    def event(self, name: str, track: str | None = None, **attrs: Any) -> None:
        pass

    def add_span(
        self, name: str, ts_us: float, dur_us: float, track: str | None = None, **attrs: Any
    ) -> None:
        pass

    def add_event(self, name: str, ts_us: float, track: str | None = None, **attrs: Any) -> None:
        pass

    def now_us(self) -> float:
        return 0.0

    def events(self) -> list[dict]:
        return []


NULL_TRACER = NullTracer()


class Tracer:
    """Buffered, thread-safe span/event recorder.

    Records are plain dicts:
      spans  — ``{"name", "ph": "X", "ts", "dur", "track", "args"}``
      events — ``{"name", "ph": "i", "ts", "track", "args"}``
    (``ts``/``dur`` in microseconds since tracer creation.)
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._records: list[dict] = []

    # -- recording ------------------------------------------------------------
    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def now_us(self) -> float:
        """Current tracer-relative timestamp (µs) — pair with ``add_span``
        to inject retroactive spans (e.g. per-device lanes of a dispatch
        whose wall interval is only known after the batch completes)."""
        return self._now_us()

    def _complete(self, span: Span) -> None:
        end = self._now_us()
        rec = {
            "name": span.name,
            "ph": "X",
            "ts": span.ts_us,
            "dur": max(end - span.ts_us, 0.0),
            "track": span.track if span.track is not None else _current_track(),
            "args": span.attrs,
        }
        with self._lock:
            self._records.append(rec)

    def span(self, name: str, track: str | None = None, **attrs: Any) -> Span:
        return Span(self, name, track, attrs)

    def event(self, name: str, track: str | None = None, **attrs: Any) -> None:
        rec = {
            "name": name,
            "ph": "i",
            "ts": self._now_us(),
            "track": track if track is not None else _current_track(),
            "args": attrs,
        }
        with self._lock:
            self._records.append(rec)

    # manual injection (simulated schedules replaying logical time)
    def add_span(
        self, name: str, ts_us: float, dur_us: float, track: str | None = None, **attrs: Any
    ) -> None:
        rec = {
            "name": name,
            "ph": "X",
            "ts": float(ts_us),
            "dur": max(float(dur_us), 0.0),
            "track": track if track is not None else _current_track(),
            "args": attrs,
        }
        with self._lock:
            self._records.append(rec)

    def add_event(self, name: str, ts_us: float, track: str | None = None, **attrs: Any) -> None:
        rec = {
            "name": name,
            "ph": "i",
            "ts": float(ts_us),
            "track": track if track is not None else _current_track(),
            "args": attrs,
        }
        with self._lock:
            self._records.append(rec)

    # -- inspection / export ----------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    def export_jsonl(self, path: str) -> int:
        """One JSON record per line; returns the number of records written."""
        recs = self.events()
        with open(path, "w") as f:
            for rec in recs:
                f.write(json.dumps({**rec, "args": _json_safe(rec["args"])}) + "\n")
        return len(recs)

    def to_chrome_trace(self) -> dict:
        """Chrome-trace/Perfetto JSON object (``{"traceEvents": [...]}``).

        Tracks become tids (first-seen order) with ``thread_name`` metadata
        so Perfetto shows one named lane per resource/worker.
        """
        recs = self.events()
        tids: dict[str, int] = {}
        out: list[dict] = []
        for rec in recs:
            track = str(rec["track"])
            if track not in tids:
                tids[track] = len(tids) + 1
                out.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": 1,
                        "tid": tids[track],
                        "args": {"name": track},
                    }
                )
            ev = {
                "name": rec["name"],
                "ph": rec["ph"],
                "ts": rec["ts"],
                "pid": 1,
                "tid": tids[track],
                "cat": "search",
                "args": _json_safe(rec["args"]),
            }
            if rec["ph"] == "X":
                ev["dur"] = rec["dur"]
            else:
                ev["s"] = "t"  # instant scope: thread
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_perfetto(self, path: str) -> int:
        """Write Chrome-trace JSON loadable by ui.perfetto.dev; returns #events."""
        trace = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])


def _current_track() -> str:
    """Default track: the current thread (workers get their own lane)."""
    t = threading.current_thread()
    return "main" if t is threading.main_thread() else t.name


# -- process default ------------------------------------------------------------
_default_tracer: NullTracer | Tracer = NULL_TRACER
_default_lock = threading.Lock()


def get_tracer() -> NullTracer | Tracer:
    """The process-default tracer (``NULL_TRACER`` unless installed)."""
    return _default_tracer


def set_tracer(tracer: NullTracer | Tracer) -> NullTracer | Tracer:
    """Install ``tracer`` as the process default; returns the previous one."""
    global _default_tracer
    with _default_lock:
        prev = _default_tracer
        _default_tracer = tracer
    return prev


@contextlib.contextmanager
def use_tracer(tracer: NullTracer | Tracer) -> Iterator[NullTracer | Tracer]:
    """Scoped ``set_tracer``: restores the previous default on exit."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


__all__ = [
    "Span",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "get_tracer",
    "set_tracer",
    "use_tracer",
]
