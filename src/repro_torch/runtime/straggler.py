"""Straggler mitigation for distributed k evaluations.

Model fits at different k have different durations (larger k = bigger
factors) and different hardware luck (a slow host, a thermally-throttled
chip). Because evaluations are idempotent, the classic MapReduce remedy
applies: when a resource idles and the tail evaluation's elapsed time
exceeds ``factor`` × the running median of completed durations, launch a
speculative duplicate; first finisher wins, the coordinator drops the
loser. ``SpeculationPolicy`` is the pure decision kernel (simulated +
threaded schedulers both call it; tested in isolation).
"""
from __future__ import annotations

import dataclasses
import statistics

from repro_torch.obs import get_metrics, get_tracer


@dataclasses.dataclass
class SpeculationPolicy:
    factor: float = 1.5  # duplicate when elapsed > factor * median
    min_samples: int = 3  # need this many completions to trust the median
    max_duplicates: int = 1  # per k

    def __post_init__(self):
        self._durations: list[float] = []
        self._dup_counts: dict[int, int] = {}

    def observe_completion(self, k: int, duration: float) -> None:
        self._durations.append(duration)

    def should_speculate(self, k: int, elapsed: float) -> bool:
        if len(self._durations) < self.min_samples:
            return False
        if self._dup_counts.get(k, 0) >= self.max_duplicates:
            return False
        med = statistics.median(self._durations)
        return elapsed > self.factor * med

    def note_duplicate(self, k: int) -> None:
        self._dup_counts[k] = self._dup_counts.get(k, 0) + 1
        get_metrics().inc("speculations")
        get_tracer().event(
            "speculate", track="scheduler", k=k, duplicates=self._dup_counts[k]
        )

    def duplicates(self, k: int) -> int:
        """How many speculative duplicates were launched for ``k``."""
        return self._dup_counts.get(k, 0)
