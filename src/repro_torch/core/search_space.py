"""K search-space definition for Binary Bleed.

The paper searches an ordered set ``K = {k_min, ..., k_max}`` for

    k_optimal = max { k in K : S(f(k, D)) >= T }        (maximization)
    k_optimal = max { k in K : S(f(k, D)) <= T }        (minimization)

with an optional early-stop bound ``U`` (§III-C): once any score crosses U
in the "bad" direction, all larger k are pruned.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence


class Mode(str, enum.Enum):
    """Optimization direction of the scoring function.

    MAXIMIZE: silhouette-style — score is high (>= T) up to k_opt, low after.
    MINIMIZE: Davies-Bouldin-style — score is low (<= T) up to k_opt.
    """

    MAXIMIZE = "maximize"
    MINIMIZE = "minimize"


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """An ordered, duplicate-free k search space with thresholds.

    Attributes:
      ks: strictly increasing candidate k values.
      select_threshold: T — a score on the "good" side of T marks k as a
        candidate optimum and prunes all smaller unvisited k (Vanilla).
      stop_threshold: U — a score on the "bad" side of U prunes all larger
        unvisited k (Early Stop). ``None`` disables early stop.
      mode: maximize (silhouette) or minimize (Davies-Bouldin).
    """

    ks: tuple[int, ...]
    select_threshold: float
    stop_threshold: float | None = None
    mode: Mode = Mode.MAXIMIZE

    def __post_init__(self) -> None:
        ks = tuple(int(k) for k in self.ks)
        if len(ks) == 0:
            raise ValueError("search space must be non-empty")
        if any(b <= a for a, b in zip(ks, ks[1:])):
            raise ValueError("ks must be strictly increasing")
        object.__setattr__(self, "ks", ks)
        if self.stop_threshold is not None:
            # stop bound must be on the "bad" side of the select bound.
            if self.mode == Mode.MAXIMIZE and self.stop_threshold > self.select_threshold:
                raise ValueError("stop_threshold must be <= select_threshold for maximize")
            if self.mode == Mode.MINIMIZE and self.stop_threshold < self.select_threshold:
                raise ValueError("stop_threshold must be >= select_threshold for minimize")

    @classmethod
    def from_range(
        cls,
        k_min: int,
        k_max: int,
        select_threshold: float,
        stop_threshold: float | None = None,
        mode: Mode = Mode.MAXIMIZE,
        step: int = 1,
    ) -> "SearchSpace":
        return cls(tuple(range(k_min, k_max + 1, step)), select_threshold, stop_threshold, mode)

    def __len__(self) -> int:
        return len(self.ks)

    # --- threshold predicates -------------------------------------------------
    def selects(self, score: float) -> bool:
        """True if `score` crosses the select threshold T (prunes lower k)."""
        if self.mode == Mode.MAXIMIZE:
            return score >= self.select_threshold
        return score <= self.select_threshold

    def stops(self, score: float) -> bool:
        """True if `score` crosses the stop threshold U (prunes higher k)."""
        if self.stop_threshold is None:
            return False
        if self.mode == Mode.MAXIMIZE:
            return score <= self.stop_threshold
        return score >= self.stop_threshold


@dataclasses.dataclass
class VisitRecord:
    """One (k, score) evaluation — an element of the paper's ``ranks_seen``."""

    k: int
    score: float
    resource: int = 0
    pruned_lower: bool = False
    pruned_upper: bool = False
    wall_order: int = -1  # global completion order across resources


@dataclasses.dataclass
class SearchResult:
    """Outcome of a Binary Bleed run.

    ``visits`` preserves evaluation order; ``k_optimal`` is None when no k
    crossed the select threshold (the paper returns "not found" — callers
    fall back to argmax/argmin of the seen scores if they want a best-effort
    answer).
    """

    k_optimal: int | None
    visits: list[VisitRecord]
    n_candidates: int

    @property
    def n_visited(self) -> int:
        return len(self.visits)

    @property
    def visit_fraction(self) -> float:
        return self.n_visited / max(1, self.n_candidates)

    @property
    def visited_ks(self) -> list[int]:
        return [v.k for v in self.visits]

    def best_effort_k(self, mode: Mode = Mode.MAXIMIZE) -> int | None:
        """k_optimal, falling back to extremal seen score when nothing selected."""
        if self.k_optimal is not None:
            return self.k_optimal
        if not self.visits:
            return None
        key = (lambda v: v.score) if mode == Mode.MAXIMIZE else (lambda v: -v.score)
        return max(self.visits, key=key).k


def validate_ks(ks: Sequence[int]) -> tuple[int, ...]:
    out = tuple(sorted(set(int(k) for k in ks)))
    if not out:
        raise ValueError("empty k list")
    return out
