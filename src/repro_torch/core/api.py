"""Public Binary Bleed API.

    from repro_torch.core import binary_bleed_search, SearchSpace, Mode

    result = binary_bleed_search(
        evaluate=lambda k: my_model_score(k),
        k_range=(2, 30),
        select_threshold=0.7,
        stop_threshold=0.2,          # optional Early Stop (§III-C)
        mode="maximize",
        num_resources=4,             # 1 = serial Algorithm 1
        order="pre",
    )
    result.k_optimal, result.visit_fraction

Executors: serial worklist (num_resources=1), "threads" (one fit per k per
worker thread), "simulate" (deterministic discrete-event), and "batched" —
the wavefront executor, which dispatches each frontier of live midpoints as
one ``evaluate_batch`` call against an ``EvalPlane`` (e.g. the mask-padded
vmapped fits in ``repro_torch.factorization.planes``), amortizing trace/JIT/
dispatch across every k in the wave.
"""
from __future__ import annotations

from typing import Callable, Sequence

from .bleed import binary_bleed_recursive, binary_bleed_worklist, standard_search
from .evalplane import (
    ElasticWavefrontScheduler,
    EvalPlane,
    ScalarEvalPlane,
    WavefrontScheduler,
    as_eval_plane,
)
from .scheduler import (
    LaneRefillPolicy,
    ScheduleTrace,
    SimulatedScheduler,
    ThreadPoolScheduler,
)
from .search_space import Mode, SearchResult, SearchSpace
from .traversal import Order


def make_space(
    k_range: tuple[int, int] | Sequence[int],
    select_threshold: float,
    stop_threshold: float | None = None,
    mode: str | Mode = Mode.MAXIMIZE,
) -> SearchSpace:
    mode = Mode(mode)
    if isinstance(k_range, tuple) and len(k_range) == 2 and isinstance(k_range[0], int):
        ks = tuple(range(k_range[0], k_range[1] + 1))
    else:
        ks = tuple(sorted(set(int(k) for k in k_range)))
    return SearchSpace(ks, select_threshold, stop_threshold, mode)


def binary_bleed_search(
    evaluate: Callable[..., float],
    k_range: tuple[int, int] | Sequence[int],
    select_threshold: float,
    stop_threshold: float | None = None,
    mode: str | Mode = Mode.MAXIMIZE,
    num_resources: int = 1,
    order: Order = "pre",
    strategy: str = "T4",
    executor: str = "threads",
    max_wave: int | None = None,
) -> SearchResult:
    """Run Binary Bleed over k_range; returns SearchResult.

    Executors:

    * ``"threads"`` (default) — ``num_resources`` worker threads, each
      walking a T4 worklist and fitting one k at a time; prune bounds are
      shared through a coordinator. ``num_resources == 1`` runs the serial
      Algorithm 1 (worklist form) instead.
    * ``"simulate"`` — deterministic discrete-event simulation of the same
      plan (used by benchmarks; evaluation still happens exactly once per
      visited k).
    * ``"batched"`` — the wavefront executor: the frontier of live subtree
      midpoints is dispatched as ONE ``evaluate_batch`` call per wave, so a
      single padded/vmapped fit (e.g. ``repro_torch.factorization.planes``)
      serves every k in the wave with one jit compilation. ``evaluate``
      may be a scalar callable (batched trivially) or any ``EvalPlane``;
      ``max_wave`` caps the ks per dispatch. ``num_resources`` is ignored —
      parallelism comes from the batch axis, not threads.
    * ``"elastic"`` — continuous batching over fit-chunks: ``evaluate``
      must be an elastic plane (``submit``/``cancel``/``tick`` — e.g.
      ``repro_torch.factorization.planes.NMFkElasticPlane``). Lanes retire on
      per-fit convergence, freed slots refill from the pre-order worklist
      (``order`` is taken from the plane-side ``LaneRefillPolicy``), and
      prunes evict in-flight ks mid-fit.
    """
    space = make_space(k_range, select_threshold, stop_threshold, mode)
    if executor == "batched":
        return WavefrontScheduler(space, max_wave=max_wave).run(evaluate)
    if executor == "elastic":
        return ElasticWavefrontScheduler(space, refill=LaneRefillPolicy(order=order)).run(evaluate)
    if num_resources <= 1:
        return binary_bleed_worklist(space, evaluate, order=order)
    if executor == "threads":
        return ThreadPoolScheduler(space, num_resources, order, strategy).run(evaluate)
    if executor == "simulate":
        trace = SimulatedScheduler(space, num_resources, order, strategy).run(evaluate)
        return trace.to_result()
    raise ValueError(f"unknown executor {executor!r}")


def grid_search(
    evaluate: Callable[[int], float],
    k_range: tuple[int, int] | Sequence[int],
    select_threshold: float,
    mode: str | Mode = Mode.MAXIMIZE,
) -> SearchResult:
    """The paper's Standard baseline (visits 100% of K)."""
    return standard_search(make_space(k_range, select_threshold, None, mode), evaluate)


__all__ = [
    "binary_bleed_search",
    "grid_search",
    "make_space",
    "binary_bleed_recursive",
    "binary_bleed_worklist",
    "standard_search",
    "EvalPlane",
    "ScalarEvalPlane",
    "WavefrontScheduler",
    "ElasticWavefrontScheduler",
    "LaneRefillPolicy",
    "as_eval_plane",
    "SimulatedScheduler",
    "ThreadPoolScheduler",
    "ScheduleTrace",
    "SearchSpace",
    "SearchResult",
    "Mode",
]
