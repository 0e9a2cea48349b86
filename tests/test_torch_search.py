"""Port search layer vs ``repro.core`` on the §III-D synthetic score models.

Serial (worklist and recursive), threads, batched (wavefront) and
simulated runs on the square-wave and Laplacian scores give the same
``SearchResult`` as the reference: ``k_optimal``, visited set and
``visit_fraction``. A threaded run with several workers visits in a
timing-dependent order, so there only ``k_optimal`` is compared; with one
worker its visits are deterministic and compared in full.
"""
import math

import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core import scoring as jscoring  # noqa: E402
from repro_torch.core import scoring as tscoring  # noqa: E402


def _scores(kind: str, k0: int):
    if kind == "square":
        return (lambda k: float(jscoring.square_wave_score(k, k0)),
                lambda k: float(tscoring.square_wave_score(k, k0)))
    return (lambda k: float(jscoring.laplacian_score(k, k0, width=0.5)),
            lambda k: float(tscoring.laplacian_score(k, k0, width=0.5)))


def _same(a, b):
    assert a.k_optimal == b.k_optimal
    assert sorted(a.visited_ks) == sorted(b.visited_ks)
    assert math.isclose(a.visit_fraction, b.visit_fraction)


CASES = [("square", 2), ("square", 11), ("square", 30), ("laplace", 7), ("laplace", 21)]


def _space(core, kind):
    if kind == "square":
        return core.make_space((2, 30), 0.7)
    return core.make_space((2, 30), 0.9, stop_threshold=0.05)


@pytest.mark.parametrize("kind,k0", CASES)
@pytest.mark.parametrize("driver", ["worklist", "recursive", "batched", "threads1"])
def test_deterministic_drivers_match_reference(kind, k0, driver):
    j_eval, t_eval = _scores(kind, k0)
    runs = []
    for core, ev in ((jcore, j_eval), (tcore, t_eval)):
        space = _space(core, kind)
        if driver == "worklist":
            runs.append(core.binary_bleed_worklist(space, ev, order="pre"))
        elif driver == "recursive":
            runs.append(core.binary_bleed_recursive(space, ev))
        elif driver == "batched":
            runs.append(core.WavefrontScheduler(space, max_wave=4).run(ev))
        else:
            runs.append(core.ThreadPoolScheduler(space, 1).run(ev))
    _same(*runs)


@pytest.mark.parametrize("kind,k0", CASES)
@pytest.mark.parametrize("resources", [2, 4])
def test_simulated_schedule_matches_reference(kind, k0, resources):
    j_eval, t_eval = _scores(kind, k0)
    j = jcore.SimulatedScheduler(_space(jcore, kind), resources, order="pre").run(j_eval)
    t = tcore.SimulatedScheduler(_space(tcore, kind), resources, order="pre").run(t_eval)
    _same(j.to_result(), t.to_result())
    assert t.makespan == j.makespan


@pytest.mark.parametrize("kind,k0", CASES)
def test_threads_find_the_reference_optimum(kind, k0):
    j_eval, t_eval = _scores(kind, k0)
    j = jcore.binary_bleed_search(j_eval, (2, 30), 0.7, num_resources=4)
    t = tcore.binary_bleed_search(t_eval, (2, 30), 0.7, num_resources=4)
    assert t.k_optimal == j.k_optimal
    assert set(t.visited_ks) <= set(range(2, 31))


@pytest.mark.parametrize("n_real", [1, 3, 5, 8, 9])
@pytest.mark.parametrize("cap,compiled", [(None, ()), (4, ()), (None, (8,)), (16, (2, 16))])
def test_bucket_batch_policy_matches_reference(n_real, cap, compiled):
    from repro.factorization.batching import bucket_batch as j_bucket
    from repro_torch.factorization.batching import bucket_batch as t_bucket

    for lanes, bucket_min in ((1, 1), (4, 4)):
        args = dict(lanes=lanes, bucket_min=bucket_min, cap=cap, compiled=compiled)
        assert t_bucket(n_real, **args) == j_bucket(n_real, **args)


class _ReleasingCoordinator(tcore.InProcessCoordinator):
    """Sets ``released`` once a published bound prunes something."""

    def __init__(self, released):
        super().__init__()
        self.released = released

    def publish(self, bounds):
        merged = super().publish(bounds)
        if math.isfinite(bounds.lo_bound) or math.isfinite(bounds.hi_bound):
            self.released.set()
        return merged


@pytest.mark.parametrize(
    "pruner,kind,visited",
    [
        (7, "select", [5, 6, 7, 8, 9]),  # worker 2's first k selects: 2, 3, 4 are pruned
        (5, "select", [5, 6, 7, 8, 9]),  # worker 0's first k selects
        (6, "stop", [2, 3, 4, 5, 6, 7]),  # worker 1's first k stops: 8, 9 are pruned
    ],
)
def test_threads_prune_the_ks_handed_out_after_a_bound_lands(pruner, kind, visited):
    """The scorers fix the order of events: the first k of every worker
    (worklists [5, 2, 8], [6, 3, 9], [7, 4] over 2..9 on 3 workers) meets
    the others at a barrier, so all three are in flight; then every scorer
    but the pruning k's blocks until that k's bound is published. Every k
    handed out after the bound lands that the bound excludes is skipped."""
    import threading

    in_flight = threading.Barrier(3, timeout=30)
    released = threading.Event()
    waited = []

    def score(k: int) -> float:
        if k in (5, 6, 7):
            in_flight.wait()
        if k == pruner:
            return 1.0 if kind == "select" else 0.0
        waited.append(released.wait(timeout=30))
        return 0.5

    space = tcore.make_space((2, 9), 0.8, stop_threshold=0.25)
    assert tcore.plan_worklists(space.ks, 3, "pre", "T4") == [[5, 2, 8], [6, 3, 9], [7, 4]]
    res = tcore.ThreadPoolScheduler(space, 3, coordinator=_ReleasingCoordinator(released)).run(score)
    assert all(waited)  # no scorer timed out
    assert sorted(res.visited_ks) == visited
    assert res.k_optimal == (pruner if kind == "select" else None)
