"""The port's ``runtime/`` (fault tolerance, elastic joins, straggler
policy) and restartable search: ``tests/test_runtime.py`` on
``repro_torch.runtime``, ``repro_torch.core`` and ``repro_torch.obs``.
"""
import math

from repro_torch.core import FileCoordinator, ThreadPoolScheduler, make_space
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.runtime.straggler import SpeculationPolicy


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_heartbeat_detects_failure_and_redistributes():
    clock = FakeClock()
    mon = HeartbeatMonitor({0: [1, 5, 9], 1: [3, 7, 11]}, timeout=10, clock=clock)
    clock.t = 5.0
    mon.beat(1)
    clock.t = 12.0  # resource 0 silent past timeout
    dead = mon.check()
    assert dead == [0]
    assert mon.remaining() == {1, 3, 5, 7, 9, 11}
    assert mon.resources[1].worklist and not mon.resources[0].worklist


def test_in_flight_work_requeued_on_failure():
    clock = FakeClock()
    mon = HeartbeatMonitor({0: [1, 5], 1: [3, 7]}, timeout=10, clock=clock)
    mon.mark_in_flight(0, 9)
    mon.fail(0)
    assert 9 in mon.remaining()  # idempotent re-queue


def test_check_on_already_failed_rid_is_stable():
    """A rid that already failed must not be re-reported by check(), must
    ignore late beats, and must not trigger another redistribution."""
    clock = FakeClock()
    mon = HeartbeatMonitor({0: [1, 5], 1: [3, 7]}, timeout=10, clock=clock)
    mon.fail(0)
    worklists_after_fail = {r.rid: list(r.worklist) for r in mon.resources.values()}
    clock.t = 100.0  # both silent past timeout, but 0 is already dead
    mon.beat(1)
    mon.beat(0)  # late beat from a dead resource: ignored
    assert mon.resources[0].last_beat == 0.0
    dead = mon.check()
    assert dead == []  # 0 not re-reported, 1 beat in time
    assert {r.rid: list(r.worklist) for r in mon.resources.values()} == worklists_after_fail
    mon.fail(0)  # explicit double-fail is also a no-op
    assert {r.rid: list(r.worklist) for r in mon.resources.values()} == worklists_after_fail


def test_heartbeat_age_gauge_and_failure_events():
    from repro_torch.obs import Metrics, Tracer, use_metrics, use_tracer

    clock = FakeClock()
    tr, m = Tracer(), Metrics()
    with use_tracer(tr), use_metrics(m):
        mon = HeartbeatMonitor({0: [1, 5], 1: [3, 7]}, timeout=10, clock=clock)
        clock.t = 4.0
        mon.beat(1)
        clock.t = 6.0
        mon.check()
        assert m.gauge("heartbeat_age_max") == 6.0  # resource 0 never beat
        clock.t = 20.0
        mon.beat(1)  # keep 1 alive; only the silent resource 0 should die
        dead = mon.check()
    assert dead == [0]
    assert m.counter("failures") == 1
    fails = [e for e in tr.events() if e["name"] == "resource_failed"]
    assert len(fails) == 1 and fails[0]["args"]["rid"] == 0


def test_elastic_join_rebalances():
    clock = FakeClock()
    mon = HeartbeatMonitor({0: list(range(1, 13))}, timeout=10, clock=clock)
    rid = mon.join()
    assert rid == 1
    sizes = [len(r.worklist) for r in mon.resources.values() if r.alive]
    assert max(sizes) - min(sizes) <= 1


def test_speculation_policy():
    p = SpeculationPolicy(factor=1.5, min_samples=3)
    assert not p.should_speculate(5, elapsed=100.0)  # not enough samples
    for d in (1.0, 1.2, 0.9):
        p.observe_completion(1, d)
    assert p.should_speculate(5, elapsed=2.0)
    assert not p.should_speculate(5, elapsed=1.0)
    p.note_duplicate(5)
    assert not p.should_speculate(5, elapsed=9.0)  # max_duplicates reached


def test_speculation_median_edge_cases():
    # exactly min_samples completions flips the policy on
    p = SpeculationPolicy(factor=2.0, min_samples=2)
    p.observe_completion(1, 1.0)
    assert not p.should_speculate(9, elapsed=100.0)  # 1 < min_samples
    p.observe_completion(2, 3.0)
    # even count: statistics.median interpolates -> (1+3)/2 = 2
    assert not p.should_speculate(9, elapsed=4.0)  # 4 == factor*median: not >
    assert p.should_speculate(9, elapsed=4.0 + 1e-9)
    # a tail-heavy history moves the median, not the mean
    for d in (3.0, 3.0, 3.0):
        p.observe_completion(3, d)
    assert not p.should_speculate(9, elapsed=5.9)  # median now 3 -> cutoff 6
    assert p.should_speculate(9, elapsed=6.1)


def test_speculation_duplicate_accounting_per_k():
    p = SpeculationPolicy(factor=1.0, min_samples=1, max_duplicates=2)
    p.observe_completion(1, 1.0)
    p.note_duplicate(5)
    assert p.duplicates(5) == 1 and p.duplicates(7) == 0
    assert p.should_speculate(5, elapsed=9.0)  # 1 < max_duplicates=2
    p.note_duplicate(5)
    assert p.duplicates(5) == 2
    assert not p.should_speculate(5, elapsed=9.0)  # k=5 exhausted...
    assert p.should_speculate(7, elapsed=9.0)  # ...but k=7 unaffected


def test_speculation_emits_metrics_and_events():
    from repro_torch.obs import Metrics, Tracer, use_metrics, use_tracer

    p = SpeculationPolicy(min_samples=1)
    tr, m = Tracer(), Metrics()
    with use_tracer(tr), use_metrics(m):
        p.note_duplicate(11)
    assert m.counter("speculations") == 1
    (ev,) = [e for e in tr.events() if e["name"] == "speculate"]
    assert ev["args"] == {"k": 11, "duplicates": 1}


def test_search_restart_resumes_exactly(tmp_path):
    """Kill the search after partial progress; restart must not re-evaluate
    journaled k and must still land on the right answer."""
    space = make_space((2, 30), 0.7)
    ev_calls: list[int] = []

    def evaluate(k, should_abort=None):
        ev_calls.append(k)
        return 1.0 if k <= 24 else 0.0

    coord1 = FileCoordinator(str(tmp_path))
    # phase 1: visit a couple of k manually (simulated partial run, then crash)
    for k in (16, 24):
        s = evaluate(k)
        coord1.record_visit(k, s, 0)
    # phase 2: restart
    coord2 = FileCoordinator(str(tmp_path))
    bounds, visited = coord2.replay(space.selects, space.stops)
    assert visited == {16, 24}
    assert bounds.k_optimal == 24
    ev_calls.clear()
    sched = ThreadPoolScheduler(space, 2, coordinator=coord2)
    res = sched.run(evaluate, skip=visited)
    assert res.k_optimal == 24
    assert 16 not in ev_calls and 24 not in ev_calls  # no re-evaluation
    assert all(k > 24 for k in ev_calls)  # lower ks pruned by replayed bounds


def test_failure_mid_search_then_rebalance_finds_k(tmp_path):
    """Integration: monitor + scheduler semantics under failure."""
    clock = FakeClock()
    from repro_torch.core.chunking import plan_worklists

    wls = {i: wl for i, wl in enumerate(plan_worklists(range(2, 31), 3, "pre", "T4"))}
    mon = HeartbeatMonitor(wls, timeout=5, clock=clock)
    mon.fail(2)
    remaining = mon.remaining()
    space = make_space(sorted(remaining), 0.7)
    res = ThreadPoolScheduler(space, 2).run(lambda k: 1.0 if k <= 24 else 0.0)
    assert res.k_optimal == 24
