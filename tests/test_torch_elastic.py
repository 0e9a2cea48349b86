"""The port's elastic NMFk executor: convergence-gated chunked fits, lane
refill, cross-k warm starts, §III-D eviction, and ``nmf_chunked``.

The reference's sizes (``tests/test_elastic.py``): V 48 x 52 with k_true 4,
3 perturbations, 45 sweeps, k_pad 6, chunks of 15. Three groups:

1. the reference's elastic tests on the port: the tol=0 elastic plane is
   the port's batched plane draw for draw (1e-6), the tol ladder, the search
   accounting, cancel and evict, the refill policy, the warm cache;
2. the port's plane over the reference's draws (``reference_draw_source``)
   against the reference's ``NMFkElasticPlane``: at tol 0 each k's score
   within 2e-4 (``tests/test_torch_nmfk.py``'s ``SIL_ATOL``) with equal
   sweep counts and warm-start hits; at tol 1e-4 the same k_optimal and
   the accounting identity; the warm init within 1e-6;
3. ``nmf_chunked``: abort, tol, and equal to ``nmf`` when never aborted.
"""
import functools

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from _torch_reference import init_draws, reference_draw_source, uniform  # noqa: E402
from repro.factorization.nmfk import elastic_lane_init as j_lane_init  # noqa: E402
from repro.factorization.nmfk import elastic_lane_keys  # noqa: E402
from repro.factorization.nmfk import elastic_lane_warm_init as j_lane_warm_init  # noqa: E402
from repro.factorization.planes import NMFkElasticPlane as JElastic  # noqa: E402
from repro.factorization.synthetic import nmf_data as jnmf_data  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.factorization import nmf, nmf_chunked  # noqa: E402
from repro_torch.factorization.batching import WarmStartCache  # noqa: E402
from repro_torch.factorization.nmfk import elastic_lane_init, elastic_lane_warm_init  # noqa: E402
from repro_torch.factorization.planes import NMFkBatchPlane, NMFkElasticPlane  # noqa: E402
from repro_torch.factorization.synthetic import nmf_data  # noqa: E402
from repro_torch.obs import Tracer, use_tracer  # noqa: E402
from repro_torch.random import init_draws as port_init_draws  # noqa: E402
from repro_torch.random import lane_generator  # noqa: E402

KEY = jax.random.PRNGKey(0)
N, M, P, ITERS, K_PAD, CHUNK, EPS = 48, 52, 3, 45, 6, 15, 0.015
SIL_ATOL = 2e-4  # tests/test_torch_nmfk.py: the port against the reference's scores
FIT = dict(n_perturbs=P, nmf_iters=ITERS, k_pad=K_PAD, chunk=CHUNK)
KS = [3, 4, 5]


@functools.lru_cache(maxsize=1)
def _v_np() -> np.ndarray:
    v, _, _ = jnmf_data(jax.random.fold_in(KEY, 2), n=N, m=M, k_true=4)
    return np.array(v)


def _v() -> torch.Tensor:
    return to_tensor(_v_np(), "cpu")


def _drain(plane) -> dict[int, float]:
    """Submit nothing new; tick until idle, collecting {k: score}."""
    scores = {}
    while not plane.idle:
        for k, s in plane.tick():
            scores[k] = s
    return scores


@functools.lru_cache(maxsize=16)
def _elastic_curve(tol: float):
    """(scores over KS, total sweeps run) of the port's plane at ``tol``."""
    plane = NMFkElasticPlane(_v(), tol=tol, warm_start=False, **FIT)
    for k in KS:
        plane.submit(k)
    scores = _drain(plane)
    return tuple(scores[k] for k in KS), plane.sweeps_run


# ---------------------------------------------------------------------------
# warm-start cache
# ---------------------------------------------------------------------------
def test_warm_cache_prefers_near_same_perturbation_then_smaller_k():
    c = WarmStartCache(window=8)
    w = {k: torch.full((4, 8), float(k)) for k in (4, 5, 7, 8)}
    c.put(5, 0, w[5])
    c.put(7, 1, w[7])
    # distance tie (5 and 7 both at |k-6|=1): same perturbation wins
    k_src, w_src = c.nearest(6, 0)
    assert k_src == 5 and float(w_src[0, 0]) == 5.0
    # same distance + same perturbation on both sides: smaller k wins
    c2 = WarmStartCache(window=8)
    c2.put(4, 0, w[4])
    c2.put(8, 0, w[8])
    assert c2.nearest(6, 0)[0] == 4
    # closest k beats everything else
    assert c2.nearest(8, 1)[0] == 8


def test_warm_cache_window_and_fifo_eviction():
    c = WarmStartCache(window=2, max_ks=3)
    for k in (2, 3, 4):
        c.put(k, 0, torch.zeros((2, 4)))
    assert c.nearest(9, 0) is None  # all further than window
    assert c.misses == 1
    c.put(5, 0, torch.zeros((2, 4)))  # evicts k=2 (FIFO beyond max_ks)
    assert c.nearest(2, 0)[0] == 3
    assert c.hits == 1


# ---------------------------------------------------------------------------
# the port's elastic plane vs the port's fixed-iteration batched plane
# ---------------------------------------------------------------------------
def test_elastic_tol_zero_matches_batched_exactly():
    curve, sweeps = _elastic_curve(0.0)
    batched = NMFkBatchPlane(_v(), n_perturbs=P, nmf_iters=ITERS, k_pad=K_PAD)
    np.testing.assert_allclose(
        np.asarray(curve), np.asarray(batched.evaluate_batch(KS)), rtol=0, atol=1e-6,
        err_msg="tol=0 elastic fits must be draw-for-draw the batched fits",
    )
    assert sweeps == len(KS) * P * ITERS


TOL_LADDER = [3e-2, 3e-3, 1e-3, 1e-4, 1e-6, 0.0]


@settings(max_examples=15, deadline=None)
@given(i=st.integers(min_value=0, max_value=len(TOL_LADDER) - 2))
def test_tightening_tol_converges_to_fixed_iteration_oracle(i):
    """Along a descending tol ladder, scores approach the tol=0 oracle while
    the sweeps run grow: the gate can only fire earlier at a looser tol."""
    oracle = np.asarray(_elastic_curve(0.0)[0])
    loose, tight = TOL_LADDER[i], TOL_LADDER[i + 1]
    c_loose, sw_loose = _elastic_curve(loose)
    c_tight, sw_tight = _elastic_curve(tight)
    dev_loose = float(np.max(np.abs(np.asarray(c_loose) - oracle)))
    dev_tight = float(np.max(np.abs(np.asarray(c_tight) - oracle)))
    assert sw_tight >= sw_loose
    assert dev_tight <= dev_loose + 1e-7


def test_elastic_search_matches_batched_search_and_accounting():
    v = _v()
    mk = dict(n_perturbs=P, nmf_iters=ITERS, k_pad=K_PAD)
    plane = NMFkElasticPlane(v, tol=0.0, chunk=CHUNK, warm_start=False, **mk)
    res = tcore.ElasticWavefrontScheduler(tcore.make_space((2, 6), 0.8)).run(plane)
    batched = NMFkBatchPlane(v, **mk)
    ref = dict(zip(res.visited_ks, batched.evaluate_batch(res.visited_ks)))
    got = {rec.k: rec.score for rec in res.visits}
    assert res.k_optimal == 4
    for k in got:
        assert abs(got[k] - ref[k]) < 1e-6, f"k={k}: {got[k]} vs {ref[k]}"
    # the invariant holds over the whole search, evictions included
    assert plane.sweeps_run + plane.sweeps_saved == plane.sweeps_fixed_total
    assert len(res.visits) + (res.n_candidates - res.n_visited) == res.n_candidates
    assert plane.shapes_dispatched and all(kp == K_PAD for _, kp in plane.shapes_dispatched)


def test_elastic_api_executor_and_warm_start_agree_on_k_opt():
    plane = NMFkElasticPlane(_v(), tol=1e-4, warm_start=True, **FIT)
    tracer = Tracer()
    with use_tracer(tracer):
        res = tcore.binary_bleed_search(plane, (2, 6), 0.8, executor="elastic")
    assert res.k_optimal == 4
    assert plane.warm_cache.hits > 0  # refilled lanes actually warm-started
    assert plane.sweeps_run + plane.sweeps_saved == plane.sweeps_fixed_total
    names = [e["name"] for e in tracer.events()]
    assert names.count("chunk") == plane.n_ticks
    assert names.count("warm_start") == plane.warm_cache.hits


def test_elastic_cancel_evicts_inflight_and_credits_saved():
    plane = NMFkElasticPlane(_v(), tol=0.0, warm_start=False, **FIT)
    plane.submit(4)
    plane.submit(5)
    plane.tick()  # one chunk in flight for both ks
    assert plane.inflight_ks() == {4, 5}
    tracer = Tracer()
    with use_tracer(tracer):
        assert plane.cancel(5)
    (evict,) = [e for e in tracer.events() if e["name"] == "evict"]
    assert evict["args"] == {"k": 5, "pending": 0, "evicted": P}
    assert plane.inflight_ks() == {4}
    assert plane.sweeps_saved > 0  # 5's unspent sweeps were credited
    assert not plane.cancel(5)  # idempotent: already gone
    scores = _drain(plane)
    assert set(scores) == {4}
    assert plane.sweeps_run + plane.sweeps_saved == plane.sweeps_fixed_total


def test_retired_lane_w_survives_slot_reuse():
    """A retired lane's W goes to the warm cache and its k's ensemble; the
    slot it leaves is then overwritten by compaction and refill, which must
    not reach the cached W (a slot view would)."""
    plane = NMFkElasticPlane(_v(), tol=0.0, warm_start=True, slots=4, **{**FIT, "chunk": ITERS})
    for k in (3, 4):
        plane.submit(k)
    scores = _drain(plane)
    assert set(scores) == {3, 4}
    cached = plane.warm_cache._by_k
    assert set(cached) == {3, 4}
    # k 3's lanes retired first; k 4's fits then ran in the same slots
    w3, w4 = cached[3][0], cached[4][0]
    assert float(w3[:, 3:].abs().max()) == 0.0  # k 3's masked columns
    assert float(w4[:, 3].abs().max()) > 0.0
    assert not torch.equal(w3, w4)


def test_refill_policy_admits_up_to_backlog_cap():
    class FakePlane:
        slots = 4
        backlog = 0

    pol = tcore.LaneRefillPolicy(order="pre", max_backlog=2)
    p = FakePlane()
    assert pol.admit(p)
    p.backlog = 2
    assert not pol.admit(p)
    # default cap falls back to the plane's slot count
    assert tcore.LaneRefillPolicy().admit(p)
    # the candidate stream is exactly the pre-order traversal worklist
    assert sorted(pol.worklist([2, 3, 4, 5])) == [2, 3, 4, 5]
    assert pol.worklist([2, 3, 4, 5])[0] not in (2, 5)  # midpoint-first


def test_default_slots_and_argument_checks():
    assert NMFkElasticPlane(_v(), n_perturbs=3, k_pad=6).slots == 8  # next_pow2(2 * P)
    assert NMFkElasticPlane(_v(), n_perturbs=4, k_pad=6).slots == 8
    with pytest.raises(ValueError, match="k_pad"):
        NMFkElasticPlane(_v())
    plane = NMFkElasticPlane(_v(), **FIT)
    with pytest.raises(ValueError, match="exceeds"):
        plane.submit(K_PAD + 1)
    plane.submit(3)
    with pytest.raises(ValueError, match="already"):
        plane.submit(3)


# ---------------------------------------------------------------------------
# the port's plane over the reference's draws vs the reference's plane
# ---------------------------------------------------------------------------
def _search_pair(tol: float, warm_start: bool):
    """The same Binary Bleed search on both planes (k 2..6, threshold 0.8)."""
    mk = dict(n_perturbs=P, nmf_iters=ITERS, k_pad=K_PAD, tol=tol, chunk=CHUNK, warm_start=warm_start)
    jplane = JElastic(_v_np(), KEY, **mk)
    jres = jcore.ElasticWavefrontScheduler(jcore.make_space((2, 6), 0.8)).run(jplane)
    tplane = NMFkElasticPlane(_v(), draws=reference_draw_source(KEY, N, M, P, EPS), **mk)
    tres = tcore.ElasticWavefrontScheduler(tcore.make_space((2, 6), 0.8)).run(tplane)
    return jplane, jres, tplane, tres


@pytest.mark.parametrize("warm_start", [False, True])
def test_elastic_plane_matches_reference_at_tol_zero(warm_start):
    jplane, jres, tplane, tres = _search_pair(0.0, warm_start)
    want = {rec.k: rec.score for rec in jres.visits}
    got = {rec.k: rec.score for rec in tres.visits}
    assert set(got) == set(want)
    np.testing.assert_allclose([got[k] for k in sorted(got)], [want[k] for k in sorted(want)],
                               rtol=0, atol=SIL_ATOL)
    assert tres.k_optimal == jres.k_optimal == 4
    assert tplane.sweeps_run == jplane.sweeps_run
    assert tplane.sweeps_saved == jplane.sweeps_saved
    assert tplane.sweeps_fixed_total == jplane.sweeps_fixed_total
    assert tplane.warm_cache.hits == jplane.warm_cache.hits
    assert (tplane.warm_cache.hits > 0) == warm_start


def test_elastic_plane_matches_reference_k_optimal_at_tol():
    """At tol > 0 a lane whose improvement sits at the gate may retire a
    chunk earlier or later on either side: hold k_optimal, the identity
    and the warm-start hits."""
    jplane, jres, tplane, tres = _search_pair(1e-4, True)
    assert tres.k_optimal == jres.k_optimal == 4
    assert tplane.sweeps_run + tplane.sweeps_saved == tplane.sweeps_fixed_total
    assert tplane.warm_cache.hits == jplane.warm_cache.hits > 0


@pytest.mark.parametrize("k_eff,k_src", [(4, None), (4, 3), (4, 6), (5, 5)])
def test_lane_init_matches_reference(k_eff, k_src):
    """Cold init, and warm init from a source W with one zero column and k_src
    below, above and at k_eff, from the same (k, perturbation) draws."""
    v = _v_np()
    p = 1
    pkeys, fkeys = elastic_lane_keys(KEY, k_eff, P)
    noise = uniform(pkeys[p], (N, M), 1.0 - EPS, 1.0 + EPS)
    w_draw, h_draw = init_draws(fkeys[p], N, M, K_PAD)
    vp = torch.from_numpy(v * noise)
    if k_src is None:
        want = j_lane_init(v, k_eff, pkeys[p], fkeys[p], K_PAD, EPS)
        got = elastic_lane_init(vp, k_eff, torch.from_numpy(w_draw), torch.from_numpy(h_draw), K_PAD)
    else:
        w_src = np.random.default_rng(k_src).uniform(0.0, 2.0, (N, K_PAD)).astype(np.float32)
        w_src[:, k_src:] = 0.0
        w_src[:, 1] = 0.0  # a zeroed column falls back to the cold draw
        want = j_lane_warm_init(v, k_eff, pkeys[p], fkeys[p], w_src, k_src, K_PAD, EPS)
        got = elastic_lane_warm_init(vp, k_eff, torch.from_numpy(w_draw), torch.from_numpy(h_draw),
                                     torch.from_numpy(w_src), k_src, K_PAD)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# nmf_chunked: §III-D abort and the tol gate
# ---------------------------------------------------------------------------
def _chunked_problem(k: int = 3):
    v, _, _ = nmf_data(n=40, m=44, k_true=3, seed=0, device="cpu")
    w_draw, h_draw = port_init_draws(lane_generator(0, k, "cpu"), 40, 44, k)
    return v, w_draw, h_draw


def test_nmf_chunked_abort():
    v, w_draw, h_draw = _chunked_problem()
    calls = []

    def should_abort():
        calls.append(1)
        return len(calls) >= 3  # abort after 2 chunks

    res = nmf_chunked(v, 3, w_draw, h_draw, iters=200, chunk=20, should_abort=should_abort)
    assert res.iters == 40  # stopped early (§III-D)


def test_nmf_chunked_tol_stops_early():
    v, w_draw, h_draw = _chunked_problem()
    res = nmf_chunked(v, 3, w_draw, h_draw, iters=500, chunk=25, tol=1e-5)
    assert res.iters < 500


def test_nmf_chunked_without_abort_is_nmf():
    v, w_draw, h_draw = _chunked_problem()
    got = nmf_chunked(v, 3, w_draw, h_draw, iters=70, chunk=25, should_abort=lambda: False)
    want = nmf(v, 3, w_draw, h_draw, iters=70)
    assert got.iters == want.iters == 70
    assert torch.equal(got.w, want.w) and torch.equal(got.h, want.h)
    assert float(got.rel_error) == float(want.rel_error)
