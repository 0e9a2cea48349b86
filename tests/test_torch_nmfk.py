"""Port NMFk scores vs ``repro.factorization.nmfk`` with the reference's draws.

n=96, m=104, 4 perturbations, 120 sweeps, k=2..8. Each port path is held
against the reference path of the same name: atol 2e-4 on both
silhouettes, rtol 1e-5 on ``rel_error``. (The reference's own scalar vs
batched gap is 1.76e-4, so cross-path checks would need more room.)
"""
import importlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_reference import ensemble_draws, reference_draw_source  # noqa: E402
from repro.factorization.synthetic import nmf_data as jnmf_data  # noqa: E402
from repro_torch.convert import draws_from_reference, to_tensor  # noqa: E402

jnmfk = importlib.import_module("repro.factorization.nmfk")
tnmfk = importlib.import_module("repro_torch.factorization.nmfk")

KEY = jax.random.PRNGKey(0)
N, M, P, ITERS, EPS = 96, 104, 4, 120, 0.015
SIL_ATOL = 2e-4
ERR_RTOL = 1e-5
KS = list(range(2, 9))


@pytest.fixture(scope="module")
def v_np():
    v, _, _ = jnmf_data(KEY, n=N, m=M, k_true=5)
    return np.array(v)


def _assert_scores(got, want):
    np.testing.assert_allclose(got.min_silhouette.numpy(), np.asarray(want.min_silhouette), rtol=0, atol=SIL_ATOL)
    np.testing.assert_allclose(got.mean_silhouette.numpy(), np.asarray(want.mean_silhouette), rtol=0, atol=SIL_ATOL)
    np.testing.assert_allclose(got.rel_error.numpy(), np.asarray(want.rel_error), rtol=ERR_RTOL)


@pytest.mark.parametrize("k", KS)
def test_nmfk_score_matches_reference(v_np, k):
    key = jax.random.fold_in(KEY, k)
    want = jnmfk.nmfk_score(v_np, k, key, n_perturbs=P, nmf_iters=ITERS, epsilon=EPS)
    draws = draws_from_reference(*ensemble_draws(key, N, M, k, P, EPS), device="cpu")
    got = tnmfk.nmfk_score(to_tensor(v_np, "cpu"), k, draws, nmf_iters=ITERS)
    _assert_scores(got, want)


def test_nmfk_score_batched_matches_reference(v_np):
    want = jnmfk.nmfk_score_batched(v_np, KS, KEY, k_pad=8, n_perturbs=P, nmf_iters=ITERS, epsilon=EPS)
    got = tnmfk.nmfk_score_batched(
        to_tensor(v_np, "cpu"), KS, k_pad=8, n_perturbs=P, nmf_iters=ITERS, epsilon=EPS,
        draws=reference_draw_source(KEY, N, M, P, EPS),
    )
    _assert_scores(got, want)


def test_evaluator_is_nmfk_score_under_the_draw_schedule(v_np):
    v = to_tensor(v_np, "cpu")
    source = reference_draw_source(KEY, N, M, P, EPS)
    evaluate = tnmfk.make_nmfk_evaluator(v, n_perturbs=P, nmf_iters=30, draws=source)
    sc = tnmfk.nmfk_score(v, 4, source(4, 4), nmf_iters=30)
    assert evaluate(4) == float(sc.min_silhouette)


def _unit_columns(rng, shape):
    w = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    return w / np.linalg.norm(w, axis=-2, keepdims=True)


@pytest.mark.parametrize("p,n,k", [(4, 30, 5), (3, 12, 8), (2, 20, 1)])
def test_align_columns_matches_reference(p, n, k):
    w_all = _unit_columns(np.random.default_rng(p * n + k), (p, n, k))
    got = tnmfk._align_columns(torch.from_numpy(w_all)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnmfk._align_columns(w_all)))


def test_align_columns_masked_matches_reference_per_lane():
    rng = np.random.default_rng(1)
    w_all = _unit_columns(rng, (3, 4, 25, 6))
    k_eff = np.array([6, 3, 1])
    w_all[1, :, :, 3:] = 0.0  # masked fits carry zero columns past k_eff
    w_all[2, :, :, 1:] = 0.0
    got = tnmfk._align_columns_masked(torch.from_numpy(w_all), torch.from_numpy(k_eff)).numpy()
    for lane in range(3):
        want = np.asarray(jnmfk._align_columns_masked(w_all[lane], k_eff[lane]))
        np.testing.assert_array_equal(got[lane], want)


def test_greedy_ties_go_to_the_first_index():
    sim = torch.ones((1, 3, 3))
    got = tnmfk._greedy_assign(sim, torch.tensor([3]), torch.zeros((1, 3), dtype=torch.long))
    assert got.tolist() == [[0, 1, 2]]


def test_nmfk_score_batched_at_k_pad_above_128_matches_reference():
    """A wave padded past 128 ranks (k_pad 129), small V, few sweeps: the
    port took no rank above 128 once."""
    n, m, p, iters = 40, 44, 2, 20
    key = jax.random.fold_in(KEY, 129)
    v, _, _ = jnmf_data(key, n=n, m=m, k_true=4)
    v = np.array(v)
    ks = [3, 129]
    want = jnmfk.nmfk_score_batched(v, ks, key, k_pad=129, n_perturbs=p, nmf_iters=iters, epsilon=EPS)
    got = tnmfk.nmfk_score_batched(
        to_tensor(v, "cpu"), ks, k_pad=129, n_perturbs=p, nmf_iters=iters, epsilon=EPS,
        draws=reference_draw_source(key, n, m, p, EPS),
    )
    _assert_scores(got, want)
