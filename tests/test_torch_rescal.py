"""The port's RESCAL / RESCALk (``repro_torch.factorization.rescal``) against
the reference (``repro.factorization.rescal``) on the CPU.

The same X (the reference's ``rescal_data``) and the reference's own draws
(``tests/_torch_reference.py``: the noise, A and R draws of its key
schedule) go through both; each case states its tolerance. Then the
reference's RESCAL tests, ported to the port's own data and draws, and
Binary Bleed over ``make_rescalk_evaluator``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_reference import reference_rescal_draw_source, rescal_init_draws  # noqa: E402
from repro.factorization.synthetic import rescal_data as jrescal_data  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.core import binary_bleed_search  # noqa: E402
from repro_torch.factorization.nmfk import _align_columns  # noqa: E402
from repro_torch.factorization.synthetic import rescal_data  # noqa: E402
from repro_torch.random import seeded_rescal_draws  # noqa: E402

# the package exports functions named like the modules: import the modules
jr = importlib.import_module("repro.factorization.rescal")
jnmfk = importlib.import_module("repro.factorization.nmfk")
tr = importlib.import_module("repro_torch.factorization.rescal")

KEY = jax.random.PRNGKey(0)
# One sweep: the port's matmul chains against the reference's einsums,
# float32 reassociation only (measured 2.8e-7 relative).
STEP_TOL = dict(rtol=1e-5, atol=1e-7)
# 120 sweeps from the same draws: reassociation drifts to 3.3e-6 relative in
# the factors (measured); held at 5e-5. The relative error is a norm ratio
# (measured 2.1e-6 relative); held at 2e-5.
FIT_TOL = dict(rtol=5e-5, atol=1e-6)
ERR_RTOL = 2e-5
# The silhouette of the pooled, aligned A columns after 100 sweeps of p fits:
# measured within 4.4e-5 of the reference at k 2..7 (the columns' fp32
# distances, sqrt of a cancellation); held at 2e-4, as NMFk's scores are.
SIL_ATOL = 2e-4


@pytest.fixture(scope="module")
def x48():
    x, _, _ = jrescal_data(KEY, n_entities=48, n_relations=3, k_true=4)
    return np.array(x)


def test_rescal_data_has_the_reference_structure():
    """The reference generator's structure on the port's draws: one-hot
    blocks plus a U[0, 0.05) background in A, R ~ U[0, 1) scaled by
    0.2 + 0.8 I, X = A R_r A^T plus U[0, noise)."""
    x, a, r = rescal_data(n_entities=40, n_relations=3, k_true=4, noise=0.01, seed=1, device="cpu")
    assert x.shape == (3, 40, 40) and a.shape == (40, 4) and r.shape == (3, 4, 4)
    owned = torch.nn.functional.one_hot(torch.arange(40) // 10, 4).bool()
    assert float(a[owned].min()) >= 1.0 and float(a[owned].max()) < 1.05
    assert float(a[~owned].min()) >= 0.0 and float(a[~owned].max()) < 0.05
    off = ~torch.eye(4, dtype=torch.bool)
    assert float(r.min()) >= 0.0 and float(r[:, off].max()) < 0.2
    resid = x - a @ r @ a.T
    assert 0.0 <= float(resid.min()) and float(resid.max()) < 0.01


def test_rescal_step_matches_reference(x48):
    rng = np.random.default_rng(0)
    a = rng.uniform(0.1, 1.0, (48, 4)).astype(np.float32)
    r = rng.uniform(0.1, 1.0, (3, 4, 4)).astype(np.float32)
    want_a, want_r = jr.rescal_step(jnp.asarray(x48), jnp.asarray(a), jnp.asarray(r))
    got_a, got_r = tr.rescal_step(to_tensor(x48, "cpu"), torch.from_numpy(a), torch.from_numpy(r))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **STEP_TOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), **STEP_TOL)


def test_rescal_matches_reference_over_120_sweeps(x48):
    fkey = jax.random.PRNGKey(5)
    a_draw, r_draw = rescal_init_draws(fkey, 48, 3, 4)
    want = jr.rescal(jnp.asarray(x48), 4, fkey, iters=120)
    got = tr.rescal(to_tensor(x48, "cpu"), 4, torch.from_numpy(a_draw), torch.from_numpy(r_draw), iters=120)
    np.testing.assert_allclose(got.a.numpy(), np.asarray(want.a), **FIT_TOL)
    np.testing.assert_allclose(got.r.numpy(), np.asarray(want.r), **FIT_TOL)
    np.testing.assert_allclose(float(got.rel_error), float(want.rel_error), rtol=ERR_RTOL)


@pytest.mark.parametrize("k", [3, 4, 6])  # below, at and above k_true
def test_rescalk_score_matches_reference(x48, k):
    sub = jax.random.fold_in(KEY, k)
    want_sil, want_err = jr.rescalk_score(jnp.asarray(x48), k, sub, n_perturbs=4, iters=100)
    draws = reference_rescal_draw_source(KEY, 48, 3, 4)(k)
    got_sil, got_err = tr.rescalk_score(to_tensor(x48, "cpu"), k, draws, iters=100)
    assert abs(float(got_sil) - float(want_sil)) <= SIL_ATOL
    np.testing.assert_allclose(float(got_err), float(want_err), rtol=ERR_RTOL)


def _match_one_reference(a_all):
    """``rescal.py:98-110``'s ``match_one`` (a closure of ``rescalk_score``),
    transcribed line for line: greedy argmax against perturbation 0."""
    k = a_all.shape[-1]
    ref = a_all[0]

    def match_one(a_p):
        sim = ref.T @ a_p

        def body(_, carry):
            assign, sim_m = carry
            flat = jnp.argmax(sim_m)
            i, j = flat // k, flat % k
            assign = assign.at[j].set(i)
            sim_m = sim_m.at[i, :].set(-jnp.inf).at[:, j].set(-jnp.inf)
            return assign, sim_m

        assign, _ = jax.lax.fori_loop(0, k, body, (jnp.zeros((k,), jnp.int32), sim))
        return assign

    return jax.vmap(match_one)(a_all).reshape(-1)


@pytest.mark.parametrize("p,n,k,seed", [(3, 40, 4, 0), (4, 30, 7, 1), (2, 16, 1, 2), (5, 20, 9, 3)])
def test_alignment_is_the_reference_match_one(p, n, k, seed):
    """RESCALk's alignment is NMFk's greedy matching: the port's
    ``_align_columns`` gives ``match_one``'s labels and the reference NMFk
    ``_align_columns``'s, on near-duplicate and on random columns, with
    exact ties (a repeated column)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, (1, n, k))
    for spread in (0.05, 1.0):
        a_all = (base + spread * rng.uniform(0.0, 1.0, (p, n, k))).astype(np.float32)
        a_all[:, :, -1] = a_all[:, :, 0]  # a tie in every similarity matrix
        a_all /= np.linalg.norm(a_all, axis=1, keepdims=True)
        want = np.asarray(_match_one_reference(jnp.asarray(a_all)))
        np.testing.assert_array_equal(np.asarray(jnmfk._align_columns(jnp.asarray(a_all))), want)
        np.testing.assert_array_equal(_align_columns(torch.from_numpy(a_all)).numpy(), want)


def test_rescal_convergence():
    """Port of ``test_rescal_convergence`` on the port's data and draws."""
    x, _, _ = rescal_data(n_entities=40, n_relations=3, k_true=3, seed=0, device="cpu")
    d = seeded_rescal_draws(0, 40, 3, 1, 0.015, "cpu")(3)
    res = tr.rescal(x, 3, d.a[0], d.r[0], iters=120)
    assert float(res.rel_error) < 0.08


def test_rescalk_scores_stable_at_k_true():
    """Port of ``test_rescalk_scores_stable_at_k_true`` on the port's data and draws."""
    x, _, _ = rescal_data(n_entities=48, n_relations=3, k_true=4, seed=0, device="cpu")
    source = seeded_rescal_draws(0, 48, 3, 4, 0.015, "cpu")
    s_true, _ = tr.rescalk_score(x, 4, source(4), iters=100)
    s_over, _ = tr.rescalk_score(x, 7, source(7), iters=100)
    assert float(s_true) > float(s_over)


@pytest.mark.parametrize("resources", [1, 3])  # serial worklist, threads
def test_binary_bleed_over_rescalk_finds_k_true(resources):
    """``benchmarks/bench_distributed.py``'s RESCAL setup (4 relations,
    k_true 4, noise 0.003, select 0.8, stop 0.25) at 48 entities. The serial
    search's visits are deterministic, so it is held to pruning; the
    threads' depend on when a select lands against the ks still to hand
    out, so they are held to k_optimal only (the threads executor's pruning
    is held by ``tests/test_torch_search.py``'s blocking-scorer test)."""
    x, _, _ = rescal_data(n_entities=48, n_relations=4, k_true=4, noise=0.003, seed=0, device="cpu")
    evaluate = tr.make_rescalk_evaluator(x, seed=0, n_perturbs=3, iters=100)
    res = binary_bleed_search(evaluate, (2, 9), 0.8, 0.25, num_resources=resources)
    assert res.k_optimal == 4
    if resources == 1:
        assert res.n_visited < res.n_candidates
