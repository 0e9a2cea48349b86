"""Port K-Means vs ``repro.factorization.kmeans`` on the same inputs and draws.

The points come from the reference's ``blob_data``; the k-means++ draws
are the reference's own (``tests/_torch_reference.py`` runs its key
schedule here and hands the draws over through ``repro_torch.convert``).
Tolerances follow ``tests/test_evalplane.py``: labels and iteration
counts equal, centroids within rtol/atol 1e-5, inertia within rtol 1e-5,
padded centroid slots exactly 0.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_reference import kmeans_draws, reference_kmeans_draw_source  # noqa: E402
from repro.core import binary_bleed_search as j_binary_bleed_search  # noqa: E402
from repro.core.scoring import davies_bouldin_score as j_davies_bouldin_score  # noqa: E402
from repro.factorization.planes import KMeansBatchPlane as JKMeansBatchPlane  # noqa: E402
from repro.factorization.synthetic import blob_data as j_blob_data  # noqa: E402
from repro_torch.convert import kmeans_draws_from_reference, to_tensor  # noqa: E402
from repro_torch.core import binary_bleed_search, davies_bouldin_score  # noqa: E402
from repro_torch.factorization import KMeansBatchPlane, blob_data, kmeans, kmeans_batched  # noqa: E402
from repro_torch.factorization.kmeans import (  # noqa: E402
    _kmeans_masked_assign,
    _kmeans_masked_chunk,
    _kmeans_masked_init,
    _kmeanspp_init,
    kmeans_multi_restart,
)
from repro_torch.random import seeded_kmeans_draws  # noqa: E402

# both packages export the function ``kmeans`` under the module's name
jkmeans = importlib.import_module("repro.factorization.kmeans")

KEY = jax.random.PRNGKey(3)
CENTROID_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def blobs():
    """tests/test_evalplane.py::test_kmeans_batched_matches_per_k's data."""
    x, _ = j_blob_data(jax.random.fold_in(KEY, 1), n=120, d=5, k_true=4)
    return np.array(x)  # a writable copy: torch.from_numpy shares it


def _draws(key, n: int, k_draw: int):
    return kmeans_draws_from_reference(*kmeans_draws(key, n, k_draw), device="cpu")


def _assert_fit_matches(got, want, k: int | None = None):
    """Port fit vs reference fit; ``k`` given: padded slots >= k are 0."""
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.iters) == int(want.iters)
    c_got, c_want = got.centroids.numpy(), np.asarray(want.centroids)
    if k is not None:
        assert float(np.abs(c_got[k:]).max(initial=0.0)) == 0.0
        c_got, c_want = c_got[:k], c_want[:k]
    np.testing.assert_allclose(c_got, c_want, **CENTROID_TOL)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia), rtol=1e-5)


@pytest.mark.parametrize("k", [2, 4, 7])
def test_kmeanspp_init_matches_reference(blobs, k):
    key = jax.random.fold_in(KEY, k)
    got = _kmeanspp_init(torch.from_numpy(blobs), k, _draws(key, len(blobs), k))
    np.testing.assert_allclose(got.numpy(), np.asarray(jkmeans._kmeanspp_init(key, jnp.asarray(blobs), k)), **CENTROID_TOL)


@pytest.mark.parametrize("k", [2, 3, 4, 6, 7])
def test_kmeans_matches_reference(blobs, k):
    key = jax.random.fold_in(KEY, k)
    got = kmeans(torch.from_numpy(blobs), k, _draws(key, len(blobs), k), max_iters=50)
    _assert_fit_matches(got, jkmeans.kmeans(blobs, k, key, max_iters=50))


def test_kmeans_batched_lanes_match_per_k_and_reference(blobs):
    """Lane i of the padded batched fit is the per-k fit (the reference's
    ``test_kmeans_batched_matches_per_k``), and the reference's lane i."""
    ks, k_pad = [2, 3, 4, 6, 7], 8
    x = torch.from_numpy(blobs)
    source = reference_kmeans_draw_source(KEY, len(blobs))
    batch = kmeans_batched(x, ks, k_pad=k_pad, max_iters=50, draws=source)
    ref_batch = jkmeans.kmeans_batched(blobs, ks, KEY, k_pad=k_pad, max_iters=50)
    assert batch.centroids.shape == (len(ks), k_pad, blobs.shape[1])
    for i, k in enumerate(ks):
        lane = type(batch)(*(field[i] for field in batch))
        per_k = kmeans(x, k, source(k, k), max_iters=50)
        np.testing.assert_array_equal(lane.labels.numpy(), per_k.labels.numpy())
        np.testing.assert_allclose(lane.centroids[:k].numpy(), per_k.centroids.numpy(), **CENTROID_TOL)
        np.testing.assert_allclose(float(lane.inertia), float(per_k.inertia), rtol=1e-5)
        _assert_fit_matches(lane, type(ref_batch)(*(field[i] for field in ref_batch)), k)


def test_seeded_lanes_match_seeded_per_k_fits(blobs):
    """The port's own draws keep the lane contract at every k < k_pad: the
    uniforms are drawn at one fixed length, so a lane's are the per-k ones."""
    x = torch.from_numpy(blobs)
    source = seeded_kmeans_draws(7, len(blobs), "cpu")
    short, long = source(5, 5), source(5, 12)
    assert int(short.first) == int(long.first)
    assert torch.equal(long.u[:4], short.u)
    batch = kmeans_batched(x, [3, 5], seed=7, k_pad=12, max_iters=50)
    for i, k in enumerate([3, 5]):
        per_k = kmeans(x, k, seed=7, max_iters=50)
        assert torch.equal(batch.labels[i], per_k.labels)
        assert float(batch.centroids[i, k:].abs().max()) == 0.0


def test_kmeans_multi_restart_matches_reference(blobs):
    k, restarts = 6, 3
    keys = jax.random.split(KEY, restarts)
    draws = [_draws(kk, len(blobs), k) for kk in keys]
    got = kmeans_multi_restart(torch.from_numpy(blobs), k, restarts=restarts, max_iters=50, draws=draws)
    _assert_fit_matches(got, jkmeans.kmeans_multi_restart(blobs, k, KEY, restarts=restarts, max_iters=50))


@pytest.mark.parametrize("k", [3, 6])
def test_chunked_masked_fit_matches_reference(blobs, k):
    """The resumable init / chunk / assign path, chunk by chunk."""
    k_pad, chunk = 8, 2
    key = jax.random.fold_in(KEY, k)
    x, k_eff = torch.from_numpy(blobs), torch.tensor(k)
    centers = _kmeans_masked_init(x, k_eff, _draws(key, len(blobs), k_pad), k_pad)
    j_centers = jkmeans._kmeans_masked_init(blobs, jnp.asarray(k), key, k_pad)
    np.testing.assert_allclose(centers.numpy(), np.asarray(j_centers), **CENTROID_TOL)
    for _ in range(25):
        centers, delta, did = _kmeans_masked_chunk(x, centers, k_eff, k_pad, chunk)
        j_centers, j_delta, j_did = jkmeans._kmeans_masked_chunk(blobs, j_centers, jnp.asarray(k), k_pad, chunk)
        assert int(did) == int(j_did)
        np.testing.assert_allclose(centers.numpy(), np.asarray(j_centers), **CENTROID_TOL)
        np.testing.assert_allclose(float(delta), float(j_delta), **CENTROID_TOL)
        assert float(centers[k:].abs().max()) == 0.0
        if float(delta) <= 1e-6:
            break
    else:
        pytest.fail("the chunked fit did not converge")
    labels, inertia = _kmeans_masked_assign(x, centers, k_eff, k_pad)
    j_labels, j_inertia = jkmeans._kmeans_masked_assign(blobs, j_centers, jnp.asarray(k), k_pad)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
    np.testing.assert_allclose(float(inertia), float(j_inertia), rtol=1e-5)


@pytest.mark.parametrize("score", ["davies_bouldin", "silhouette"])
def test_kmeans_plane_matches_reference(blobs, score):
    ks = [2, 4, 5]
    plane = KMeansBatchPlane(
        torch.from_numpy(blobs), score=score, max_iters=25, k_pad=8,
        draws=reference_kmeans_draw_source(KEY, len(blobs)),
    )
    got = plane.evaluate_batch(ks)
    want = JKMeansBatchPlane(blobs, KEY, score=score, max_iters=25, k_pad=8).evaluate_batch(ks)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert plane.shapes_dispatched == {(4, 8)}


def test_kmeans_plane_chunked_abort():
    """tests/test_elastic.py::test_kmeans_chunked_scalar_abort on the port."""
    x, _ = j_blob_data(jax.random.fold_in(KEY, 3), n=120, d=4, k_true=4)
    plane = KMeansBatchPlane(
        to_tensor(x, "cpu"), score="silhouette", max_iters=25, k_pad=8,
        draws=reference_kmeans_draw_source(KEY, 120),
    )
    got = plane.evaluate_one(4, should_abort=lambda: False)
    want = plane.evaluate_batch([4])[0]
    assert abs(got - want) < 1e-5
    assert plane.last_scalar_sweeps > 0
    assert np.isnan(plane.evaluate_one(4, should_abort=lambda: True))
    assert plane.last_scalar_sweeps == 0


# Davies-Bouldin's centroid separation sqrt(|c_i|^2 + |c_j|^2 - 2 c_i.c_j) is
# a cancellation when a k above k_true splits one blob (|c|^2 ~ 500, the
# halves' squared gap ~ 0.3): any fp32 evaluation order is ~1e-4 from the
# float64 score of the same labels there, and PyTorch's and XLA's CPU
# products round it differently. Search-level scores are held at that
# floor, each against float64 as well; the fits must agree label for label.
SEARCH_DB_RTOL = 5e-4


def test_binary_bleed_kmeans_davies_bouldin_matches_reference():
    """tests/test_integration.py's K-Means + DB search: the same k_optimal,
    visited set, labels and scores as the reference, on the reference's data
    and draws. The serial executor makes the visit order deterministic."""
    x, _ = j_blob_data(KEY, n=240, d=5, k_true=5, std=0.3, spread=10.0)
    xt = to_tensor(x, "cpu")
    source = reference_kmeans_draw_source(KEY, 240)
    labels, j_labels = {}, {}

    def ev(k, should_abort=None):
        labels[int(k)] = kmeans(xt, int(k), source(int(k), int(k))).labels
        return float(davies_bouldin_score(xt, labels[int(k)], int(k)))

    def j_ev(k, should_abort=None):
        j_labels[int(k)] = jkmeans.kmeans(x, int(k), jax.random.fold_in(KEY, k)).labels
        return float(j_davies_bouldin_score(x, j_labels[int(k)], int(k)))

    kw = dict(select_threshold=0.5, stop_threshold=1.6, mode="minimize", num_resources=1)
    got = binary_bleed_search(ev, (2, 12), **kw)
    want = j_binary_bleed_search(j_ev, (2, 12), **kw)
    assert got.k_optimal == want.k_optimal == 5
    assert got.visited_ks == want.visited_ks
    scores = {v.k: v.score for v in got.visits}
    for v in want.visits:
        np.testing.assert_array_equal(labels[v.k].numpy(), np.asarray(j_labels[v.k]))
        np.testing.assert_allclose(scores[v.k], v.score, rtol=SEARCH_DB_RTOL, atol=1e-5)
        exact = float(davies_bouldin_score(xt.double(), labels[v.k], v.k))
        np.testing.assert_allclose([scores[v.k], v.score], exact, rtol=SEARCH_DB_RTOL, atol=1e-5)
    threaded = binary_bleed_search(ev, (2, 12), **{**kw, "num_resources": 2})
    assert threaded.k_optimal == 5


def test_blob_data_plants_k_true_blobs():
    x, labels = blob_data(n=600, d=6, k_true=5, std=0.5, spread=8.0, seed=4, device="cpu")
    assert x.shape == (600, 6) and x.dtype == torch.float32 and labels.shape == (600,)
    assert set(labels.tolist()) == set(range(5))
    # within a blob, points scatter with std sqrt(0.5^2 + 0.05^2) per coordinate
    spread_within = torch.stack([x[labels == c].std(dim=0) for c in range(5)])
    assert float((spread_within - (0.5 ** 2 + 0.05 ** 2) ** 0.5).abs().max()) < 0.15
    again, _ = blob_data(n=600, d=6, k_true=5, std=0.5, spread=8.0, seed=4, device="cpu")
    assert torch.equal(x, again)
    fit = kmeans(x, 5, seed=0)
    # clean blobs: every fitted cluster is one planted blob
    for c in range(5):
        assert len(set(labels[fit.labels == c].tolist())) == 1


# -----------------------------------------------------------------------------
# k above 128: the port once drew its k-means++ uniforms at one fixed length
# of 127 and refused more; it now draws them in blocks of that length.
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("k", [129, 200])
def test_kmeans_above_128_clusters_matches_reference(k):
    """``kmeans`` at k past one block of draws: the reference's centroids and
    labels from the reference's own draws."""
    x, _ = j_blob_data(jax.random.fold_in(KEY, 5), n=400, d=3, k_true=6)
    x = np.array(x)
    key = jax.random.fold_in(KEY, k)
    got = kmeans(torch.from_numpy(x), k, _draws(key, len(x), k), max_iters=20)
    assert got.centroids.shape == (k, 3)
    _assert_fit_matches(got, jkmeans.kmeans(x, k, key, max_iters=20))


@pytest.mark.parametrize("k_draw", [1, 2, 7, 127, 128])
def test_kmeans_draws_up_to_128_are_one_block(k_draw):
    """Up to k_draw = 128 the draws are what they always were: the first
    index, then one ``rand(127)`` cut to k_draw - 1, bit for bit."""
    from repro_torch.random import kmeans_draws, seeded_generator

    gen = seeded_generator(11, "cpu")
    first = torch.randint(0, 500, (), generator=gen)
    u = torch.rand((127,), generator=gen)
    got = kmeans_draws(seeded_generator(11, "cpu"), 500, k_draw)
    assert torch.equal(got.first, first)
    assert torch.equal(got.u, u[: k_draw - 1])


@pytest.mark.parametrize("k_pad", [129, 200, 300])
def test_kmeans_draws_at_k_pad_start_with_the_draws_at_k(k_pad):
    """A padded lane's draws start with those of its per-k fit for every
    k < k_pad, across block boundaries."""
    from repro_torch.random import kmeans_draws, seeded_generator

    padded = kmeans_draws(seeded_generator(5, "cpu"), 1000, k_pad)
    assert padded.u.shape == (k_pad - 1,)
    for k in [k for k in (1, 2, 64, 127, 128, 129, 200, 254, 255, 256, k_pad - 1) if k < k_pad]:
        per_k = kmeans_draws(seeded_generator(5, "cpu"), 1000, k)
        assert torch.equal(per_k.first, padded.first)
        assert torch.equal(per_k.u, padded.u[: k - 1])
