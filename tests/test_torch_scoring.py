"""Port scoring vs ``repro.core.scoring`` on the same inputs.

Covers the silhouette (singleton and empty clusters, ``point_mask``, a
leading batch axis, an unbatched x under batched labels), the pairwise
dispatch with mixed 2-D/3-D operands, Davies-Bouldin and its masked form,
the row-blocked distance-sum tier, and the §III-D synthetic score models.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import scoring as jscoring  # noqa: E402
from repro_torch.core import scoring  # noqa: E402

# Per-point values and distance sums: the reference's fp32 distance
# tolerance (tests/test_kernels.py). Each point's self-distance is
# sqrt(|x|^2 + |x|^2 - 2 x.x), the square root of fp32 rounding noise, and
# that noise differs between PyTorch's and XLA's CPU products by up to
# ~1e-3 after sqrt. Mean scores are held at 1e-4.
TOL = dict(rtol=1e-4, atol=1e-3)


def _problem(seed: int, shape: tuple, k: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    labels = rng.integers(0, k, size=shape[:-1]).astype(np.int32)
    return x, labels


@pytest.mark.parametrize("n,d,k", [(30, 4, 3), (60, 6, 5), (70, 17, 4)])
def test_silhouette_score_matches_reference(n, d, k):
    x, labels = _problem(n * d, (n, d), k)
    got = float(scoring.silhouette_score(torch.from_numpy(x), torch.from_numpy(labels), k))
    want = float(jscoring.silhouette_score(x, labels, k))
    assert abs(got - want) <= 1e-4 * max(1.0, abs(want))


def test_singleton_and_empty_clusters_match_reference():
    """Cluster k-1 empty, cluster 0 a singleton: s=0 for the singleton,
    the empty cluster never enters b(i)."""
    n, d, k = 40, 5, 5
    x, _ = _problem(7, (n, d), k)
    labels = np.concatenate([[0], 1 + (np.arange(n - 1) % (k - 2))]).astype(np.int32)
    got = scoring.silhouette_samples_masked(torch.from_numpy(x), torch.from_numpy(labels), k)
    want = np.asarray(jscoring.silhouette_samples_masked(x, labels, k))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(got[0]) == 0.0


@pytest.mark.parametrize("b,n,d,k", [(3, 24, 5, 4), (2, 40, 9, 6)])
def test_masked_samples_batched_match_reference(b, n, d, k):
    """Batched x (b, n, d) with per-lane point masks: padded points are 0."""
    x, labels = _problem(b * n + k, (b, n, d), k)
    mask = np.arange(n)[None, :] < np.array([n, n - 5, n - 9][:b])[:, None]
    got = scoring.silhouette_samples_masked(
        torch.from_numpy(x), torch.from_numpy(labels), k, point_mask=torch.from_numpy(mask)
    )
    want = np.asarray(jscoring.silhouette_samples_masked(x, labels, k, point_mask=mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.all(got.numpy()[~mask] == 0.0)


def test_masked_score_shared_x_matches_reference():
    """x (n, d) shared by every lane, labels (b, n), point_mask (b, n)."""
    b, n, d, k = 3, 36, 4, 4
    x, _ = _problem(11, (n, d), k)
    _, labels = _problem(13, (b, n, d), k)
    mask = np.arange(n)[None, :] < np.array([n, n - 6, n - 11])[:, None]
    got = scoring.silhouette_score_masked(
        torch.from_numpy(x), torch.from_numpy(labels), k, point_mask=torch.from_numpy(mask)
    )
    want = np.asarray(jscoring.silhouette_score_masked(x, labels, k, point_mask=mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    unmasked = scoring.silhouette_score_masked(torch.from_numpy(x), torch.from_numpy(labels), k)
    np.testing.assert_allclose(unmasked.numpy(), np.asarray(jscoring.silhouette_score_masked(x, labels, k)), **TOL)


def test_cluster_dist_sums_and_pairwise_match_reference():
    x, labels = _problem(5, (3, 20, 6), 4)
    onehot = np.eye(4, dtype=np.float32)[labels]
    got = scoring.cluster_dist_sums(torch.from_numpy(x), torch.from_numpy(onehot))
    np.testing.assert_allclose(got.numpy(), np.asarray(jscoring.cluster_dist_sums(x, onehot)), **TOL)
    d2 = scoring.pairwise_sq_dists(torch.from_numpy(x[0]))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jscoring.pairwise_sq_dists(x[0])), rtol=1e-4, atol=1e-3)


PAIRWISE_TOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_kernels.py::test_pairwise fp32 tolerance


@pytest.mark.parametrize(
    "x_shape,y_shape", [((40, 7), (24, 7)), ((3, 40, 7), (3, 24, 7)), ((40, 7), (3, 24, 7)), ((3, 40, 7), (24, 7))]
)
def test_pairwise_dispatch_matches_reference(x_shape, y_shape):
    """The scoring layer's dispatch, mixed 2-D/3-D operands included, against
    the reference's jnp broadcast and its kernel dispatch (interpret mode)."""
    rng = np.random.default_rng(len(x_shape) * 10 + len(y_shape))
    x = rng.normal(size=x_shape).astype(np.float32)
    y = rng.normal(size=y_shape).astype(np.float32)
    got = scoring.pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jscoring.pairwise_sq_dists(x, y)), **PAIRWISE_TOL)
    np.testing.assert_allclose(got, np.asarray(jscoring.pairwise_sq_dists(x, y, use_kernel=True)), **PAIRWISE_TOL)


DB_TOL = 1e-5  # the reference's own masked-vs-unmasked DB tolerance (tests/test_evalplane.py)


@pytest.mark.parametrize("n,d,k", [(60, 4, 3), (120, 6, 5), (90, 3, 7)])
def test_davies_bouldin_matches_reference(n, d, k):
    x, labels = _problem(n + d + k, (n, d), k)
    got = float(scoring.davies_bouldin_score(torch.from_numpy(x), torch.from_numpy(labels), k))
    assert abs(got - float(jscoring.davies_bouldin_score(x, labels, k))) <= DB_TOL
    # an empty cluster contributes nothing
    labels_empty = np.where(labels == k - 1, 0, labels).astype(np.int32)
    got = float(scoring.davies_bouldin_score(torch.from_numpy(x), torch.from_numpy(labels_empty), k))
    assert abs(got - float(jscoring.davies_bouldin_score(x, labels_empty, k))) <= DB_TOL


def test_davies_bouldin_masked_matches_reference():
    """The K-Means plane's call: one x (n, d) shared by lanes of labels
    (b, n) at padded width, with cluster masks; and a point mask over x."""
    b, n, d, k_pad = 3, 80, 5, 8
    x, _ = _problem(21, (n, d), k_pad)
    rng = np.random.default_rng(22)
    k_effs = np.array([3, 5, 8])
    labels = (rng.integers(0, 1 << 20, size=(b, n)) % k_effs[:, None]).astype(np.int32)
    cluster_mask = np.arange(k_pad)[None, :] < k_effs[:, None]
    got = scoring.davies_bouldin_score_masked(
        torch.from_numpy(x), torch.from_numpy(labels), k_pad, cluster_mask=torch.from_numpy(cluster_mask)
    )
    want = jscoring.davies_bouldin_score_masked(x, labels, k_pad, cluster_mask=cluster_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DB_TOL, atol=DB_TOL)
    for i, k in enumerate(k_effs):  # padded slots change nothing
        unpadded = float(jscoring.davies_bouldin_score(x, labels[i], int(k)))
        assert abs(float(got[i]) - unpadded) <= DB_TOL
    point_mask = np.arange(n) < n - 7  # broadcast to x's (n,), as the reference takes it
    got = scoring.davies_bouldin_score_masked(
        torch.from_numpy(x), torch.from_numpy(labels), k_pad,
        cluster_mask=torch.from_numpy(cluster_mask), point_mask=torch.from_numpy(point_mask),
    )
    want = jscoring.davies_bouldin_score_masked(x, labels, k_pad, cluster_mask=cluster_mask, point_mask=point_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DB_TOL, atol=DB_TOL)


def _grid_points(seed: int, shape: tuple, k: int):
    """Small-integer coordinates: every norm, dot product and self-distance is
    exact in fp32, so the only gap between PyTorch's and XLA's distance sums
    is the order of the sums, which 1e-5 holds."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=shape).astype(np.float32)
    labels = rng.integers(0, k, size=shape[:-1])
    return x, np.eye(k, dtype=np.float32)[labels]


@pytest.mark.parametrize("n,block_rows", [(60, 16), (64, 16), (37, 8), (50, 64)])
def test_blocked_tier_matches_reference(n, block_rows):
    x, onehot = _grid_points(n + block_rows, (n, 6), 4)
    got = scoring.cluster_dist_sums(torch.from_numpy(x), torch.from_numpy(onehot), block_rows=block_rows)
    want = jscoring._cluster_dist_sums_blocked(x, onehot, block_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    dense = scoring.cluster_dist_sums(torch.from_numpy(x), torch.from_numpy(onehot))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)


def test_blocked_tier_batched_and_past_the_dense_cutoff(monkeypatch):
    """A shared x under batched one-hots through the blocked tier, and the
    dense cutoff sending a large problem there by itself."""
    b, n, k = 3, 45, 5
    x, _ = _grid_points(31, (n, 4), k)
    _, onehot = _grid_points(32, (b, n, 4), k)
    got = scoring.cluster_dist_sums(torch.from_numpy(x), torch.from_numpy(onehot), block_rows=16)
    want = jscoring.cluster_dist_sums(x, onehot, block_rows=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    calls = []
    blocked = scoring._cluster_dist_sums_blocked
    monkeypatch.setattr(scoring, "_DENSE_MAX_ELEMENTS", n * n - 1)
    monkeypatch.setattr(scoring, "_cluster_dist_sums_blocked", lambda *a: calls.append(a[2]) or blocked(*a))
    past = scoring.cluster_dist_sums(torch.from_numpy(x), torch.from_numpy(onehot))
    assert calls == [scoring._DEFAULT_BLOCK_ROWS]
    np.testing.assert_allclose(past.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)


def test_noisy_score_is_a_fixed_function_of_seed_and_k():
    f = scoring.noisy(lambda k: scoring.square_wave_score(k, 5), seed=3, sigma=0.02)
    first = [float(f(k)) for k in range(2, 9)]
    assert [float(f(k)) for k in reversed(range(2, 9))] == first[::-1]
    clean = [float(scoring.square_wave_score(k, 5)) for k in range(2, 9)]
    assert all(0 < abs(a - c) < 0.1 for a, c in zip(first, clean))
    other = scoring.noisy(lambda k: scoring.square_wave_score(k, 5), seed=4, sigma=0.02)
    assert [float(other(k)) for k in range(2, 9)] != first


@pytest.mark.parametrize("k0", [2, 7, 15])
def test_synthetic_score_models_match_reference(k0):
    ks = np.arange(1, 20)
    np.testing.assert_allclose(
        scoring.square_wave_score(torch.from_numpy(ks), k0).numpy(),
        np.asarray(jscoring.square_wave_score(ks, k0)),
    )
    np.testing.assert_allclose(
        scoring.laplacian_score(torch.from_numpy(ks), k0, width=1.5).numpy(),
        np.asarray(jscoring.laplacian_score(ks, k0, width=1.5)),
        rtol=1e-6,
    )
