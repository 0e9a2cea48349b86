"""Port silhouette scoring vs ``repro.core.scoring`` on the same inputs.

Covers singleton and empty clusters, ``point_mask``, a leading batch axis,
an unbatched x under batched labels, and the §III-D synthetic score models.
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
