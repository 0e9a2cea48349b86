"""The port's K-Means and Davies-Bouldin at bf16 against the reference's
kernel route.

The points are the reference's ``blob_data`` at bf16
(``tests/test_integration.py``'s K-Means data: n 240, d 5, k_true 5, std
0.3, spread 10); the k-means++ draws are the reference's own
(``tests/_torch_reference.py``). The reference's bf16 K-Means has two
routes. Its default, plain one computes the distances at bf16, where the
Davies-Bouldin separation of two centroids in one blob cancels to 0 and is
divided by 1e-12. Its kernel route, the TPU kernel's arithmetic (bf16 in,
fp32 distances out), is what the port computes on every device, so the
reference is run on that route here: its two module globals
``pairwise_sq_dists`` (``repro.factorization.kmeans``,
``repro.core.scoring``) patched to ``use_kernel=True`` (the Pallas kernel
in interpret mode), with JAX's caches cleared on both sides of the patch
(its jitted fits keep their traces). There the centroids, counts and
deltas stay bf16 and the distances, inertia and scores are fp32; the
k-means++ probabilities are fp32, so the draws are fp32 as at float32.

Tolerances: the plain pairwise at bf16 against the Pallas kernel at the
reference's own bf16 tolerance (rtol 5e-2, atol 5e-1,
``tests/test_kernels.py``), and bit for bit the fp32 plain version on the
widened operands; labels, bf16 centroids and iteration counts equal;
inertia within ``INERTIA_RTOL`` of the reference's and of float64, and
Davies-Bouldin within ``SEARCH_DB_RTOL`` (fp32 sums in other orders,
``tests/test_torch_kmeans.py``); k_optimal and the visited ks equal.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.scoring as jscoring  # noqa: E402
from _torch_reference import kmeans_draws, reference_kmeans_draw_source  # noqa: E402
from repro.core import binary_bleed_search as j_binary_bleed_search  # noqa: E402
from repro.factorization.planes import KMeansBatchPlane as JKMeansBatchPlane  # noqa: E402
from repro.factorization.synthetic import blob_data as j_blob_data  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.convert import kmeans_draws_from_reference, leaf_tensor  # noqa: E402
from repro_torch.core import binary_bleed_search, davies_bouldin_score  # noqa: E402
from repro_torch.core.scoring import silhouette_score_masked  # noqa: E402
from repro_torch.factorization import KMeansBatchPlane, kmeans, kmeans_batched  # noqa: E402
from repro_torch.factorization.kmeans import kmeans_multi_restart  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# both packages export the function ``kmeans`` under the module's name
jkmeans = importlib.import_module("repro.factorization.kmeans")

KEY = jax.random.PRNGKey(3)
N, D, K_TRUE = 240, 5, 5
KS, K_PAD, MAX_ITERS = (2, 5, 7), 8, 25
BF16 = jnp.bfloat16
PAIRWISE_BF16_TOL = dict(rtol=5e-2, atol=5e-1)  # tests/test_kernels.py::test_pairwise at bf16
# Each distance is a cancellation of norms near 500 (fp32 ulp 6.1e-5) down to
# ~0.5, and the kernel route adds its three terms in another order than the
# plain one: the reference's inertia is up to 8.4e-5 (relative) from the
# float64 inertia of its own fit, the port's up to 5.1e-5 (measured at k 2,
# 5, 7, 9, 11). Both are held to float64 and to each other at 2e-4.
INERTIA_RTOL = 2e-4
SEARCH_DB_RTOL = 5e-4  # tests/test_torch_kmeans.py: DB's centroid separation is a cancellation
SEARCH = dict(select_threshold=0.5, stop_threshold=1.6, mode="minimize", num_resources=1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    """The reference's bf16 points (as a JAX array) and the port's tensor of them."""
    x16, _ = j_blob_data(KEY, n=N, d=D, k_true=K_TRUE, std=0.3, spread=10.0, dtype=BF16)
    return x16, leaf_tensor(np.asarray(x16), CPU)


def _draws(k: int, k_draw: int):
    return kmeans_draws_from_reference(*kmeans_draws(jax.random.fold_in(KEY, k), N, k_draw), device="cpu")


def _lane(res, i):
    return type(res)(*(field[i] for field in res))


@pytest.fixture(scope="module")
def reference(data):
    """Everything the tests hold the port to, on the reference's kernel route."""
    x16, _ = data
    kernel_pairwise = functools.partial(jscoring.pairwise_sq_dists, use_kernel=True)
    jax.clear_caches()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jkmeans, "pairwise_sq_dists", kernel_pairwise)
        mp.setattr(jscoring, "pairwise_sq_dists", kernel_pairwise)
        out["fits"] = {k: jkmeans.kmeans(x16, k, jax.random.fold_in(KEY, k), max_iters=MAX_ITERS) for k in KS}
        out["batched"] = jkmeans.kmeans_batched(x16, list(KS), KEY, k_pad=K_PAD, max_iters=MAX_ITERS)
        out["restart"] = jkmeans.kmeans_multi_restart(x16, K_TRUE, KEY, restarts=3, max_iters=MAX_ITERS)
        for score in ("davies_bouldin", "silhouette"):
            plane = JKMeansBatchPlane(x16, KEY, score=score, max_iters=MAX_ITERS, k_pad=K_PAD, use_kernel=True)
            out[score] = plane.evaluate_batch(list(KS))
            out[f"{score}_chunked"] = plane.evaluate_one(K_TRUE, should_abort=lambda: False)
        labels = {}

        def ev(k, should_abort=None):
            labels[int(k)] = jkmeans.kmeans(x16, int(k), jax.random.fold_in(KEY, k)).labels
            return float(jscoring.davies_bouldin_score(x16, labels[int(k)], int(k)))

        out["search"] = j_binary_bleed_search(ev, (2, 12), **SEARCH)
        out["search_labels"] = labels
    jax.clear_caches()
    return out


# -----------------------------------------------------------------------------
# the plain pairwise version at bf16: the TPU kernel's arithmetic
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("batched", [False, True])
def test_plain_pairwise_bf16_matches_the_pallas_kernel(data, batched):
    """fp32 distances of bf16 points against bf16 centroids, 2-D and with
    the points shared by 3 lanes, within the reference's bf16 tolerance of
    the Pallas kernel in interpret mode."""
    x16, x = data
    y16 = x16[jax.random.randint(jax.random.fold_in(KEY, 9), (3, 7), 0, N)] + BF16(0.25)
    y = leaf_tensor(np.asarray(y16), CPU)
    if batched:
        got = ops.pairwise_sq_dists_batched(x, y)
        want = jops.pairwise_sq_dists_batched(jnp.broadcast_to(x16, (3, N, D)), y16, interpret=True)
    else:
        got = ops.pairwise_sq_dists(x, y[0])
        want = jops.pairwise_sq_dists(x16, y16[0], interpret=True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PAIRWISE_BF16_TOL)


def test_plain_pairwise_bf16_is_the_fp32_version_on_widened_inputs(data):
    _, x = data
    y = x[:13] + 0.5
    assert torch.equal(ref.pairwise_sq_dists(x, y), ref.pairwise_sq_dists(x.float(), y.float()))
    assert torch.equal(ref.pairwise_sq_dists(x), ref.pairwise_sq_dists(x.float()))
    xb = torch.stack([x, x.flip(0)])
    assert torch.equal(ref.pairwise_sq_dists(xb, y), ref.pairwise_sq_dists(xb.float(), y.float()))


def test_float32_keeps_its_bits(data):
    """float32 operands: the plain pairwise and the centroid sums are their
    expressions before bf16, bit for bit (float64 likewise)."""
    from repro_torch.core.scoring import _cluster_sums

    _, x16 = data
    x, y = x16.float(), x16[:11].float() + 0.5
    for a, b in ((x, y), (x.double(), y.double())):
        xx = torch.sum(a * a, dim=-1)[..., :, None]
        yy = torch.sum(b * b, dim=-1)[..., None, :]
        assert torch.equal(ref.pairwise_sq_dists(a, b), torch.clamp(xx + yy - 2.0 * torch.matmul(a, b.T), min=0.0))
    onehot = torch.nn.functional.one_hot(torch.arange(N) % 7, 7).float()
    assert torch.equal(_cluster_sums(onehot, x), onehot.T @ x)


# -----------------------------------------------------------------------------
# the fits
# -----------------------------------------------------------------------------
def _assert_fit_matches(x, got, want, k: int | None = None):
    """Labels, bf16 centroids and iterations equal; fp32 inertia within
    ``INERTIA_RTOL`` of the reference's and both of float64's; padded slots
    >= k exactly 0."""
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.iters) == int(want.iters)
    assert got.centroids.dtype == torch.bfloat16 and got.inertia.dtype == torch.float32
    c_got, c_want = got.centroids.float().numpy(), np.asarray(want.centroids, np.float32)
    if k is not None:
        assert float(np.abs(c_got[k:]).max(initial=0.0)) == 0.0
        c_got, c_want = c_got[:k], c_want[:k]
    np.testing.assert_array_equal(c_got, c_want)
    exact = float(((x.double()[:, None] - torch.from_numpy(c_got).double()[None]) ** 2).sum(-1).amin(-1).sum())
    np.testing.assert_allclose([float(got.inertia), float(want.inertia)], exact, rtol=INERTIA_RTOL)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia), rtol=INERTIA_RTOL)


@pytest.mark.parametrize("k", KS)
def test_kmeans_bf16_matches_the_reference_kernel_route(data, reference, k):
    _, x = data
    _assert_fit_matches(x, kmeans(x, k, _draws(k, k), max_iters=MAX_ITERS), reference["fits"][k])


def test_kmeans_batched_bf16_matches_the_reference_kernel_route(data, reference):
    _, x = data
    got = kmeans_batched(x, list(KS), k_pad=K_PAD, max_iters=MAX_ITERS,
                         draws=reference_kmeans_draw_source(KEY, N))
    for i, k in enumerate(KS):
        _assert_fit_matches(x, _lane(got, i), _lane(reference["batched"], i), k)


def test_kmeans_multi_restart_bf16_matches_the_reference_kernel_route(data, reference):
    _, x = data
    draws = [kmeans_draws_from_reference(*kmeans_draws(kk, N, K_TRUE), device="cpu")
             for kk in jax.random.split(KEY, 3)]
    got = kmeans_multi_restart(x, K_TRUE, restarts=3, max_iters=MAX_ITERS, draws=draws)
    _assert_fit_matches(x, got, reference["restart"])


# -----------------------------------------------------------------------------
# the scores: the plane (batched and chunked) and the serial search
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("score", ["davies_bouldin", "silhouette"])
def test_kmeans_plane_bf16_matches_the_reference_kernel_route(data, reference, score):
    """``KMeansBatchPlane`` on bf16 points: the batched wave and the chunked
    abortable path, each against the reference's plane."""
    _, x = data
    plane = KMeansBatchPlane(x, score=score, max_iters=MAX_ITERS, k_pad=K_PAD,
                             draws=reference_kmeans_draw_source(KEY, N))
    got = plane.evaluate_batch(list(KS))
    chunked = plane.evaluate_one(K_TRUE, should_abort=lambda: False)
    tol = dict(rtol=SEARCH_DB_RTOL, atol=1e-5) if score == "davies_bouldin" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, reference[score], **tol)
    np.testing.assert_allclose(chunked, reference[f"{score}_chunked"], **tol)
    assert chunked == got[KS.index(K_TRUE)]  # chunk boundaries change nothing
    # fp32 scores of bf16 points, as on the reference's kernel route
    assert silhouette_score_masked(x, plane.last_labels, K_PAD).dtype == torch.float32
    assert davies_bouldin_score(x, plane.last_labels[0], K_PAD).dtype == torch.float32


def test_binary_bleed_kmeans_davies_bouldin_bf16_matches_reference(data, reference):
    """``tests/test_integration.py``'s K-Means + DB search on the bf16
    points (serial, so the visits are deterministic): the reference kernel
    route's k_optimal, visits and labels, its scores at ``SEARCH_DB_RTOL``."""
    _, x = data
    labels = {}

    def ev(k, should_abort=None):
        labels[int(k)] = kmeans(x, int(k), _draws(int(k), int(k))).labels
        return float(davies_bouldin_score(x, labels[int(k)], int(k)))

    got = binary_bleed_search(ev, (2, 12), **SEARCH)
    want = reference["search"]
    assert got.k_optimal == want.k_optimal == K_TRUE
    assert got.visited_ks == want.visited_ks
    scores = {v.k: v.score for v in got.visits}
    for v in want.visits:
        np.testing.assert_array_equal(labels[v.k].numpy(), np.asarray(reference["search_labels"][v.k]))
        np.testing.assert_allclose(scores[v.k], v.score, rtol=SEARCH_DB_RTOL, atol=1e-5)
