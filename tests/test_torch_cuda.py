"""The CUDA kernels vs their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips itself without a
card (decided inside the test, never at import or collection, so every
pytest worker collects the same tests). The file imports no JAX, so it
also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import resolve  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

MU_TOL = dict(rtol=3e-5, atol=3e-5)  # tests/test_kernels.py fp32 MU tolerance
SUMS_TOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_kernels.py fp32 distance tolerance


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return resolve("cuda")


def _mu_problem(dev, seed: int, lanes: int, n: int, m: int, k: int, dead: int):
    rng = np.random.default_rng(seed)
    v = rng.uniform(0.0, 1.0, (lanes, n, m)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (lanes, n, k)).astype(np.float32)
    h = rng.uniform(0.1, 1.0, (lanes, k, m)).astype(np.float32)
    w[..., :, k - dead:] = 0.0
    h[..., k - dead:, :] = 0.0
    return (torch.from_numpy(a).to(dev) for a in (v, w, h))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "lanes,n,m,k", [(1, 40, 24, 5), (6, 100, 90, 13), (4, 257, 130, 16), (2, 70, 50, 33), (2, 40, 30, 100)]
)
def test_mu_kernels_match_plain(lanes, n, m, k):
    dev = card()
    v, w, h = _mu_problem(dev, k, lanes, n, m, k, dead=2)
    for fn, plain in ((ops.mu_update_h, ref.mu_update_h), (ops.mu_update_w, ref.mu_update_w)):
        before = fn.launches
        got, want = fn(v, w, h), plain(v, w, h)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        torch.testing.assert_close(got, want, **MU_TOL)
    assert float(ops.mu_update_h(v, w, h)[:, -2:, :].abs().max()) == 0.0
    assert float(ops.mu_update_w(v, w, h)[:, :, -2:].abs().max()) == 0.0
    got2 = ops.mu_update_h(v[0], w[0], h[0])  # 2-D is one lane
    torch.testing.assert_close(got2, ref.mu_update_h(v[0], w[0], h[0]), **MU_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,k", [(1, 52, 1000, 13), (8, 64, 1000, 16), (3, 33, 17, 5), (2, 40, 9, 130 - 2)])
def test_dist_sums_kernel_matches_plain(b, n, d, k):
    dev = card()
    rng = np.random.default_rng(b + n + k)
    x = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32)).to(dev)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(rng.integers(0, k, (b, n))), k).float().to(dev)
    onehot[:, -4:, :] = 0.0  # masked points
    # held against the plain version in float64: fp32 cancellation noise in
    # |x|^2 + |y|^2 - 2 x.y differs between evaluation orders
    want = ref.silhouette_dist_sums(x.double(), onehot.double())
    torch.testing.assert_close(ops.silhouette_dist_sums_batched(x, onehot).double(), want, **SUMS_TOL)
    torch.testing.assert_close(ops.silhouette_dist_sums(x[0], onehot[0]).double(), want[0], **SUMS_TOL)


PAIRWISE_TOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_kernels.py::test_pairwise fp32 tolerance


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,n,m,d", [(1, 40, 24, 6), (3, 70, 30, 17), (1, 8, 8, 200), (2, 128, 128, 128), (16, 4097, 24, 6)]
)
def test_pairwise_kernels_match_plain(b, n, m, d):
    dev = card()
    rng = np.random.default_rng(b * n + m * d)
    x = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=(b, m, d)).astype(np.float32)).to(dev)
    before = ops.pairwise_sq_dists_batched.launches
    got = ops.pairwise_sq_dists_batched(x, y)
    torch.cuda.synchronize()
    assert ops.pairwise_sq_dists_batched.launches == before + 1
    torch.testing.assert_close(got, ref.pairwise_sq_dists(x, y), **PAIRWISE_TOL)
    # one x shared by every lane (lane stride 0), and y shared likewise
    torch.testing.assert_close(ops.pairwise_sq_dists_batched(x[0], y), ref.pairwise_sq_dists(x[0], y), **PAIRWISE_TOL)
    torch.testing.assert_close(ops.pairwise_sq_dists_batched(x, y[0]), ref.pairwise_sq_dists(x, y[0]), **PAIRWISE_TOL)
    before = ops.pairwise_sq_dists.launches
    torch.testing.assert_close(ops.pairwise_sq_dists(x[0], y[0]), ref.pairwise_sq_dists(x[0], y[0]), **PAIRWISE_TOL)
    torch.testing.assert_close(ops.pairwise_sq_dists(x[0]), ref.pairwise_sq_dists(x[0]), **PAIRWISE_TOL)
    assert ops.pairwise_sq_dists.launches == before + 2


@pytest.mark.cuda
def test_pairwise_wrappers_refuse_what_the_kernel_does_not_take():
    dev = card()
    x = torch.ones((2, 16, 6), device=dev)
    y = torch.ones((2, 8, 6), device=dev)
    with pytest.raises(TypeError, match="float32"):
        ops.pairwise_sq_dists_batched(x.bfloat16(), y.bfloat16())
    with pytest.raises(TypeError, match="float32"):
        ops.pairwise_sq_dists(x[0].bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ops.pairwise_sq_dists_batched(x.transpose(1, 2), y.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        ops.pairwise_sq_dists(x[0].T, y[0].T)
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        ops.pairwise_sq_dists_batched(x, y.cpu())
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        ops.pairwise_sq_dists(x[0].cpu(), y[0])
    with pytest.raises(ValueError, match="one lane count"):
        ops.pairwise_sq_dists_batched(x, torch.ones((3, 8, 6), device=dev))


@pytest.mark.cuda
def test_kmeans_with_kernels_matches_plain_on_the_card(monkeypatch):
    """The same fit on the card, once through the pairwise kernels and once
    through their plain versions, on clean blobs: equal labels. The ks stay
    at or below k_true, where no point lies near a cluster boundary, so the
    fp32 rounding gap between the two paths cannot flip a label."""
    from repro_torch.factorization.synthetic import blob_data

    # the package exports the function ``kmeans`` under the module's name
    kmeans_mod = importlib.import_module("repro_torch.factorization.kmeans")

    dev = card()
    x, _ = blob_data(n=20000, d=6, k_true=7, std=0.5, spread=8.0, seed=1, device=dev)
    ks = [3, 5, 7]
    ops.reset_launch_counts()
    with_kernels = [kmeans_mod.kmeans(x, k, seed=2) for k in ks]
    batched = kmeans_mod.kmeans_batched(x, ks, seed=2, k_pad=12)
    assert ops.pairwise_sq_dists.launches > 0 and ops.pairwise_sq_dists_batched.launches > 0
    monkeypatch.setattr(kmeans_mod, "pairwise_sq_dists", ref.pairwise_sq_dists)
    ops.reset_launch_counts()
    plain = [kmeans_mod.kmeans(x, k, seed=2) for k in ks]
    assert ops.pairwise_sq_dists.launches == 0
    for i, (a, b) in enumerate(zip(with_kernels, plain)):
        assert torch.equal(a.labels, b.labels)
        assert int(a.iters) == int(b.iters)
        torch.testing.assert_close(a.centroids, b.centroids, rtol=1e-5, atol=1e-5)
        assert torch.equal(batched.labels[i], a.labels)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    dev = card()
    v, w, h = _mu_problem(dev, 0, 1, 16, 12, 4, dead=1)
    with pytest.raises(TypeError, match="float32"):
        ops.mu_update_h(v.double(), w.double(), h.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.mu_update_h(v.transpose(1, 2), w, h.transpose(1, 2))
    with pytest.raises(ValueError, match="k <= 128"):
        big = torch.ones((1, 16, 129), device=dev)
        ops.mu_update_w(v, big, torch.ones((1, 129, 12), device=dev))
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        ops.mu_update_h(v, w.cpu(), h)
