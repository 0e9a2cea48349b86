"""The CUDA kernels vs their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips itself without a
card (decided inside the test, never at import or collection, so every
pytest worker collects the same tests). The file imports no JAX, so it
also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
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
