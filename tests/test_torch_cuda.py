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


FLASH_TOL = dict(rtol=3e-5, atol=3e-5)  # tests/test_kernels.py::test_flash_attention


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,hq,hk,lq,lk,d,causal,window",
    [
        (2, 14, 2, 1000, 1000, 64, True, None),  # qwen2: group 7, ragged L
        (1, 8, 2, 333, 333, 80, True, 100),      # h2o-danube head dim, window bites, ragged
        (1, 4, 1, 64, 64, 32, True, 24),         # MQA + window inside one tile
        (2, 6, 3, 70, 45, 17, False, None),      # non-causal, Lq != Lk, odd D
        (1, 2, 2, 256, 256, 128, True, None),    # largest head dim
        (3, 4, 4, 1, 1, 16, True, None),         # one row
    ],
)
def test_flash_kernel_matches_plain(b, hq, hk, lq, lk, d, causal, window):
    dev = card()
    rng = np.random.default_rng(b * hq + lq + d)
    q = torch.from_numpy(rng.normal(size=(b, hq, lq, d)).astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.normal(size=(b, hk, lk, d)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.normal(size=(b, hk, lk, d)).astype(np.float32)).to(dev)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    torch.testing.assert_close(got, ref.attention(q, k, v, causal=causal, window=window), **FLASH_TOL)


@pytest.mark.cuda
def test_flash_kernel_takes_the_models_strided_views():
    """(B, L, H, D) projections passed as (B, H, L, D) views: no copies,
    output in q's layout."""
    dev = card()
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, 77, 14, 64), device=dev, generator=gen)
    k = torch.randn((2, 77, 2, 64), device=dev, generator=gen)
    v = torch.randn((2, 77, 2, 64), device=dev, generator=gen)
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert got.stride() == q.transpose(1, 2).stride()
    want = ref.attention(*(t.transpose(1, 2).contiguous() for t in (q, k, v)))
    torch.testing.assert_close(got, want, **FLASH_TOL)


@pytest.mark.cuda
def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    dev = card()
    q = torch.ones((1, 4, 16, 32), device=dev)
    k = torch.ones((1, 2, 16, 32), device=dev)
    with pytest.raises(TypeError, match="float32"):
        ops.flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="unit stride"):
        ops.flash_attention(q.transpose(2, 3), k.transpose(2, 3), k.transpose(2, 3), causal=False)
    with pytest.raises(ValueError, match="Lq == Lk"):
        ops.flash_attention(q[:, :, :8], k, k)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.ones((1, 2, 16, 136), device=dev)
        ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        ops.flash_attention(q, k.cpu(), k)


@pytest.mark.cuda
def test_model_prefill_and_decode_on_the_card_match_the_cpu():
    """Reduced h2o-danube (window 16 < prompt 40): the card's prefill runs the
    flash kernel, the CPU's the plain path; same weights, same tokens."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import setup

    dev = card()
    cfg = reduced_config(get_config("h2o-danube-1.8b"))
    cpu_model, prompt, _, _ = setup(cfg, 2, 40, torch.device("cpu"), seed=1)
    card_model, _, _, _ = setup(cfg, 2, 40, torch.device("cpu"), seed=1)
    card_model.to(dev)
    before = ops.flash_attention.launches
    lg_card, c_card = card_model.prefill({"tokens": prompt.to(dev)}, cache_len=44)
    assert ops.flash_attention.launches == before + cfg.num_layers
    lg_cpu, c_cpu = cpu_model.prefill({"tokens": prompt}, cache_len=44)
    torch.testing.assert_close(lg_card.cpu(), lg_cpu, rtol=2e-3, atol=2e-3)
    tok = torch.argmax(lg_cpu[:, -1], -1)[:, None]
    for i in range(3):
        lg_card, c_card = card_model.decode_step(c_card, tok.to(dev), 40 + i)
        lg_cpu, c_cpu = cpu_model.decode_step(c_cpu, tok, 40 + i)
        torch.testing.assert_close(lg_card.cpu(), lg_cpu, rtol=2e-3, atol=2e-3)
        tok = torch.argmax(lg_cpu[:, -1], -1)[:, None]


@pytest.mark.cuda
def test_kmeanspp_choice_on_the_card_is_the_exact_draw():
    """k-means++ picks index searchsorted(cumsum(p), total * (1 - u)). A
    float32 ``torch.cumsum`` on the card adds in a timing-dependent order, and
    at n = 10^6 its ulp noise moves a few percent of draws to the
    neighbouring index: the same fit was seeded differently from run to run.
    The card's draws must be the exact (float64, CPU) draws, every time."""
    from repro_torch.factorization.kmeans import _choice

    dev = card()
    rng = np.random.default_rng(0)
    p = rng.exponential(size=1_000_000).astype(np.float32)
    p /= p.sum()
    u = rng.uniform(size=256).astype(np.float32)
    exact = _choice(torch.from_numpy(p).double().expand(256, -1), torch.from_numpy(u).double())
    pc = torch.from_numpy(p).to(dev).expand(256, -1)
    for _ in range(5):
        got = _choice(pc, torch.from_numpy(u).to(dev))
        assert torch.equal(got.cpu(), exact)
        got_1d = torch.stack([_choice(pc[i], torch.from_numpy(u[i:i + 1]).to(dev)[0]) for i in range(16)])
        assert torch.equal(got_1d.cpu(), exact[:16])
