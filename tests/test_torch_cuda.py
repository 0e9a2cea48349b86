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
from repro_torch.kernels import build, ops, ref  # noqa: E402

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


# (L, n, m, k) through the split reduction: n at an H split boundary (at
# L=4, m=1100 the planner cuts n=128 into 4 x 32 rows: 128 and +-1), m at a W
# split boundary (at L=4, n=1000 it cuts m=256 into 4 x 64 columns; 255 and
# 257 take the 4-byte copies), n below one chunk, n = 1, the paper's shape at
# the threads executor's L=4 and the batched wave's L=32, ragged k, and the
# KB=32 and KB=128 buckets.
MU_SPLIT_SHAPES = [
    (4, 127, 1100, 16), (4, 128, 1100, 16), (4, 129, 1100, 16),
    (4, 1000, 255, 16), (4, 1000, 256, 16), (4, 1000, 257, 16),
    (4, 20, 1100, 16), (3, 1, 1100, 16), (4, 1000, 1100, 16), (32, 1000, 1100, 16),
    (4, 1000, 1100, 13), (4, 300, 520, 17), (2, 300, 520, 100),
]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n,m,k", MU_SPLIT_SHAPES)
def test_mu_kernels_split_reduction_matches_plain(lanes, n, m, k):
    dev = card()
    v, w, h = _mu_problem(dev, n + m + k, lanes, n, m, k, dead=2)
    for fn, plain, update in ((ops.mu_update_h, ref.mu_update_h, "h"), (ops.mu_update_w, ref.mu_update_w, "w")):
        plan = ops._mu_plan(update, lanes, n, m, k, torch.cuda.get_device_properties(dev).multi_processor_count)
        before = fn.launches
        got, want = fn(v, w, h), plain(v, w, h)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, "one launch per call, whatever the split"
        assert plan.blocks >= 1 and plan.items == plan.whole + (plan.units - plan.whole) * plan.split
        torch.testing.assert_close(got, want, **MU_TOL, msg=lambda e, p=plan: f"{p}: {e}")
        dead = got[:, -2:, :] if update == "h" else got[:, :, -2:]
        assert float(dead.abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n,m,k", [(32, 1000, 1100, 16), (4, 1000, 1100, 16), (4, 129, 257, 13)])
def test_mu_kernels_are_bitwise_deterministic(lanes, n, m, k):
    """The split's last block adds the partials in index order, never with
    atomics: five calls give the same bits."""
    dev = card()
    v, w, h = _mu_problem(dev, 7, lanes, n, m, k, dead=2)
    for fn in (ops.mu_update_h, ops.mu_update_w):
        first = fn(v, w, h)
        for _ in range(4):
            assert torch.equal(fn(v, w, h), first)


@pytest.mark.cuda
def test_mu_kernels_leave_their_arrival_counters_at_zero():
    """The wrapper zeroes its counters once, when it allocates them; every
    launch must leave them at zero for the next. Checks every counter this
    thread's launches were handed."""
    dev = card()
    v, w, h = _mu_problem(dev, 3, 4, 1000, 1100, 16, dead=2)
    for _ in range(2):
        ops.mu_update_h(v, w, h)
        ops.mu_update_w(v, w, h)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    held, _ = ops._scratch.args[("h", v.device, stream, 4, 1000, 1100, 16, 4)]
    assert held[1].numel() >= ops._mu_plan("h", 4, 1000, 1100, 16).counters > 0
    counters = [held[1] for held, _ in ops._scratch.args.values() if held]
    assert counters and all(int(c.abs().sum()) == 0 for c in counters)


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


def _pooled(dev, b: int, p: int, k: int, k_effs, d: int, seed: int = 3):
    """Pooled L2-normalized W columns of b lanes (p near-duplicate copies of
    k components, NMFk's case; x = y) and their masked one-hot."""
    rng = np.random.default_rng(seed + b + p + k + d)
    base = rng.uniform(size=(b, 1, d, k))
    cols = base + 0.01 * rng.uniform(size=(b, p, d, k))
    cols /= np.linalg.norm(cols, axis=2, keepdims=True)
    x = np.ascontiguousarray(cols.transpose(0, 1, 3, 2).reshape(b, p * k, d), dtype=np.float32)
    onehot = np.tile(np.eye(k, dtype=np.float32), (1, p, 1)).repeat(b, 0).reshape(b, p * k, k)
    onehot *= np.tile(np.arange(k)[None, :] < np.asarray(k_effs)[:, None], (1, p))[..., None]
    return torch.from_numpy(x).to(dev), torch.from_numpy(np.ascontiguousarray(onehot)).to(dev)


# (b, p, k, d): the threads path's 2-D point counts at d 1000 (p 4: k 2, 7,
# 13, 16), the batched wave (b 8, k_pad 16), a ragged d, k past 128 (p 2:
# 258 and 400 points, the general path; p 1: 129 and 200 points, and 64
# points of 2 copies at k 32), the thin path's limit of points and one
# beyond it, and d below one 16-byte copy.
SUMS_CASES = [
    (1, 4, 2, 1000), (1, 4, 7, 1000), (1, 4, 13, 1000), (1, 4, 16, 1000), (8, 4, 16, 1000),
    (1, 4, 13, 999), (2, 4, 16, 999), (1, 2, 129, 1000), (2, 2, 200, 1000), (1, 1, 129, 1000), (2, 1, 200, 300),
    (3, 4, 32, 1000), (2, 3, 43, 1000), (2, 1, 40, 3), (4, 4, 16, 129),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,k,d", SUMS_CASES)
def test_dist_sums_kernel_matches_float64_plain_at_nmfk_shapes(b, p, k, d):
    """Pooled near-duplicate columns with masked clusters on lanes after the
    first: held against the plain version in float64 (the fp32 cancellation
    noise of |x|^2 + |y|^2 - 2 x.y differs between evaluation orders), and
    two calls give the same bits."""
    dev = card()
    k_effs = [k - (i % 3) for i in range(b)]
    x, onehot = _pooled(dev, b, p, k, k_effs, d)
    want = ref.silhouette_dist_sums(x.double(), onehot.double())
    before = ops.silhouette_dist_sums_batched.launches
    got = ops.silhouette_dist_sums_batched(x, onehot)
    torch.cuda.synchronize()
    assert ops.silhouette_dist_sums_batched.launches == before + 1
    torch.testing.assert_close(got.double(), want, **SUMS_TOL)
    assert torch.equal(got, ops.silhouette_dist_sums_batched(x, onehot))
    got2 = ops.silhouette_dist_sums(x[0], onehot[0])
    torch.testing.assert_close(got2.double(), want[0], **SUMS_TOL)
    assert torch.equal(got2, ops.silhouette_dist_sums(x[0], onehot[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("b,points,k", [(1, 100, 200), (2, 128, 129), (3, 60, 300)])
def test_dist_sums_thin_path_takes_more_clusters_than_one_chunk(b, points, k):
    """Points within the thin path's limit spread over k > 128 clusters
    (point j in cluster (2 j) % k): the contraction walks several chunks."""
    dev = card()
    x, _ = _pooled(dev, b, 1, points, [points] * b, 1000)
    labels = (2 * torch.arange(points, device=dev)) % k
    onehot = torch.nn.functional.one_hot(labels, k).float().expand(b, points, k).contiguous()
    got = ops.silhouette_dist_sums_batched(x, onehot)
    torch.testing.assert_close(got.double(), ref.silhouette_dist_sums(x.double(), onehot.double()), **SUMS_TOL)
    assert torch.equal(got, ops.silhouette_dist_sums_batched(x, onehot))


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,d", [(2, 32, 1000), (1, 13, 999), (3, 7, 64)])
def test_dist_sums_thin_and_general_paths_agree(b, k, d):
    """The thin path's largest point count, and the same points with one
    more y row whose one-hot row is zero, which takes the general path: the
    same sums. They add d in another order (the thin path in cluster slices,
    the general one in steps of 32), so they agree at SUMS_TOL, not bit for
    bit."""
    dev = card()
    thin_m = ops.SILHOUETTE_THIN_POINTS
    p = -(-thin_m // k)
    x, onehot = _pooled(dev, b, p, k, [k] * b, d)
    x, onehot = x[:, :thin_m].contiguous(), onehot[:, :thin_m].contiguous()
    y_more = torch.cat([x, x[:, :1]], dim=1).contiguous()
    onehot_more = torch.cat([onehot, torch.zeros_like(onehot[:, :1])], dim=1).contiguous()
    thin = ops.silhouette_dist_sums_batched(x, onehot)
    general = ops.silhouette_dist_sums_batched(x, onehot_more, y_more)
    torch.testing.assert_close(thin, general, **SUMS_TOL)
    torch.testing.assert_close(thin.double(), ref.silhouette_dist_sums(x.double(), onehot.double()), **SUMS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [129, 200, 256])
def test_mu_kernels_above_128_ranks_match_plain(k):
    """Ranks past the tiled kernels' largest bucket go to the any-rank
    kernel: held against plain, masked ranks exactly zero, two calls equal."""
    dev = card()
    v, w, h = _mu_problem(dev, k, 2, 300, 320, k, dead=3)
    for fn, plain, upd in ((ops.mu_update_h, ref.mu_update_h, "h"), (ops.mu_update_w, ref.mu_update_w, "w")):
        before = fn.launches
        got = fn(v, w, h)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        torch.testing.assert_close(got, plain(v, w, h), **MU_TOL)
        dead = got[:, -3:, :] if upd == "h" else got[:, :, -3:]
        assert float(dead.abs().max()) == 0.0
        assert torch.equal(got, fn(v, w, h))
        # 2-D is one lane (its G or Q comes from a one-lane bmm, so its bits may differ)
        torch.testing.assert_close(fn(v[1], w[1], h[1]), plain(v[1], w[1], h[1]), **MU_TOL)


# Output digests (sum of the int32 views) of the tiled MU kernels at ranks
# up to 128, measured on an NVIDIA H100 80GB HBM3 from the commit before the
# any-rank kernel was added (tools/time_mu.py --digests): the tiled kernels'
# bits must not move.
MU_DIGESTS = {
    (32, 1000, 1100, 16): [507532595009927, 461387685527039],
    (4, 1000, 1100, 16): [63440461428910, 57675464258088],
    (4, 129, 257, 13): [11679949365003, 5862794496431],
    (2, 300, 520, 100): [102576548729336, 59180937803992],
    (6, 100, 90, 13): [6135525964978, 6815542290109],
    (2, 70, 50, 33): [3163396716413, 4429103366259],
    (2, 300, 320, 128): [80912866556872, 75853946397493],
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(MU_DIGESTS))
def test_mu_kernels_up_to_128_ranks_keep_their_bits(shape):
    dev = card()
    lanes, n, m, k = shape
    v, w, h = _mu_problem(dev, sum(shape), lanes, n, m, k, dead=2)
    bits = [int(fn(v, w, h).view(torch.int32).sum(dtype=torch.int64)) for fn in (ops.mu_update_h, ops.mu_update_w)]
    assert bits == MU_DIGESTS[shape]


PAIRWISE_TOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_kernels.py::test_pairwise fp32 tolerance


THIN_M, THIN_D = ops.PAIRWISE_THIN_COLS, ops.PAIRWISE_THIN_DIM
PAIRWISE_SHAPES = [
    (1, 40, 24, 6), (3, 70, 30, 17), (1, 8, 8, 200), (2, 128, 128, 128), (16, 4097, 24, 6),
    # the thin path's edges: m and d at its limits, and one above each (general path)
    (2, 100, THIN_M, THIN_D), (2, 100, THIN_M + 1, 6), (2, 100, 24, THIN_D + 1), (2, 100, THIN_M + 1, THIN_D + 1),
    (1, 1000, 24, 6), (3, 4099, 13, 6),  # n not a multiple of a warp's or a block's rows
    (2, 5, 24, 6), (1, 1, 7, 6),  # n below one tile
    (2, 77, 24, 1),  # d = 1
    (3, 77, 13, 6), (2, 333, 7, 3),  # n m and n d not multiples of 4: unaligned lane bases
    (16, 999, 7, 3),  # 16 lanes, x or y shared below
    (160, 70, 24, 6), (300, 33, 2, 6),  # more lanes than SMs
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,d", PAIRWISE_SHAPES)
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
@pytest.mark.parametrize("lanes", [1, 16])
def test_pairwise_kernels_are_bitwise_deterministic(lanes):
    """Two calls at the K-Means main path's shape (10^6 points, d 6, 24
    centroid slots; x shared by the lanes) give the same bits."""
    dev = card()
    rng = np.random.default_rng(lanes)
    x = torch.from_numpy(rng.normal(size=(10**6, 6)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=(lanes, 24, 6)).astype(np.float32)).to(dev)
    first = ops.pairwise_sq_dists_batched(x, y)
    assert torch.equal(first, ops.pairwise_sq_dists_batched(x, y))
    del first
    first = ops.pairwise_sq_dists(x, y[0])
    assert torch.equal(first, ops.pairwise_sq_dists(x, y[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(1, 5000, 6), (3, 777, 17), (2, 300, 32)])
def test_pairwise_thin_and_general_paths_agree_bitwise(b, n, d):
    """The same centroids through the thin path (m at its limit) and, with
    one more row, through the general one: the shared columns are equal bit
    for bit, as both add in the same order."""
    dev = card()
    rng = np.random.default_rng(n + d)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=(b, THIN_M + 1, d)).astype(np.float32)).to(dev)
    general = ops.pairwise_sq_dists_batched(x, y)
    thin = ops.pairwise_sq_dists_batched(x, y[:, :THIN_M].contiguous())
    assert torch.equal(general[..., :THIN_M], thin)


@pytest.mark.cuda
def test_pairwise_wrappers_refuse_what_the_kernel_does_not_take():
    dev = card()
    x = torch.ones((2, 16, 6), device=dev)
    y = torch.ones((2, 8, 6), device=dev)
    with pytest.raises(TypeError, match="float16 is queued"):
        ops.pairwise_sq_dists_batched(x.half(), y.half())
    with pytest.raises(TypeError, match="float16 is queued"):
        ops.pairwise_sq_dists(x[0].half())
    with pytest.raises(TypeError, match="of one dtype"):
        ops.pairwise_sq_dists(x[0].bfloat16(), y[0])
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


PAIRWISE_BF16_TOL = dict(rtol=5e-2, atol=5e-1)  # tests/test_kernels.py::test_pairwise bf16 tolerance


def _bf16_pair(dev, b: int, n: int, m: int, d: int):
    rng = np.random.default_rng(b * n + m * d + 1)
    x = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32)).to(dev).bfloat16()
    y = torch.from_numpy(rng.normal(size=(b, m, d)).astype(np.float32)).to(dev).bfloat16()
    return x, y


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,d", PAIRWISE_SHAPES)
def test_pairwise_bf16_kernels_match_plain(b, n, m, d):
    """bf16 x and y: float32 distances within the reference's bf16 tolerance
    of the plain version, and bit for bit the fp32 kernel's on the widened
    operands (widening is exact and the adds are the fp32 kernel's), 2-D and
    batched, x or y shared; only the bf16 kernels launched."""
    dev = card()
    x, y = _bf16_pair(dev, b, n, m, d)
    cases = [(ops.pairwise_sq_dists_batched, (x, y)), (ops.pairwise_sq_dists_batched, (x[0], y)),
             (ops.pairwise_sq_dists_batched, (x, y[0])), (ops.pairwise_sq_dists, (x[0], y[0])),
             (ops.pairwise_sq_dists, (x[0],))]
    for fn, args in cases:
        ops.reset_launch_counts()
        got = fn(*args)
        counts = ops.launch_counts()
        assert counts[ops.bf16_name(fn)] == 1 and counts[fn.__name__] == 0
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, ref.pairwise_sq_dists(*args), **PAIRWISE_BF16_TOL)
        assert torch.equal(got, fn(*(a.float() for a in args)))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 16])
def test_pairwise_bf16_kernels_are_bitwise_deterministic(lanes):
    """The K-Means main path's shape at bf16 (10^6 points, d 6, 24 centroid
    slots, x shared): two calls give the same bits, the fp32 kernel's on the
    widened operands, and the float64 error is at most twice the plain
    version's."""
    dev = card()
    x, y = _bf16_pair(dev, lanes, 10**6, 24, 6)
    x = x[0]
    first = ops.pairwise_sq_dists_batched(x, y)
    assert torch.equal(first, ops.pairwise_sq_dists_batched(x, y))
    assert torch.equal(first, ops.pairwise_sq_dists_batched(x.float(), y.float()))
    want = ref.pairwise_sq_dists(x.double(), y.double())
    plain = ref.pairwise_sq_dists(x, y)
    assert (first.double() - want).abs().max() <= 2 * (plain.double() - want).abs().max()
    del first, want, plain
    first = ops.pairwise_sq_dists(x, y[0])
    assert torch.equal(first, ops.pairwise_sq_dists(x, y[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(1, 5000, 6), (3, 777, 17), (2, 300, 32)])
def test_pairwise_bf16_thin_and_general_paths_agree_bitwise(b, n, d):
    """The bf16 half's thin path (m at its limit) and general path (one more
    row) give the same bits on the shared columns, as the fp32 kernel's do."""
    dev = card()
    x, y = _bf16_pair(dev, b, n, THIN_M + 1, d)
    general = ops.pairwise_sq_dists_batched(x[0], y)
    thin = ops.pairwise_sq_dists_batched(x[0], y[:, :THIN_M].contiguous())
    assert torch.equal(general[..., :THIN_M], thin)


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
    # k = 129, past the tiled kernels' largest rank bucket, is taken (it
    # once raised here): the any-rank kernel, held against plain
    v, w, h = _mu_problem(dev, 1, 1, 16, 12, 129, dead=1)
    torch.testing.assert_close(ops.mu_update_w(v, w, h), ref.mu_update_w(v, w, h), **MU_TOL)
    torch.testing.assert_close(ops.mu_update_h(v, w, h), ref.mu_update_h(v, w, h), **MU_TOL)
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        ops.mu_update_h(v, w.cpu(), h)


FLASH_TOL = dict(rtol=3e-5, atol=3e-5)  # tests/test_kernels.py::test_flash_attention


FLASH_CASES = [  # (b, hq, hk, lq, lk, d, causal, window)
    (2, 14, 2, 1000, 1000, 64, True, None),  # qwen2: group 7, ragged L
    (1, 8, 2, 333, 333, 80, True, 100),      # h2o-danube head dim, window bites, ragged
    (1, 4, 1, 64, 64, 32, True, 24),         # MQA + window inside one tile
    (2, 6, 3, 70, 45, 17, False, None),      # non-causal, Lq != Lk, odd D: element-by-element rows
    (1, 2, 2, 256, 256, 128, True, None),    # largest head dim
    (3, 4, 4, 1, 1, 16, True, None),         # one row
    (2, 6, 3, 70, 45, 16, False, None),      # non-causal, Lq != Lk, D % 4 == 0
    (1, 4, 2, 300, 300, 96, True, None),     # 32-key tiles
    (1, 3, 3, 517, 517, 112, True, 77),      # 16-key tiles, window
    (2, 4, 2, 129, 129, 4, True, None),      # D 4
    (1, 2, 1, 100, 100, 1, True, None),      # D 1
]


def _flash_inputs(dev, b, hq, hk, lq, lk, d):
    rng = np.random.default_rng(b * hq + lq + d)
    q = torch.from_numpy(rng.normal(size=(b, hq, lq, d)).astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.normal(size=(b, hk, lk, d)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.normal(size=(b, hk, lk, d)).astype(np.float32)).to(dev)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hk,lq,lk,d,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain(b, hq, hk, lq, lk, d, causal, window):
    dev = card()
    q, k, v = _flash_inputs(dev, b, hq, hk, lq, lk, d)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    torch.testing.assert_close(got, ref.attention(q, k, v, causal=causal, window=window), **FLASH_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [0, 1, 3, 6])
def test_flash_kernel_is_bitwise_deterministic(case):
    """Each row's kv tiles are walked in ascending order by one warp, with
    no split over kv and no atomics: two calls give the same bits."""
    b, hq, hk, lq, lk, d, causal, window = FLASH_CASES[case]
    q, k, v = _flash_inputs(card(), b, hq, hk, lq, lk, d)
    first = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(first, ops.flash_attention(q, k, v, causal=causal, window=window))


FLASH_OFFSET_CASES = [  # (b, hq, hk, lq, lk, d, window, q_offset)
    (1, 14, 2, 250, 1000, 64, None, 750),   # the last rank's block of qwen2's prefill at model 4
    (1, 14, 2, 250, 1000, 64, None, 250),
    (2, 4, 2, 100, 300, 80, 40, 137),       # window, an offset off the tiles
    (1, 3, 1, 33, 97, 17, None, 64),        # odd D, ragged block ending at Lk
    (1, 2, 2, 64, 256, 128, 16, 100),       # D 128, a window inside the block
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hk,lq,lk,d,window,q_offset", FLASH_OFFSET_CASES)
def test_flash_kernel_at_a_query_offset_matches_plain(b, hq, hk, lq, lk, d, window, q_offset):
    """Query row i at position ``q_offset + i`` against every key: the
    kernel against the plain version at that offset, twice the same bits."""
    dev = card()
    q, _, _ = _flash_inputs(dev, b, hq, hk, lq, lq, d)
    _, k, v = _flash_inputs(dev, b, hq, hk, lk, lk, d)
    got = ops.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    torch.testing.assert_close(got, ref.attention(q, k, v, causal=True, window=window, q_offset=q_offset),
                               **FLASH_TOL)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset))


def _offset_rows(t: torch.Tensor, row: int) -> torch.Tensor:
    """t's values in a view whose rows are ``row`` floats apart and whose
    base is one float past a 16-byte boundary."""
    *lead, length, d = t.shape
    buf = torch.zeros((*lead, length, row), device=t.device)
    view = buf[..., 1:1 + d]
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 17])
def test_flash_kernel_reads_operands_of_any_stride_and_alignment(d):
    """q, k and v with rows of 66 floats, one float off a 16-byte boundary:
    the kernel stages them element by element and gives the bits it gives
    for dense copies of the same values."""
    dev = card()
    q, k, v = _flash_inputs(dev, 2, 6, 3, 150, 150, d)
    q_odd, k_odd, v_odd = (_offset_rows(t, 66) for t in (q, k, v))
    assert q_odd.stride()[2] == 66 and q_odd.data_ptr() % 16 != 0
    got = ops.flash_attention(q_odd, k_odd, v_odd, window=40)
    torch.testing.assert_close(got, ref.attention(q, k, v, window=40), **FLASH_TOL)
    assert torch.equal(got, ops.flash_attention(q, k, v, window=40))


@pytest.mark.cuda
def test_flash_launch_failure_raises(monkeypatch):
    """A launch the library refuses (here: K/V scratch off a 16-byte
    boundary) raises, and counts no launch."""
    dev = card()
    lib = build.load("flash_attention")

    class Misaligned:
        def flash_tiles(self, d, field, bf16):
            return lib.flash_tiles(d, field, bf16)

        def flash_attention(self, *args):
            return lib.flash_attention(*args[:4], args[4] + 4, *args[5:])

    monkeypatch.setattr(build, "load", lambda name: Misaligned())
    q = torch.ones((1, 2, 16, 32), device=dev)
    before = ops.flash_attention.launches
    with pytest.raises(RuntimeError, match="flash_attention: CUDA error"):
        ops.flash_attention(q, q, q)
    assert ops.flash_attention.launches == before


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


def _flash_bf16_holds(q, k, v, causal, window, q_offset):
    """The bf16 kernel against the plain version (fp32 scores, softmax and
    sums, bf16 out) at the reference's bf16 tolerance; its error from the
    float64 plain version at most twice the plain version's; a repeat gives
    the same bits; only the bf16 kernel is launched. Returns the output."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.launch_counts()[ops.FLASH_BF16] == 1 and ops.flash_attention.launches == 0
    assert got.dtype == torch.bfloat16
    plain = ref.attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), plain.float(), rtol=3e-2, atol=3e-2)
    want = ref.attention(q.double(), k.double(), v.double(), **kw)
    assert (got.double() - want).abs().max() <= 2 * (plain.double() - want).abs().max()
    assert torch.equal(got, ops.flash_attention(q, k, v, **kw))
    return got


def _bf16_qkv(dev, b, hq, hk, lq, lk, d, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((b, h, n, d), device=dev, generator=gen).bfloat16() for h, n in ((hq, lq), (hk, lk), (hk, lk)))


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hk,lq,lk,d,causal,window,q_offset", [
    (2, 14, 2, 77, 77, 64, True, None, 0),    # qwen2's heads, ragged
    (1, 8, 2, 130, 130, 128, True, None, 0),  # D 128
    (1, 4, 1, 100, 300, 80, True, 50, 200),   # D 80, window, query offset
    (2, 6, 3, 70, 45, 17, False, None, 0),    # ragged D, non-causal
    (1, 2, 1, 100, 100, 1, True, None, 0),    # D 1
    (1, 4, 2, 300, 300, 96, True, None, 0),   # D 96: two slabs, the second part zeros
    (1, 3, 3, 517, 517, 112, True, 77, 0),    # D 112, window
    (2, 4, 2, 129, 129, 16, True, None, 0),   # D 16: one k16 step
    (1, 4, 1, 64, 64, 32, True, 24, 0),       # MQA, window inside one tile
    (1, 4, 2, 256, 256, 64, False, 100, 0),   # a window without the causal mask
    (1, 14, 2, 250, 1000, 64, True, None, 750),  # a rank's block of a sequence-parallel prefill
    (2, 4, 2, 33, 97, 128, True, 16, 64),     # Lq != Lk at an offset, D 128, window
    (3, 4, 4, 1, 1, 16, True, None, 0),       # one row
])
def test_flash_bf16_kernel_matches_plain(b, hq, hk, lq, lk, d, causal, window, q_offset):
    """The bf16 kernel against the plain version at every head-dim slab
    layout (D 1..128), causal, windowed and query-offset masks."""
    q, k, v = _bf16_qkv(card(), b, hq, hk, lq, lk, d, d)
    _flash_bf16_holds(q, k, v, causal, window, q_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 17, 128])
def test_flash_bf16_kernel_reads_operands_of_any_stride_and_alignment(d):
    """q, k and v with rows of D + 9 elements, one element off a 16-byte
    boundary (the producer's plain loads, not tensor boxes), and as the
    model's (B, L, H, D) projections seen as (B, H, L, D) (tensor boxes on
    a permuted view): the same bits as dense copies of the same values."""
    dev = card()
    q, k, v = _bf16_qkv(dev, 2, 6, 3, 150, 150, d, 5)
    dense = _flash_bf16_holds(q, k, v, True, 40, 0)

    def odd_rows(t):
        buf = torch.zeros((*t.shape[:-1], d + 9), device=dev, dtype=t.dtype)
        view = buf[..., 1:1 + d]
        view.copy_(t)
        return view

    q_odd, k_odd, v_odd = (odd_rows(t) for t in (q, k, v))
    assert q_odd.data_ptr() % 16 != 0
    assert torch.equal(_flash_bf16_holds(q_odd, k_odd, v_odd, True, 40, 0), dense)
    q_bl, k_bl, v_bl = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    got = _flash_bf16_holds(q_bl, k_bl, v_bl, True, 40, 0)
    assert got.stride() == q_bl.stride() and torch.equal(got, dense)


@pytest.mark.cuda
def test_bf16_halves_of_mu_pairwise_and_silhouette_are_queued():
    """None of the three is queued any more: the MU, silhouette and pairwise
    wrappers take bf16 through their bf16 kernels (matching the plain
    versions); float16 alone is refused."""
    dev = card()
    x = torch.ones((8, 4), device=dev, dtype=torch.bfloat16)
    w, h = x, torch.ones((4, 4), device=dev, dtype=torch.bfloat16)  # V (8, 4) = W (8, 4) H (4, 4)
    onehot = torch.ones((8, 2), device=dev, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    torch.testing.assert_close(ops.mu_update_h(x, w, h), ref.mu_update_h(x, w, h), **MU_BF16_TOL)
    torch.testing.assert_close(ops.silhouette_dist_sums(x, onehot), ref.silhouette_dist_sums(x, onehot),
                               **SUMS_BF16_TOL)
    torch.testing.assert_close(ops.pairwise_sq_dists(x), ref.pairwise_sq_dists(x), **SUMS_BF16_TOL)
    torch.testing.assert_close(ops.pairwise_sq_dists_batched(x[None]), ref.pairwise_sq_dists(x[None]),
                               **SUMS_BF16_TOL)
    counts = ops.launch_counts()
    assert counts["mu_update_h[bf16]"] == counts["silhouette_dist_sums[bf16]"] == 1
    assert counts["pairwise_sq_dists[bf16]"] == counts["pairwise_sq_dists_batched[bf16]"] == 1
    assert counts["mu_update_h"] == counts["silhouette_dist_sums"] == 0
    assert counts["pairwise_sq_dists"] == counts["pairwise_sq_dists_batched"] == 0
    with pytest.raises(TypeError, match="float16 is queued"):
        ops.pairwise_sq_dists(x.half())
    with pytest.raises(TypeError, match="float16 is queued"):
        ops.mu_update_w(x.half(), w.half(), h.half())
    with pytest.raises(TypeError, match="of one dtype"):
        ops.silhouette_dist_sums(x, onehot.float())


MU_BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # tests/test_kernels.py bf16 MU tolerance
SUMS_BF16_TOL = dict(rtol=5e-2, atol=5e-1)  # tests/test_kernels.py bf16 distance tolerance


def _fp64_err(got, want64) -> float:
    return float((got.double() - want64).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "lanes,n,m,k", [(32, 1000, 1100, 16), (8, 1000, 1100, 16), (1, 40, 24, 5), (3, 70, 50, 33), (2, 40, 30, 130)]
)
def test_mu_bf16_kernels_match_plain(lanes, n, m, k):
    """bf16 V, W and H: the bf16 kernel against the plain version at the
    reference's bf16 tolerance, its float64 error at most twice the plain
    version's, masked components exactly zero, a repeat bitwise, and only
    the bf16 kernel launched."""
    dev = card()
    v, w, h = (t.bfloat16() for t in _mu_problem(dev, k, lanes, n, m, k, dead=2))
    for fn, plain in ((ops.mu_update_h, ref.mu_update_h), (ops.mu_update_w, ref.mu_update_w)):
        ops.reset_launch_counts()
        got = fn(v, w, h)
        counts = ops.launch_counts()
        assert counts[ops.bf16_name(fn)] == 1 and counts[fn.__name__] == 0
        want = plain(v, w, h)
        assert got.dtype == want.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), **MU_BF16_TOL)
        want64 = plain(v.double(), w.double(), h.double())
        assert _fp64_err(got, want64) <= 2 * _fp64_err(want, want64)
        assert torch.equal(got, fn(v, w, h))
    assert float(ops.mu_update_h(v, w, h)[:, -2:, :].abs().max()) == 0.0
    assert float(ops.mu_update_w(v, w, h)[:, :, -2:].abs().max()) == 0.0


class _Spy:
    """The nmf_update library, recording the entry point of each launch."""

    def __init__(self, lib):
        self.lib, self.names = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def launch(*args):
            self.names.append(name)
            return fn(*args)
        return launch


# (L, n, m, k) of the bf16 H-update: each rank bucket (1, 16, 17, 32, 64,
# 128), the lane counts of the executors (32 batched, 8 elastic, 4 threads,
# 1 one fit), split units with ragged n and m (at L 4, n 129 and m 257: the
# 2-byte copies of an odd row), n = 1, an odd m with k 1, and k 129 (the
# any-rank route)
MU_BF16_H_SHAPES = [
    (2, 300, 520, 1), (4, 1000, 1100, 16), (2, 300, 520, 17), (2, 300, 520, 32), (2, 300, 520, 64),
    (2, 300, 520, 128), (32, 1000, 1100, 16), (8, 1000, 1100, 16), (1, 1000, 1100, 16), (4, 129, 257, 13),
    (3, 1, 1100, 16), (4, 1000, 255, 1), (2, 300, 320, 129),
]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n,m,k", MU_BF16_H_SHAPES)
def test_mu_bf16_h_update_takes_the_tiled_kernel_up_to_128(monkeypatch, lanes, n, m, k):
    """bf16 V, W and H: the H-update through the tiled, planned kernel up to
    rank 128 (the any-rank one above), at the reference's bf16 tolerance,
    its float64 error at most twice the plain version's, masked ranks
    exactly zero, five calls bitwise equal (split units too), only the
    bf16 kernel counted, and the split units' counters left at zero."""
    dev = card()
    dead = min(2, k - 1)
    v, w, h = (t.bfloat16() for t in _mu_problem(dev, lanes + n + m + k, lanes, n, m, k, dead=dead))
    spy = _Spy(build.load("nmf_update"))
    monkeypatch.setattr(build, "load", lambda name: spy)
    ops.reset_launch_counts()
    got = ops.mu_update_h(v, w, h)
    counts = ops.launch_counts()
    assert counts["mu_update_h[bf16]"] == 1 and counts["mu_update_h"] == 0
    assert spy.names == ["mu_update_h_bf16" if k <= ops.MU_TILED_MAX_RANK else "mu_update_h_bf16_any"]
    want = ref.mu_update_h(v, w, h)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **MU_BF16_TOL)
    want64 = ref.mu_update_h(v.double(), w.double(), h.double())
    assert _fp64_err(got, want64) <= 2 * _fp64_err(want, want64)
    if dead:
        assert float(got[:, k - dead:, :].abs().max()) == 0.0
    for _ in range(4):
        assert torch.equal(ops.mu_update_h(v, w, h), got)
    torch.cuda.synchronize()
    counters = [held[1] for held, _ in ops._scratch.args.values() if held]
    assert all(int(c.abs().sum()) == 0 for c in counters)


# (L, n, m, k) of the bf16 W-update: each rank bucket (1, 16, 17, 32, 64,
# 128), the lane counts of the executors (32 batched, 8 elastic, 4 threads,
# 1 one fit) at 1000 x 1100, split units with ragged n and odd m (at L 4, n
# 129 and m 257: a row's plain 2-byte stores), m a multiple of 8 (16-byte
# copies or tensor boxes), n = 1, m below one stage, and k 129 (the any-rank
# route)
MU_BF16_W_SHAPES = [
    (2, 300, 520, 1), (4, 1000, 1100, 16), (2, 300, 520, 17), (2, 300, 520, 32), (2, 300, 520, 64),
    (2, 300, 520, 128), (32, 1000, 1100, 16), (8, 1000, 1100, 16), (1, 1000, 1100, 16), (4, 129, 257, 13),
    (4, 1000, 256, 16), (3, 1, 1100, 16), (4, 200, 40, 5), (2, 300, 320, 129),
]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n,m,k", MU_BF16_W_SHAPES)
def test_mu_bf16_w_update_takes_the_tiled_kernel_up_to_128(monkeypatch, lanes, n, m, k):
    """bf16 V, W and H: the W-update through the tiled, planned kernel up to
    rank 128 (the any-rank one above), at the reference's bf16 tolerance,
    its float64 error at most twice the plain version's, masked ranks
    exactly zero, five calls bitwise equal (split units too), only the
    bf16 kernel counted, and the split units' counters left at zero."""
    dev = card()
    dead = min(2, k - 1)
    v, w, h = (t.bfloat16() for t in _mu_problem(dev, lanes + n + m + k, lanes, n, m, k, dead=dead))
    spy = _Spy(build.load("nmf_update"))
    monkeypatch.setattr(build, "load", lambda name: spy)
    ops.reset_launch_counts()
    got = ops.mu_update_w(v, w, h)
    counts = ops.launch_counts()
    assert counts["mu_update_w[bf16]"] == 1 and counts["mu_update_w"] == 0
    assert spy.names == ["mu_update_w_bf16" if k <= ops.MU_TILED_MAX_RANK else "mu_update_w_bf16_any"]
    want = ref.mu_update_w(v, w, h)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **MU_BF16_TOL)
    want64 = ref.mu_update_w(v.double(), w.double(), h.double())
    assert _fp64_err(got, want64) <= 2 * _fp64_err(want, want64)
    if dead:
        assert float(got[:, :, k - dead:].abs().max()) == 0.0
    for _ in range(4):
        assert torch.equal(ops.mu_update_w(v, w, h), got)
    torch.cuda.synchronize()
    counters = [held[1] for held, _ in ops._scratch.args.values() if held]
    assert all(int(c.abs().sum()) == 0 for c in counters)


# (b, points, k, d) of the bf16 silhouette held to the fp32 kernel's bits:
# the threads path's 52 points, RESCALk's 12 and 33, the batched wave (b 8
# of 64) and the elastic lane (b 1 of 64), a ragged d, an odd d (2-byte
# staging), d below one cluster block, the thin limit of 128 points and 129
# (the general path)
SUMS_BF16_BITS = [
    (1, 52, 13, 1000), (1, 12, 4, 1000), (1, 33, 11, 1000), (8, 64, 16, 1000), (1, 64, 16, 1000),
    (8, 64, 16, 999), (2, 40, 7, 997), (2, 30, 5, 20), (2, 128, 32, 1000), (2, 129, 32, 1000),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,points,k,d", SUMS_BF16_BITS)
def test_dist_sums_bf16_gives_the_fp32_kernels_bits_on_widened_operands(b, points, k, d):
    """On both paths the bf16 kernel's sums are the fp32 kernel's on the
    same operands widened to fp32, bit for bit (2-D at b = 1, the batched
    entry otherwise; x = y, and once y apart), and only the bf16 kernel
    counts the bf16 call."""
    dev = card()
    x, onehot = (t[:, :points].bfloat16().contiguous() for t in _pooled(dev, b, -(-points // k), k, [k] * b, d))
    fn = ops.silhouette_dist_sums if b == 1 else ops.silhouette_dist_sums_batched
    args = (x[0], onehot[0]) if b == 1 else (x, onehot)
    ops.reset_launch_counts()
    got = fn(*args)
    counts = ops.launch_counts()
    assert counts[ops.bf16_name(fn)] == 1 and counts[fn.__name__] == 0
    assert torch.equal(got, fn(*(a.float() for a in args)))
    torch.testing.assert_close(got, ref.silhouette_dist_sums(*args), **SUMS_BF16_TOL)
    y = torch.flip(args[0], dims=[-2]).contiguous()  # y apart from x: the x rows staged on their own
    assert torch.equal(fn(args[0], args[1], y), fn(args[0].float(), args[1].float(), y.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,k,d", [(1, 4, 13, 1000), (8, 4, 16, 1000), (2, 3, 11, 999), (2, 2, 130, 17)])
def test_dist_sums_bf16_kernel_matches_plain(b, p, k, d):
    """Pooled near-duplicate columns at bf16: float32 sums within the
    reference's bf16 distance tolerance of the plain version, the float64
    error at most twice the plain version's, a repeat bitwise, and only the
    bf16 kernel launched (2-D at b = 1, the batched entry otherwise)."""
    dev = card()
    gen = torch.Generator(device=dev).manual_seed(b * k + d)
    base = torch.rand((b, 1, d, k), device=dev, generator=gen)
    cols = base + 0.01 * torch.rand((b, p, d, k), device=dev, generator=gen)
    x = (cols / cols.norm(dim=2, keepdim=True)).transpose(2, 3).reshape(b, p * k, d).bfloat16().contiguous()
    onehot = torch.nn.functional.one_hot(torch.arange(k, device=dev).repeat(p), k).bfloat16().expand(
        b, p * k, k).contiguous()
    fn, args = (ops.silhouette_dist_sums, (x[0], onehot[0])) if b == 1 else (ops.silhouette_dist_sums_batched,
                                                                          (x, onehot))
    ops.reset_launch_counts()
    got = fn(*args)
    counts = ops.launch_counts()
    assert counts[ops.bf16_name(fn)] == 1 and counts[fn.__name__] == 0
    want = ref.silhouette_dist_sums(*args)
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, **SUMS_BF16_TOL)
    want64 = ref.silhouette_dist_sums(*(a.double() for a in args))
    assert _fp64_err(got, want64) <= 2 * _fp64_err(want, want64)
    assert torch.equal(got, fn(*args))


@pytest.mark.cuda
def test_bf16_nmfk_launches_the_bf16_kernels_only():
    """A bf16 batched NMFk score on the card runs the bf16 MU and silhouette
    kernels and none of the float32 ones; a float32 one the reverse."""
    from repro_torch.factorization.nmfk import nmfk_score_batched
    from repro_torch.factorization.synthetic import nmf_data

    dev = card()
    for dtype in (torch.bfloat16, torch.float32):
        v, _, _ = nmf_data(96, 104, 5, seed=0, device=dev, dtype=dtype)
        ops.reset_launch_counts()
        sc = nmfk_score_batched(v, [4, 5, 6], k_pad=6, n_perturbs=2, nmf_iters=20)
        counts = ops.launch_counts()
        assert sc.rel_error.dtype == dtype and sc.min_silhouette.dtype == torch.float32
        bf16 = {name: counts[ops.bf16_name(getattr(ops, name))] for name in
                ("mu_update_h", "mu_update_w", "silhouette_dist_sums_batched")}
        fp32 = {name: counts[name] for name in bf16}
        on, off = (bf16, fp32) if dtype == torch.bfloat16 else (fp32, bf16)
        assert min(on.values()) >= 1 and max(off.values()) == 0, counts


@pytest.mark.cuda
def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    dev = card()
    q = torch.ones((1, 4, 16, 32), device=dev)
    k = torch.ones((1, 2, 16, 32), device=dev)
    with pytest.raises(TypeError, match="float16 is queued"):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError, match="of one dtype"):
        ops.flash_attention(q.bfloat16(), k, k)
    with pytest.raises(ValueError, match="unit stride"):
        ops.flash_attention(q.transpose(2, 3), k.transpose(2, 3), k.transpose(2, 3), causal=False)
    with pytest.raises(ValueError, match=r"Lq \+ q_offset <= Lk"):
        ops.flash_attention(q[:, :, :8], k, k, q_offset=9)
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


@pytest.mark.cuda
@pytest.mark.parametrize("warm_start", [True, False])
def test_elastic_plane_on_the_card_matches_the_cpu(warm_start):
    """chip_smoke.py's phase-4 size: ks 2..8 drained at tol 0 (96 x 104,
    k_pad 8, 4 perturbations, 120 sweeps, chunks of 25), the card's draws
    on both devices. Scores within 2e-3 (120 sweeps of kernel vs plain
    arithmetic, then the greedy scorer: chip_smoke.NMFK_SIL_ATOL), equal
    sweep counts and warm-start hits, the kernels launched on the card."""
    from repro_torch.factorization.planes import NMFkElasticPlane
    from repro_torch.factorization.synthetic import nmf_data
    from repro_torch.random import Draws, seeded_draws

    dev = card()
    n, m, p, ks = 96, 104, 4, list(range(2, 9))
    v, _, _ = nmf_data(n, m, 5, seed=0, device=dev)
    card_draws = seeded_draws(0, n, m, p, 0.015, dev)

    def cpu_draws(k, k_draw):
        return Draws(*(t.cpu() for t in card_draws(k, k_draw)))

    planes, scores = [], []
    for vv, draws in ((v, card_draws), (v.cpu(), cpu_draws)):
        plane = NMFkElasticPlane(vv, n_perturbs=p, nmf_iters=120, k_pad=8, tol=0.0, chunk=25,
                                 warm_start=warm_start, draws=draws)
        for k in ks:
            plane.submit(k)
        ops.reset_launch_counts()
        got = {}
        while not plane.idle:
            got.update(plane.tick())
        if vv.is_cuda:
            launches = ops.launch_counts()
        planes.append(plane)
        scores.append(got)
    assert sorted(scores[0]) == sorted(scores[1]) == ks
    np.testing.assert_allclose([scores[0][k] for k in ks], [scores[1][k] for k in ks], rtol=0, atol=2e-3)
    card_plane, cpu_plane = planes
    for field in ("sweeps_run", "sweeps_saved", "sweeps_fixed_total"):
        assert getattr(card_plane, field) == getattr(cpu_plane, field)
    assert card_plane.warm_cache.hits == cpu_plane.warm_cache.hits
    assert (card_plane.warm_cache.hits > 0) == warm_start
    assert min(launches["mu_update_h"], launches["mu_update_w"], launches["silhouette_dist_sums_batched"]) >= 1


@pytest.mark.cuda
def test_rescalk_score_on_the_card_matches_the_cpu():
    """RESCALk at 96 entities (3 relations, k_true 4, P 3, 150 sweeps), the
    same X and draws on both devices: silhouettes within 2e-3 and mean
    errors within 1e-3 relative (chip_smoke.RESCAL_SIL_ATOL / RESCAL_RTOL),
    one silhouette kernel launch a k on the card."""
    from repro_torch.factorization.rescal import rescalk_score
    from repro_torch.factorization.synthetic import rescal_data
    from repro_torch.random import RESCALDraws, seeded_rescal_draws

    dev = card()
    x, _, _ = rescal_data(n_entities=96, n_relations=3, k_true=4, noise=0.01, seed=0, device="cpu")
    source = seeded_rescal_draws(0, 96, 3, 3, 0.015, "cpu")
    for k in (2, 4, 6):
        d = source(k)
        before = ops.silhouette_dist_sums.launches
        sil, err = rescalk_score(x.to(dev), k, RESCALDraws(*(t.to(dev) for t in d)), iters=150)
        assert ops.silhouette_dist_sums.launches == before + 1
        sil_cpu, err_cpu = rescalk_score(x, k, d, iters=150)
        assert abs(float(sil) - float(sil_cpu)) <= 2e-3
        np.testing.assert_allclose(float(err), float(err_cpu), rtol=1e-3)


@pytest.mark.cuda
def test_distributed_nmf_on_a_one_rank_nccl_group_matches_the_cpu():
    """``distributed_nmf`` over a one-rank NCCL group on the card against the
    CPU without a group, same draws (rtol 1e-3); pipelined is sync bit for
    bit at one rank; one MU W-update launch a sweep; the groups are gone
    after ``local_groups`` exits."""
    import torch.distributed as dist

    from repro_torch.factorization.distributed import distributed_nmf, local_groups
    from repro_torch.factorization.synthetic import nmf_data
    from repro_torch.random import init_draws, seeded_generator

    dev = card()
    v, _, _ = nmf_data(96, 104, 5, seed=0, device="cpu")
    w, h = init_draws(seeded_generator(1, "cpu"), 96, 104, 5)
    with local_groups(dev, 1) as (group,):
        assert dist.get_backend(group) == "nccl"
        before = ops.mu_update_w.launches
        sync = distributed_nmf(v.to(dev), 5, w.to(dev), h.to(dev), group, iters=60)
        assert ops.mu_update_w.launches == before + 60
        pipe = distributed_nmf(v.to(dev), 5, w.to(dev), h.to(dev), group, iters=60, comm="pipelined")
    assert not dist.is_initialized()
    for a, b in zip(sync, pipe):
        assert torch.equal(a, b)
    cpu = distributed_nmf(v, 5, w, h, None, iters=60)
    for got, want in zip(sync, cpu):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-6)


@pytest.mark.cuda
def test_cuda_tensors_on_a_gloo_group_raise():
    """The backend follows the tensors' device and is never switched: a
    gloo group with CUDA tensors raises."""
    import torch.distributed as dist

    from repro_torch.factorization.distributed import distributed_nmf, local_groups

    dev = card()
    with local_groups("cpu", 1) as (group,):
        assert dist.get_backend(group) == "gloo"
        v = torch.rand((8, 6), device=dev)
        with pytest.raises(ValueError, match="nccl"):
            distributed_nmf(v, 2, torch.rand((8, 2), device=dev), torch.rand((2, 6), device=dev), group, iters=2)
