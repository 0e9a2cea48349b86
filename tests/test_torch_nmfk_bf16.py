"""The port's NMFk search at bf16 against the reference's bf16 run.

V 64 x 72 (the reference's ``nmf_data`` at bf16, k_true 3), k 2..4, 2
perturbations, 30 sweeps. The reference's fits and scores stay bf16 when V
is bf16: it draws its perturbations and inits at V's dtype. On its kernel
route (``use_kernel=True``, the TPU kernels, here in interpret mode) the MU
update forms its Gram product in bf16 and everything else in fp32 with one
rounding, and the silhouette sums are fp32 from bf16 operands. Every route
of the port computes that arithmetic, so:

- the plain versions at bf16 are held to the Pallas kernels in interpret
  mode at the reference's own bf16 tolerances (MU rtol = atol = 2e-2,
  distances rtol 5e-2 / atol 5e-1, ``tests/test_kernels.py``);
- a score at k 3 is held to the reference's kernel route built from its
  own pieces (its Pallas MU and silhouette kernels) at ``ROUTE_SIL_ATOL``
  on the silhouettes and two bf16 ulps on ``rel_error``; and to the
  reference's ``nmfk_score`` / ``nmfk_score_batched`` at
  ``use_kernel=True``, whose fits take the plain MU (each op rounded to
  bf16), within twice the reference's own bf16-vs-fp32 gap (floor
  ``GAP_FLOOR``; two bf16 ulps on ``rel_error``);
- the search's k_optimal is the reference's on threads, batched and
  elastic (k_pad 4: masked fits at bf16), and the elastic plane's sweeps
  run and saved are the reference's.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from _torch_reference import ensemble_draws, reference_draw_source  # noqa: E402
from repro.factorization.planes import NMFkBatchPlane as JBatchPlane  # noqa: E402
from repro.factorization.planes import NMFkElasticPlane as JElasticPlane  # noqa: E402
from repro.factorization.synthetic import nmf_data as jnmf_data  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.convert import draws_from_reference, leaf_tensor  # noqa: E402
from repro_torch.core.scoring import cluster_dist_sums  # noqa: E402
from repro_torch.factorization.planes import NMFkBatchPlane, NMFkElasticPlane  # noqa: E402
from repro_torch.factorization.synthetic import nmf_data  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.random import Draws, lane_generator, make_draws, seeded_draws  # noqa: E402

jnmf = importlib.import_module("repro.factorization.nmf")
jnmfk = importlib.import_module("repro.factorization.nmfk")
tnmfk = importlib.import_module("repro_torch.factorization.nmfk")

KEY = jax.random.PRNGKey(0)
N, M, K_TRUE, P, ITERS, EPS = 64, 72, 3, 2, 30, 0.015
K, K_PAD, K_RANGE, THRESHOLD, CHUNK = 3, 4, (2, 4), 0.9, 10
BF16 = jnp.bfloat16
MU_TOL = dict(rtol=2e-2, atol=2e-2)  # tests/test_kernels.py::_tol at bf16
SUMS_TOL = dict(rtol=5e-2, atol=5e-1)  # tests/test_kernels.py::test_pairwise at bf16
ROUTE_SIL_ATOL = 2e-3  # the port against the reference's kernel route: fp32 sums in other orders
ERR_RTOL = 2.0**-6  # two bf16 ulps anywhere in a binade: rel_error is a bf16 norm ratio
GAP_RATIO, GAP_FLOOR = 2.0, 2e-2  # against the reference's plain-MU route, as chip_smoke.py gates the card
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    """The reference's bf16 V and its float32 copy (numpy), and the port's tensor of it."""
    v16, _, _ = jnmf_data(KEY, n=N, m=M, k_true=K_TRUE, dtype=BF16)
    return v16, v16.astype(jnp.float32), leaf_tensor(np.asarray(v16), CPU)


def _draws(k: int, k_draw: int) -> Draws:
    return draws_from_reference(*ensemble_draws(jax.random.fold_in(KEY, k), N, M, k_draw, P, EPS, BF16), CPU)


def _t(a) -> torch.Tensor:
    return leaf_tensor(np.asarray(a), CPU)


# -----------------------------------------------------------------------------
# the fault: a bf16 V was perturbed by float32 noise and fitted at float32
# -----------------------------------------------------------------------------
def test_bf16_v_is_fitted_at_bf16_with_draws_at_its_dtype(data, monkeypatch):
    """The reference's bf16 V and draws, carried across: every MU half-sweep
    sees a bf16 perturbed V, W and H, and the error is a bf16 norm ratio.
    The evaluator's own draws are at V's dtype too."""
    _, _, v = data
    seen = []
    for name in ("mu_update_h", "mu_update_w"):
        plain = getattr(ref, name)

        def spy(vv, w, h, plain=plain):
            seen.append((vv.dtype, w.dtype, h.dtype))
            return plain(vv, w, h)

        monkeypatch.setattr(ref, name, spy)
    sc = tnmfk.nmfk_score(v, K, _draws(K, K), nmf_iters=ITERS)
    assert len(seen) == 2 * ITERS and set(seen) == {(torch.bfloat16,) * 3}
    assert sc.rel_error.dtype == torch.bfloat16
    assert sc.min_silhouette.dtype == sc.mean_silhouette.dtype == torch.float32  # fp32 distance sums
    scored = []
    score = tnmfk.nmfk_score
    monkeypatch.setattr(tnmfk, "nmfk_score", lambda *a, **kw: scored.append(score(*a, **kw)) or scored[-1])
    evaluate = tnmfk.make_nmfk_evaluator(v, n_perturbs=P, nmf_iters=ITERS)
    seen.clear()
    evaluate(K)
    assert set(seen) == {(torch.bfloat16,) * 3} and scored[0].rel_error.dtype == torch.bfloat16
    assert {t.dtype for t in seeded_draws(0, N, M, P, EPS, CPU, torch.bfloat16)(K, K)} == {torch.bfloat16}


@pytest.mark.parametrize("entry", ["nmfk_score", "nmfk_score_batched", "elastic_plane", "elastic_chunk"])
def test_draws_of_another_dtype_raise(data, entry):
    _, _, v = data
    fp32 = seeded_draws(0, N, M, P, EPS, CPU)  # float32 draws against a bf16 V
    with pytest.raises(TypeError, match="dtype"):
        if entry == "nmfk_score":
            tnmfk.nmfk_score(v, K, fp32(K, K), nmf_iters=ITERS)
        elif entry == "nmfk_score_batched":
            tnmfk.nmfk_score_batched(v, [K], k_pad=K_PAD, n_perturbs=P, nmf_iters=ITERS, draws=fp32)
        elif entry == "elastic_plane":
            NMFkElasticPlane(v, n_perturbs=P, nmf_iters=ITERS, k_pad=K_PAD, draws=fp32).submit(K)
        else:
            d = fp32(K, K_PAD)
            tnmfk.elastic_chunk(v[None].clone(), d.w[:1], d.h[:1], torch.tensor([K]), torch.tensor([1]), K_PAD, CHUNK)


# -----------------------------------------------------------------------------
# the plain versions at bf16 against the Pallas kernels in interpret mode
# -----------------------------------------------------------------------------
def _mu_operands(n: int, m: int, k: int):
    kv, kw, kh = jax.random.split(jax.random.fold_in(KEY, n * m + k), 3)
    return (jax.random.uniform(kv, (n, m), BF16), jax.random.uniform(kw, (n, k), BF16, 0.1, 1.0),
            jax.random.uniform(kh, (k, m), BF16, 0.1, 1.0))


@pytest.mark.parametrize("update", ["h", "w"])
def test_mu_update_bf16_matches_the_pallas_kernel(update):
    v, w, h = _mu_operands(100, 90, 7)  # ragged: the wrapper pads n, m and k
    got = getattr(ops, f"mu_update_{update}")(_t(v), _t(w), _t(h))
    want = getattr(jops, f"mu_update_{update}")(v, w, h, interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == BF16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **MU_TOL)


def test_mu_update_bf16_keeps_masked_components_exactly_zero():
    v, w, h = (_t(a) for a in _mu_operands(40, 36, 4))
    w[:, -1] = 0.0
    h[-1, :] = 0.0
    assert float(ops.mu_update_w(v, w, h)[:, -1].abs().max()) == 0.0
    assert float(ops.mu_update_h(v, w, h)[-1, :].abs().max()) == 0.0


def _pooled(b: int, points: int, d: int, k: int):
    kx, kl = jax.random.split(jax.random.fold_in(KEY, b * points + d))
    x = jax.random.uniform(kx, (b, points, d), BF16)
    onehot = jax.nn.one_hot(jax.random.randint(kl, (b, points), 0, k), k, dtype=BF16)
    return x, onehot


@pytest.mark.parametrize("batched", [False, True])
def test_silhouette_sums_bf16_match_the_pallas_kernel(batched):
    x, onehot = _pooled(3 if batched else 1, 20, 17, 4)
    if batched:
        got = ops.silhouette_dist_sums_batched(_t(x), _t(onehot))
        want = jops.silhouette_dist_sums_batched(x, onehot, interpret=True)
    else:
        got = ops.silhouette_dist_sums(_t(x[0]), _t(onehot[0]))
        want = jops.silhouette_dist_sums(x[0], onehot[0], interpret=True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32  # fp32 sums, as the TPU kernel writes
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUMS_TOL)
    # the blocked CPU tier upcasts as the dense one does
    x3, o3 = _t(x), _t(onehot)
    torch.testing.assert_close(cluster_dist_sums(x3, o3, block_rows=7), cluster_dist_sums(x3, o3))


# -----------------------------------------------------------------------------
# float32 keeps its bits: each function against its expression before bf16
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("what", ["mu_h", "mu_w", "sums", "nmf_data", "draws"])
def test_float32_keeps_its_bits(what):
    gen = torch.Generator().manual_seed(4)
    v, w, h = torch.rand((2, 30, 26), generator=gen), torch.rand((2, 30, 5), generator=gen), torch.rand(
        (2, 5, 26), generator=gen)
    if what == "mu_h":
        wt = w.transpose(-1, -2)
        assert torch.equal(ref.mu_update_h(v, w, h), h * (wt @ v) / (wt @ w @ h + 1e-9))
    elif what == "mu_w":
        ht = h.transpose(-1, -2)
        assert torch.equal(ref.mu_update_w(v, w, h), w * (v @ ht) / (w @ (h @ ht) + 1e-9))
    elif what == "sums":
        onehot = torch.nn.functional.one_hot(torch.arange(30) % 5, 5).float()
        assert torch.equal(ref.silhouette_dist_sums(w[0], onehot), torch.sqrt(ref.pairwise_sq_dists(w[0])) @ onehot)
        assert torch.equal(cluster_dist_sums(w[0], onehot), torch.sqrt(ref.pairwise_sq_dists(w[0])) @ onehot)
    elif what == "nmf_data":
        got = nmf_data(40, 44, 4, seed=3, device="cpu")
        g = torch.Generator().manual_seed(3)
        w_bg = torch.empty((40, 4)).uniform_(0.0, 0.02, generator=g)
        h_bg = torch.empty((4, 44)).uniform_(0.0, 0.02, generator=g)
        w_sig = torch.nn.functional.one_hot(torch.arange(40) // 10, 4).float()
        h_sig = torch.nn.functional.one_hot(torch.arange(44) // 11, 4).float().T
        w_t = w_bg + w_sig * torch.abs(1.0 + 0.1 * torch.randn((40, 4), generator=g))
        h_t = h_bg + h_sig * torch.abs(1.0 + 0.1 * torch.randn((4, 44), generator=g))
        v_t = w_t @ h_t + 0.01 * torch.empty((40, 44)).uniform_(0.0, 1.0, generator=g)
        assert all(torch.equal(a, b) for a, b in zip(got, (v_t, w_t, h_t)))
    else:
        got = make_draws(lane_generator(0, 5, CPU), 30, 26, 5, 2, EPS)
        g = lane_generator(0, 5, CPU)
        noise = torch.empty((2, 30, 26)).uniform_(1.0 - EPS, 1.0 + EPS, generator=g)
        w0 = torch.empty((2, 30, 5)).uniform_(0.1, 1.0, generator=g)
        h0 = torch.empty((2, 5, 26)).uniform_(0.1, 1.0, generator=g)
        assert all(torch.equal(a, b) and a.dtype == torch.float32 for a, b in zip(got, (noise, w0, h0)))


# -----------------------------------------------------------------------------
# the synthetic data at bf16
# -----------------------------------------------------------------------------
def test_nmf_data_bf16_has_the_reference_block_structure_and_dtype(data):
    """The port's draws are its own, so the block structure is compared:
    each row of W and column of H peaks in its planted block, as in the
    reference's bf16 data, and V's block means agree within 0.05."""
    v16, _, _ = data
    jv, jw, jh = (np.asarray(a, np.float32) for a in jnmf_data(KEY, n=N, m=M, k_true=K_TRUE, dtype=BF16))
    v, w, h = nmf_data(N, M, K_TRUE, seed=0, device="cpu", dtype=torch.bfloat16)
    assert v.dtype == w.dtype == h.dtype == torch.bfloat16 and v16.dtype == BF16
    np.testing.assert_array_equal(w.float().argmax(1).numpy(), jw.argmax(1))
    np.testing.assert_array_equal(h.float().argmax(0).numpy(), jh.argmax(0))
    rows, cols = jw.argmax(1), jh.argmax(0)

    def block_means(x):
        return np.array([[x[rows == i][:, cols == j].mean() for j in range(K_TRUE)] for i in range(K_TRUE)])

    np.testing.assert_allclose(block_means(v.float().numpy()), block_means(jv), atol=0.05)
    assert float(v.min()) >= 0.0


# -----------------------------------------------------------------------------
# NMFk scores at one k against the reference
# -----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(data):
    """At k = K (no padding, so the scalar and batched draws coincide): the
    reference's kernel arithmetic from its own pieces (its fit with the
    Pallas MU kernel, then its pooled score with the Pallas silhouette
    kernel), its ``nmfk_score`` and ``nmfk_score_batched`` at bf16 on
    ``use_kernel=True``, and the score at float32 (whose routes agree to
    1e-4, so the plain one) for the bf16-vs-fp32 gap."""
    v16, v32, _ = data
    kw = dict(n_perturbs=P, nmf_iters=ITERS, epsilon=EPS)
    kp, kf = jax.random.split(jax.random.fold_in(KEY, K))

    def fit(pk, fk):
        res = jnmf.nmf(jnmfk._perturb(pk, v16, EPS), K, fk, iters=ITERS, use_kernel=True)
        return res.w, res.rel_error

    w_all, errs = jax.vmap(fit)(jax.random.split(kp, P), jax.random.split(kf, P))
    key = jax.random.fold_in(KEY, K)
    fp32 = jnmfk.nmfk_score(v32, K, key, **kw)  # the batched lane at k_pad == k is the scalar score

    def lane(sc):
        return type(sc)(*(f[0] for f in sc))

    return {
        "route": jnmfk._pooled_w_score(w_all, errs, K, K, P, use_kernel=True),
        "scalar": (jnmfk.nmfk_score(v16, K, key, use_kernel=True, **kw), fp32),
        "batched": (lane(jnmfk.nmfk_score_batched(v16, [K], KEY, k_pad=K, use_kernel=True, **kw)), fp32),
    }


def _hold(got, route, reference, reference_fp32):
    for field in ("min_silhouette", "mean_silhouette", "rel_error"):
        g, r0 = float(getattr(got, field)), float(getattr(route, field))
        r, r32 = float(getattr(reference, field)), float(getattr(reference_fp32, field))
        if field == "rel_error":
            assert abs(g - r0) <= ERR_RTOL * abs(r0), (field, g, r0)
            assert abs(g - r) <= max(GAP_RATIO * abs(r - r32), ERR_RTOL * abs(r)), (field, g, r, r32)
        else:
            assert abs(g - r0) <= ROUTE_SIL_ATOL, (field, g, r0)
            assert abs(g - r) <= max(GAP_RATIO * abs(r - r32), GAP_FLOOR), (field, g, r, r32)


def test_nmfk_score_bf16_matches_the_reference_kernel_route(data, reference):
    got = tnmfk.nmfk_score(data[2], K, _draws(K, K), nmf_iters=ITERS)
    assert got.min_silhouette.dtype == torch.float32 and got.rel_error.dtype == torch.bfloat16
    _hold(got, reference["route"], *reference["scalar"])


def test_nmfk_score_batched_bf16_matches_the_reference_kernel_route(data, reference):
    got = tnmfk.nmfk_score_batched(data[2], [K], k_pad=K, n_perturbs=P, nmf_iters=ITERS, epsilon=EPS,
                                   draws=reference_draw_source(KEY, N, M, P, EPS, BF16))
    _hold(type(got)(*(f[0] for f in got)), reference["route"], *reference["batched"])


# -----------------------------------------------------------------------------
# the bf16 search on each executor
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("executor", ["threads", "batched", "elastic"])
def test_bf16_search_k_optimal_is_the_reference(data, executor):
    v16, _, v = data
    source = reference_draw_source(KEY, N, M, P, EPS, BF16)
    kw = dict(n_perturbs=P, nmf_iters=ITERS, epsilon=EPS)
    if executor == "threads":
        want = jcore.binary_bleed_search(jnmfk.make_nmfk_evaluator(v16, KEY, use_kernel=True, **kw), K_RANGE,
                                         THRESHOLD, num_resources=2)
        got = tcore.binary_bleed_search(tnmfk.make_nmfk_evaluator(v, draws=source, **kw), K_RANGE, THRESHOLD,
                                        num_resources=2)
    elif executor == "batched":
        want = jcore.binary_bleed_search(JBatchPlane(v16, KEY, k_pad=K_PAD, use_kernel=True, **kw), K_RANGE,
                                         THRESHOLD, executor="batched")
        got = tcore.binary_bleed_search(NMFkBatchPlane(v, k_pad=K_PAD, draws=source, **kw), K_RANGE, THRESHOLD,
                                        executor="batched")
    else:  # the tol gate reads bf16 errors on both sides: lanes retire at the same chunks
        jplane = JElasticPlane(v16, KEY, k_pad=K_PAD, chunk=CHUNK, use_kernel=True, **kw)
        want = jcore.binary_bleed_search(jplane, K_RANGE, THRESHOLD, executor="elastic")
        plane = NMFkElasticPlane(v, k_pad=K_PAD, chunk=CHUNK, draws=source, **kw)
        got = tcore.binary_bleed_search(plane, K_RANGE, THRESHOLD, executor="elastic")
        assert plane.sweeps_run + plane.sweeps_saved == plane.sweeps_fixed_total
        assert (plane.sweeps_run, plane.sweeps_saved) == (jplane.sweeps_run, jplane.sweeps_saved)
    assert got.k_optimal == want.k_optimal == K_TRUE
