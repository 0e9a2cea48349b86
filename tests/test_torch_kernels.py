"""Port kernels: the plain versions vs the JAX reference.

On the CPU the port's wrappers run their plain versions; those are held
against the reference's Pallas kernels (interpret mode) and its jnp oracles
at ragged shapes with masked components, at the reference's own
tolerances (``tests/test_kernels.py``). The CUDA kernels themselves are
held against the plain versions on a card in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402

MU_TOL = dict(rtol=3e-5, atol=3e-5)  # tests/test_kernels.py fp32 MU tolerance
SUMS_TOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_kernels.py fp32 distance tolerance


def _mu_problem(seed: int, shape_lead: tuple, n: int, m: int, k: int, dead: int = 1):
    """Nonnegative V, W, H with the last ``dead`` components masked to zero."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(0.0, 1.0, shape_lead + (n, m)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, shape_lead + (n, k)).astype(np.float32)
    h = rng.uniform(0.1, 1.0, shape_lead + (k, m)).astype(np.float32)
    if dead:
        w[..., :, k - dead:] = 0.0
        h[..., k - dead:, :] = 0.0
    return v, w, h


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


MU_SHAPES = [(40, 24, 5), (64, 48, 5), (100, 90, 7), (33, 70, 13)]


@pytest.mark.parametrize("n,m,k", MU_SHAPES)
def test_mu_update_h_matches_reference(n, m, k):
    v, w, h = _mu_problem(n + m + k, (), n, m, k)
    got = ops.mu_update_h(*_t(v, w, h)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.mu_update_h(v, w, h, interpret=True)), **MU_TOL)
    np.testing.assert_allclose(got, np.asarray(jref.mu_update_h_ref(v, w, h)), **MU_TOL)


@pytest.mark.parametrize("n,m,k", MU_SHAPES)
def test_mu_update_w_matches_reference(n, m, k):
    v, w, h = _mu_problem(n * m + k, (), n, m, k)
    got = ops.mu_update_w(*_t(v, w, h)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.mu_update_w(v, w, h, interpret=True)), **MU_TOL)
    np.testing.assert_allclose(got, np.asarray(jref.mu_update_w_ref(v, w, h)), **MU_TOL)


def test_mu_update_lane_axis_matches_per_lane_reference():
    """The leading fit axis (lanes x perturbations) is a batch of 2-D updates."""
    v, w, h = _mu_problem(3, (3,), 40, 24, 5, dead=2)
    got_h = ops.mu_update_h(*_t(v, w, h)).numpy()
    got_w = ops.mu_update_w(*_t(v, w, h)).numpy()
    for lane in range(3):
        np.testing.assert_allclose(got_h[lane], np.asarray(jref.mu_update_h_ref(v[lane], w[lane], h[lane])), **MU_TOL)
        np.testing.assert_allclose(got_w[lane], np.asarray(jref.mu_update_w_ref(v[lane], w[lane], h[lane])), **MU_TOL)


def test_mu_update_keeps_masked_components_exactly_zero():
    v, w, h = _mu_problem(5, (3,), 40, 24, 5, dead=2)
    got_h = ops.mu_update_h(*_t(v, w, h))
    got_w = ops.mu_update_w(*_t(v, w, h))
    assert float(got_h[:, -2:, :].abs().max()) == 0.0
    assert float(got_w[:, :, -2:].abs().max()) == 0.0


def _sums_problem(seed: int, lead: tuple, n: int, m: int, d: int, k: int, masked: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (n, d)).astype(np.float32)
    y = rng.normal(size=lead + (m, d)).astype(np.float32)
    labels = rng.integers(0, k, size=lead + (m,))
    onehot = np.eye(k, dtype=np.float32)[labels]
    if masked:
        onehot[..., m - masked:, :] = 0.0  # masked points contract to nothing
    return x, y, onehot


@pytest.mark.parametrize("n,m,d,k", [(40, 24, 9, 5), (32, 32, 5, 3), (70, 30, 17, 6), (8, 8, 200, 2)])
def test_dist_sums_2d_matches_reference(n, m, d, k):
    x, y, onehot = _sums_problem(n * m + d, (), n, m, d, k, masked=3)
    got = ops.silhouette_dist_sums(*_t(x, onehot, y)).numpy()
    want = np.asarray(jops.silhouette_dist_sums(x, onehot, y, interpret=True))
    np.testing.assert_allclose(got, want, **SUMS_TOL)
    np.testing.assert_allclose(got, np.asarray(jref.silhouette_dist_sums_ref(x, onehot, y)), **SUMS_TOL)


@pytest.mark.parametrize("b,n,d,k", [(3, 24, 9, 5), (2, 70, 17, 6), (4, 24, 9, 2)])
@pytest.mark.parametrize("masked", [0, 5])
def test_dist_sums_batched_matches_reference(b, n, d, k, masked):
    x, _, onehot = _sums_problem(b * n + d, (b,), n, n, d, k, masked=masked)
    got = ops.silhouette_dist_sums_batched(*_t(x, onehot)).numpy()
    want = np.asarray(jops.silhouette_dist_sums_batched(jnp.asarray(x), jnp.asarray(onehot), interpret=True))
    np.testing.assert_allclose(got, want, **SUMS_TOL)
    np.testing.assert_allclose(got, np.asarray(jref.silhouette_dist_sums_ref(x, onehot)), **SUMS_TOL)


PAIRWISE_TOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_kernels.py::test_pairwise fp32 tolerance


@pytest.mark.parametrize("n,m,d", [(32, 40, 5), (128, 128, 128), (70, 30, 17), (8, 8, 200)])
def test_pairwise_matches_reference(n, m, d):
    rng = np.random.default_rng(n * m * d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(m, d)).astype(np.float32)
    got = ops.pairwise_sq_dists(*_t(x, y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.pairwise_sq_dists(x, y, interpret=True)), **PAIRWISE_TOL)
    np.testing.assert_allclose(got, np.asarray(jref.pairwise_sq_dists_ref(x, y)), **PAIRWISE_TOL)
    assert got.min() >= 0.0


@pytest.mark.parametrize("b,n,m,d", [(3, 40, 24, 7), (2, 70, 30, 17), (4, 16, 8, 6)])
def test_pairwise_batched_matches_reference(b, n, m, d):
    """The reference's batched entry (``test_evalplane.py`` shape first), and a
    2-D x shared by every lane against the reference's broadcast copies."""
    rng = np.random.default_rng(b * n + m * d)
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    y = rng.normal(size=(b, m, d)).astype(np.float32)
    got = ops.pairwise_sq_dists_batched(*_t(x, y)).numpy()
    want = np.asarray(jops.pairwise_sq_dists_batched(jnp.asarray(x), jnp.asarray(y), interpret=True))
    np.testing.assert_allclose(got, want, **PAIRWISE_TOL)
    shared = ops.pairwise_sq_dists_batched(torch.from_numpy(x[0]), torch.from_numpy(y)).numpy()
    x0 = jnp.broadcast_to(jnp.asarray(x[0]), (b, n, d))
    want0 = np.asarray(jops.pairwise_sq_dists_batched(x0, jnp.asarray(y), interpret=True))
    np.testing.assert_allclose(shared, want0, **PAIRWISE_TOL)


def test_wrappers_refuse_tensors_off_the_cpu_and_card():
    """A tensor that is neither on the CPU nor on one card raises: no fallback."""
    v, w, h = (t.to("meta") for t in _t(*_mu_problem(0, (), 8, 8, 2)))
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        ops.mu_update_h(v, w, h)
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        ops.silhouette_dist_sums(x, torch.zeros((4, 2)))
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        ops.pairwise_sq_dists_batched(x, torch.zeros((2, 5, 3)))


def test_plain_path_launches_no_kernel():
    ops.reset_launch_counts()
    v, w, h = _t(*_mu_problem(1, (), 16, 12, 3))
    ops.mu_update_h(v, w, h)
    ops.silhouette_dist_sums(w, torch.eye(3)[torch.arange(16) % 3])
    ops.pairwise_sq_dists(w)
    ops.pairwise_sq_dists_batched(w, h[None].transpose(1, 2).contiguous())
    ops.flash_attention(v[None, None], v[None, None], v[None, None], causal=False)
    assert ops.launch_counts() == dict.fromkeys(
        ["mu_update_h", "mu_update_w", "silhouette_dist_sums", "silhouette_dist_sums_batched",
         "pairwise_sq_dists", "pairwise_sq_dists_batched", "flash_attention"], 0
    )


def test_library_name_follows_source_content(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = csrc / "nmf_update.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    first = build.library_path("nmf_update")
    assert first == build.library_path("nmf_update")
    src.write_text("// two\n")
    assert build.library_path("nmf_update") != first
    assert first.parent == build.BUILD_DIR and first.name.startswith("libnmf_update_")


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the build raise and leaves no library."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "nvcc_path", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed for nmf_update.cu"):
        build.build(["nmf_update"])
    assert not list((tmp_path / "out").glob("*.so"))
