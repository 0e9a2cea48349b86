"""Port kernels: the plain versions vs the JAX reference.

On the CPU the port's wrappers run their plain versions; those are held
against the reference's Pallas kernels (interpret mode) and its jnp oracles
at ragged shapes with masked components, at the reference's own
tolerances (``tests/test_kernels.py``). The CUDA kernels themselves are
held against the plain versions on a card in ``test_torch_cuda.py``.
"""
import math

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
    ops.flash_attention(*(v[None, None].bfloat16(),) * 3, causal=False)
    ops.mu_update_w(v.bfloat16(), w.bfloat16(), h.bfloat16())
    ops.silhouette_dist_sums_batched(w[None].bfloat16(), torch.eye(3)[torch.arange(16) % 3][None].bfloat16())
    ops.pairwise_sq_dists(w.bfloat16())
    ops.pairwise_sq_dists_batched(w.bfloat16(), h[None].transpose(1, 2).contiguous().bfloat16())
    assert ops.launch_counts() == dict.fromkeys(
        ["mu_update_h", "mu_update_w", "silhouette_dist_sums", "silhouette_dist_sums_batched",
         "pairwise_sq_dists", "pairwise_sq_dists_batched", "flash_attention", "mu_update_h[bf16]",
         "mu_update_w[bf16]", "silhouette_dist_sums[bf16]", "silhouette_dist_sums_batched[bf16]",
         "pairwise_sq_dists[bf16]", "pairwise_sq_dists_batched[bf16]", "flash_attention[bf16]"], 0
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


# (L, n, m, k): the two main-path shapes (the batched wave and the threads
# executor's lanes), n = 1, n below one stage, n and m at split boundaries,
# ragged m and k, every rank bucket, and the most lanes.
MU_PLAN_SHAPES = [
    (32, 1000, 1100, 16), (4, 1000, 1100, 16), (1, 1, 24, 5), (4, 20, 1100, 16), (4, 127, 1100, 16),
    (4, 128, 1100, 16), (4, 129, 1100, 16), (4, 1000, 255, 13), (4, 1000, 257, 13), (6, 100, 90, 13),
    (2, 70, 50, 33), (2, 40, 30, 100), (1, 5000, 7, 64), (65535, 3, 3, 1),
]


def _splits(plan):
    """The parts of a split unit's reduction, as nmf_update.cu walks them."""
    return [(s * plan.chunk, min(plan.length, (s + 1) * plan.chunk)) for s in range(plan.split)]


# (update, element size): the fp32 H- and W-updates, and the bf16 H-update
# (the bf16 W-update has no tiled kernel, so no plan)
MU_PLANNED = [("h", 4), ("w", 4), ("h", 2)]


def _stage(update, elem):
    """Rows (H) or columns (W) of V a pipeline stage holds (nmf_update.cu)."""
    if update == "w":
        return ops.MU_W_STAGE
    return ops.MU_H_STAGE if elem == 4 else ops.MU_H_STAGE_BF16


@pytest.mark.parametrize("update,elem", MU_PLANNED)
@pytest.mark.parametrize("lanes,n,m,k", MU_PLAN_SHAPES)
def test_mu_plan_splits_cover_the_reduction(update, elem, lanes, n, m, k):
    plan = ops._mu_plan(update, lanes, n, m, k, elem=elem)
    assert plan.length == (n if update == "h" else m)
    spans = _splits(plan)
    assert spans[0][0] == 0 and spans[-1][1] == plan.length
    assert all(a < b for a, b in spans), "an empty split"
    assert all(spans[s][1] == spans[s + 1][0] for s in range(plan.split - 1))
    assert plan.chunk % _stage(update, elem) == 0
    # every unit is walked: whole ones by one item, the others by `split`
    assert plan.units == plan.tiles * lanes and 0 <= plan.whole <= plan.units
    assert plan.items == plan.whole + (plan.units - plan.whole) * plan.split
    assert plan.blocks == min(plan.items, ops.MU_BLOCKS_PER_SM * ops.H100_SMS)
    # the output tiles cover the output exactly: 128 columns of H, BN rows of W
    width, extent = (ops.MU_H_COLS, m) if update == "h" else (ops.mu_w_rows(k), n)
    assert (plan.tiles - 1) * width < extent <= plan.tiles * width


@pytest.mark.parametrize("update,elem", MU_PLANNED)
@pytest.mark.parametrize("lanes,n,m,k", MU_PLAN_SHAPES)
def test_mu_plan_scratch_is_what_the_kernel_indexes(update, elem, lanes, n, m, k):
    """nmf_update.cu writes split s of tail unit u at (s * tail + u) * tile
    floats, element (rank r, column cl) at r * 128 + cl of an H tile (fp32
    and bf16 alike: the partials are fp32) and (row r, rank c) at r * k + c
    of a W tile, and counts arrivals at u: the last index of each must be
    the buffer's last."""
    plan = ops._mu_plan(update, lanes, n, m, k, elem=elem)
    tail = plan.units - plan.whole
    if tail == 0 or plan.split == 1:
        assert plan.scratch == () and plan.counters == 0
        return
    rows, width = (k, ops.MU_H_COLS) if update == "h" else (ops.mu_w_rows(k), k)
    last = ((plan.split - 1) * tail + (tail - 1)) * rows * width + (rows - 1) * width + (width - 1)
    assert math.prod(plan.scratch) == last + 1
    assert plan.counters == tail


@pytest.mark.parametrize("update,elem", MU_PLANNED)
@pytest.mark.parametrize("lanes", [32, 8, 4, 1])
def test_mu_plan_fills_the_card_at_the_main_path_shapes(update, elem, lanes):
    """The batched wave (L=32), the elastic lane batch (L=8), the threads
    executor (L=4) and one fit (L=1) at the paper's 1000 x 1100, k=16: a
    persistent block on every SM of an H100, every block with an item, at
    most one item more on one block than on another, and the partials
    small beside V."""
    plan = ops._mu_plan(update, lanes, 1000, 1100, 16, elem=elem)
    assert plan.blocks == ops.MU_BLOCKS_PER_SM * ops.H100_SMS
    assert plan.items >= plan.blocks
    # one fit has 9 H tiles for 132 SMs: each is split up to 16 ways
    assert math.prod(plan.scratch) <= lanes * 1000 * 1100 // (4 if lanes > 1 else 3)
    if lanes <= 4:
        assert plan.split > 1, "36 tiles (H) or 64 (W) alone leave SMs idle"
    # no block walks a second round of whole units while another idles
    assert plan.whole % plan.blocks == 0


@pytest.mark.parametrize("update,elem", MU_PLANNED)
def test_mu_plan_follows_the_card_size(update, elem):
    """Fewer SMs, fewer blocks; an item for every block."""
    plan = ops._mu_plan(update, 4, 1000, 1100, 16, sms=66, elem=elem)
    assert plan.blocks == 66 and plan.items >= 66


def test_mu_plan_rejects_an_unknown_update():
    with pytest.raises(ValueError, match="'h' or 'w'"):
        ops._mu_plan("x", 1, 8, 8, 2)
    with pytest.raises(ValueError, match="no tiled kernel"):
        ops._mu_plan("w", 1, 8, 8, 2, elem=2)
    with pytest.raises(ValueError, match="element size|float32"):
        ops._mu_plan("h", 1, 8, 8, 2, elem=8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("update,lanes,n,m,k", [("h", 32, 1000, 1100, 16), ("w", 4, 1000, 1100, 16), ("h", 1, 40, 24, 5)])
def test_mu_launch_hands_the_kernel_its_plan(monkeypatch, dtype, update, lanes, n, m, k):
    """The wrapper's call into nmf_update.cu, with the library stubbed: the
    C argument order, the plan's split and chunk (at bf16 the plan of bf16
    stages), scratch only when split; the bf16 W-update takes the any-rank
    kernel, with no plan."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def launch(*args):
                calls.append((name, args))
                return 0
            return launch

    monkeypatch.setattr(build, "load", lambda name: Lib())
    monkeypatch.setattr(ops, "_sm_count", lambda device: ops.H100_SMS)
    monkeypatch.setattr(ops, "_stream", lambda t: 12345)
    v = torch.zeros((lanes, n, m), dtype=dtype)
    w, h = torch.zeros((lanes, n, k), dtype=dtype), torch.zeros((lanes, k, m), dtype=dtype)
    gram, out = torch.zeros((lanes, k, k), dtype=dtype), torch.empty_like(h if update == "h" else w)
    a, b = (w, h) if update == "h" else (h, w)
    ops._mu_launch(f"mu_update_{update}", update, v, a, b, gram, out)
    ((name, args),) = calls
    assert args[:5] == (v.data_ptr(), a.data_ptr(), b.data_ptr(), gram.data_ptr(), out.data_ptr())
    if dtype == torch.bfloat16 and update == "w":
        assert name == "mu_update_w_bf16_any" and args[5:] == (lanes, n, m, k, 12345)
        return
    assert name == f"mu_update_{update}" + ("_bf16" if dtype == torch.bfloat16 else "")
    plan = ops._mu_plan(update, lanes, n, m, k, elem=v.element_size())
    assert (args[5] is None, args[6] is None) == ((plan.counters == 0),) * 2
    assert args[7:] == (lanes, n, m, k, plan.split, plan.chunk, plan.whole, plan.blocks, 12345)


def test_mu_scratch_is_kept_per_thread_and_stream_and_grows():
    """The wrapper's partials and arrival counters: one pair per thread and
    stream, reused while large enough, counters zero when allocated."""
    import threading

    cpu = torch.device("cpu")
    part, count = ops._mu_scratch(cpu, 1, 100, 8)
    assert part.numel() >= 100 and count.dtype == torch.int32 and int(count.abs().sum()) == 0
    again = ops._mu_scratch(cpu, 1, 50, 4)
    assert again[0].data_ptr() == part.data_ptr() and again[1].data_ptr() == count.data_ptr()
    bigger = ops._mu_scratch(cpu, 1, 200, 16)
    assert bigger[0].numel() >= 200 and bigger[1].numel() >= 16 and int(bigger[1].abs().sum()) == 0
    other_stream = ops._mu_scratch(cpu, 2, 50, 4)
    assert other_stream[0].data_ptr() != bigger[0].data_ptr()
    seen = []
    thread = threading.Thread(target=lambda: seen.append(ops._mu_scratch(cpu, 1, 50, 4)))
    thread.start()
    thread.join()
    assert seen[0][0].data_ptr() != bigger[0].data_ptr()


def test_mu_launch_drops_its_scratch_after_a_failed_launch(monkeypatch):
    """A launch that fails may stop before its last blocks reset their
    arrival counters; the wrapper then drops the thread's scratch, so the
    next launch is handed counters zeroed anew."""
    rcs, calls = [0, 700, 0], []

    class Lib:
        def mu_update_h(self, *args):
            calls.append(args)
            return rcs[len(calls) - 1]

    monkeypatch.setattr(build, "load", lambda name: Lib())
    monkeypatch.setattr(ops, "_sm_count", lambda device: ops.H100_SMS)
    monkeypatch.setattr(ops, "_stream", lambda t: 54321)
    lanes, n, m, k = 4, 1000, 1100, 16
    v, w, h = torch.zeros((lanes, n, m)), torch.zeros((lanes, n, k)), torch.zeros((lanes, k, m))
    gram, out = torch.zeros((lanes, k, k)), torch.empty_like(h)
    key = ("h", v.device, 54321, lanes, n, m, k, 4)
    ops._mu_launch("mu_update_h", "h", v, w, h, gram, out)
    held, _ = ops._scratch.args[key]
    assert calls[0][6] == held[1].data_ptr()
    held[1].fill_(3)  # as a launch cut short would leave them
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ops._mu_launch("mu_update_h", "h", v, w, h, gram, out)
    ops._mu_launch("mu_update_h", "h", v, w, h, gram, out)
    held, _ = ops._scratch.args[key]
    assert calls[2][6] == held[1].data_ptr()
    assert held[1].numel() >= ops._mu_plan("h", lanes, n, m, k).counters > 0
    assert int(held[1].abs().sum()) == 0


def test_pairwise_limits_follow_the_kernel_source():
    """The wrapper's limits are the ones pairwise_dist.cu compiles in."""
    import re

    src = (build.CSRC / "pairwise_dist.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert ops.PAIRWISE_THIN_COLS == const("kThinMaxM")
    assert ops.PAIRWISE_THIN_DIM == const("kThinMaxD")
    assert ops.MAX_PAIRWISE_COLS == 65535 * const("kTileM")
    assert f"b > {ops.MAX_LANES}" in src


@pytest.mark.parametrize(
    "x_shape,y_shape,lanes,strides",
    [
        ((50, 6), (7, 6), 1, (0, 0)),  # 2-D
        ((50, 6), (16, 24, 6), 16, (0, 24 * 6)),  # x shared by the lanes
        ((3, 50, 6), (24, 6), 3, (50 * 6, 0)),  # y shared
        ((3, 77, 13), (3, 5, 13), 3, (77 * 13, 5 * 13)),  # both per lane
    ],
)
def test_pairwise_launch_hands_the_kernel_its_lane_strides(monkeypatch, x_shape, y_shape, lanes, strides):
    """The wrapper's call into pairwise_dist.cu, with the library stubbed: a
    2-D operand is shared by every lane (stride 0) and never copied."""
    calls = []

    class Lib:
        def pairwise_sq_dists(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(build, "load", lambda name: Lib())
    monkeypatch.setattr(ops, "_stream", lambda t: 777)
    x, y = torch.zeros(x_shape), torch.zeros(y_shape)
    out = ops._pairwise_launch(x, y, lanes)
    (args,) = calls
    n, d, m = x_shape[-2], x_shape[-1], y_shape[-2]
    assert out.shape == (lanes, n, m)
    assert args == (x.data_ptr(), y.data_ptr(), out.data_ptr(), lanes, n, m, d, *strides, 777)


def test_pairwise_launch_refuses_shapes_past_the_kernel_limits(monkeypatch):
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("no launch past the limits"))
    with pytest.raises(ValueError, match="lanes"):
        ops._pairwise_launch(torch.zeros((4, 1)), torch.zeros((ops.MAX_LANES + 1, 2, 1)), ops.MAX_LANES + 1)
    with pytest.raises(ValueError, match="m <="):
        ops._pairwise_launch(torch.zeros((4, 1)), torch.zeros((ops.MAX_PAIRWISE_COLS + 1, 1)), 1)
    with pytest.raises(ValueError, match="do not match"):
        ops._pairwise_launch(torch.zeros((4, 2)), torch.zeros((3, 5)), 1)


def test_silhouette_and_mu_limits_follow_the_kernel_sources():
    """The wrappers' thin-path point limit and tiled rank limit are the ones
    silhouette_sums.cu and nmf_update.cu compile in."""
    import re

    def const(source, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", (build.CSRC / source).read_text()).group(1))

    assert ops.SILHOUETTE_THIN_POINTS == const("silhouette_sums.cu", "kThinMaxM")
    assert ops.MU_TILED_MAX_RANK == const("nmf_update.cu", "kTiledMaxRank")
    assert ops.rank_bucket(ops.MU_TILED_MAX_RANK) == ops.MU_TILED_MAX_RANK
    # the planner's stages and tiles: fp32 and bf16 H, fp32 W
    assert ops.MU_H_COLS == const("nmf_update.cu", "kHCols")
    assert ops.MU_H_STAGE == const("nmf_update.cu", "kHRows")
    assert ops.MU_H_STAGE_BF16 == const("nmf_update.cu", "kHRowsBf16")
    assert ops.MU_W_STAGE == const("nmf_update.cu", "kWCols")
    # a bf16 stage holds as many bytes of V as an fp32 one
    assert 2 * ops.MU_H_STAGE_BF16 == 4 * ops.MU_H_STAGE


@pytest.mark.parametrize(
    "b,n,m,d,k,same",
    [
        (1, 52, 52, 1000, 13, True),  # the threads path's 2-D call
        (8, 64, 64, 1000, 16, True),  # a batched wave
        (2, 258, 258, 1000, 129, True),  # k past 128
        (3, 70, 40, 17, 200, False),  # y other than x
    ],
)
def test_dist_sums_launch_hands_the_kernel_its_arguments(monkeypatch, b, n, m, d, k, same):
    """The wrapper's call into silhouette_sums.cu, with the library stubbed:
    the C argument order, any k, y aliasing x when it is x."""
    calls = []

    class Lib:
        def silhouette_dist_sums(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(build, "load", lambda name: Lib())
    monkeypatch.setattr(ops, "_stream", lambda t: 4242)
    x = torch.zeros((b, n, d))
    y = x if same else torch.zeros((b, m, d))
    onehot = torch.zeros((b, m, k))
    out = ops._dist_sums_launch(x, y, onehot)
    (args,) = calls
    assert out.shape == (b, n, k)
    assert args == (x.data_ptr(), y.data_ptr(), onehot.data_ptr(), out.data_ptr(), b, n, m, d, k, 4242)
    assert (args[0] == args[1]) == same


def test_dist_sums_launch_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("no launch past the limits"))
    with pytest.raises(ValueError, match="do not match"):
        ops._dist_sums_launch(torch.zeros((1, 5, 3)), torch.zeros((1, 5, 4)), torch.zeros((1, 5, 2)))
    with pytest.raises(ValueError, match="non-empty"):
        ops._dist_sums_launch(torch.zeros((1, 5, 3)), torch.zeros((1, 5, 3)), torch.zeros((1, 5, 0)))
    big = torch.zeros((ops.MAX_LANES + 1, 1, 1))
    with pytest.raises(ValueError, match="lanes"):
        ops._dist_sums_launch(big, big, big)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("update,k", [("h", 129), ("w", 129), ("h", 200), ("w", 256)])
def test_mu_launch_takes_the_any_rank_kernel_above_128(monkeypatch, dtype, update, k):
    """Past the tiled kernels' largest rank the wrapper calls the any-rank
    entry point of the operands' dtype: the five operands, the shape and
    the stream, no plan and no scratch."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def launch(*args):
                calls.append((name, args))
                return 0
            return launch

    monkeypatch.setattr(build, "load", lambda name: Lib())
    monkeypatch.setattr(ops, "_stream", lambda t: 99)
    lanes, n, m = 2, 30, 20
    v = torch.zeros((lanes, n, m), dtype=dtype)
    w, h = torch.zeros((lanes, n, k), dtype=dtype), torch.zeros((lanes, k, m), dtype=dtype)
    gram, out = torch.zeros((lanes, k, k), dtype=dtype), torch.empty_like(h if update == "h" else w)
    a, b = (w, h) if update == "h" else (h, w)
    ops._mu_launch(f"mu_update_{update}", update, v, a, b, gram, out)
    ((name, args),) = calls
    assert name == f"mu_update_{update}" + ("_bf16" if dtype == torch.bfloat16 else "") + "_any"
    assert args == (v.data_ptr(), a.data_ptr(), b.data_ptr(), gram.data_ptr(), out.data_ptr(), lanes, n, m, k, 99)


# -----------------------------------------------------------------------------
# flash attention: split TF32, the kernel's schedule and its launch
# -----------------------------------------------------------------------------
def _tf32_oracle(x: float) -> float:
    """The nearest TF32 value (11 significant bits; the fp32 subnormal grid
    coarsened by 2^13), ties away from zero, by exact rational arithmetic."""
    from fractions import Fraction

    if x != x or x in (float("inf"), float("-inf")) or x == 0.0:
        return x
    mag = Fraction(abs(x))
    _, e = math.frexp(abs(x))  # abs(x) = m 2^e, 0.5 <= m < 1
    step = Fraction(2) ** (max(e, -125) - 11)  # spacing of TF32 values around x
    units = mag / step
    rounded = math.floor(units) + (1 if units - math.floor(units) >= Fraction(1, 2) else 0)
    out = float(rounded * step)
    return math.copysign(out, x)


TF32_CASES = {
    "ties away from zero": [1 + 2**-11, -(1 + 2**-11), 1 + 3 * 2**-11, 2**20 * (1 + 2**-11), 0.75 + 2**-12],
    "nearest below a tie": [1 + 2**-11 - 2**-23, -(1 + 2**-11 - 2**-23), 3.0 + 2**-10, 1 / 3, -1e30, 1e30],
    "zeros and the largest": [0.0, -0.0, 3.3895313892515355e38, 3.4028234663852886e38],
    "subnormals": [2**-140, 2**-136, 3 * 2**-137, -2**-130, 1e-39, 2**-126 - 2**-149],
}


@pytest.mark.parametrize("case", list(TF32_CASES))
def test_tf32_round_is_cvt_rna(case):
    """``ref.tf32_round`` keeps 10 mantissa bits, rounding to nearest with
    ties away from zero (``cvt.rna.tf32.f32``); finite values past the
    largest TF32 round to infinity."""
    from repro_torch.kernels import ref

    xs = torch.tensor(TF32_CASES[case], dtype=torch.float32)
    got = ref.tf32_round(xs)
    want = [_tf32_oracle(float(x)) for x in xs]
    assert torch.equal(torch.signbit(got), torch.signbit(xs))
    for g, w, x in zip(got.tolist(), want, xs.tolist()):
        if abs(w) > 3.4028234663852886e38:
            assert g == math.copysign(math.inf, x)
        else:
            assert g == w, (x, g, w)
    assert torch.all(got.view(torch.int32) & 0x1FFF == 0)


def test_tf32_round_passes_inf_and_nan_and_matches_random_values():
    from repro_torch.kernels import ref

    special = torch.tensor([float("inf"), float("-inf"), float("nan")])
    got = ref.tf32_round(special)
    assert got[0] == math.inf and got[1] == -math.inf and torch.isnan(got[2])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(2000).astype(np.float32) * 10.0)
    got = ref.tf32_round(x)
    assert got.tolist() == [_tf32_oracle(v) for v in x.tolist()]
    # x = hi + lo exactly when lo is TF32 too: the split the kernel feeds its products
    lo = ref.tf32_round(x - got)
    assert torch.all((got.double() + lo.double() - x.double()).abs() <= x.double().abs() * 2.0**-21)


FLASH_BQ = 128  # query rows a block of the flash kernel owns (flash_attention.cu kBQ)


def _flash_views(shape_blhd, dtype=torch.float32):
    """q as the model passes it: a (B, H, L, D) view of a (B, L, H, D) tensor."""
    return torch.zeros(shape_blhd, dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize(
    "b,hq,hk,lq,lk,causal,window,bk",
    [
        (4, 14, 2, 1000, 1000, True, None, 64),  # qwen2 prefill
        (1, 32, 8, 6000, 6000, True, 4096, 32),  # h2o-danube heads
        (2, 6, 3, 70, 45, False, None, 64),  # non-causal, ragged
        (1, 4, 1, 300, 300, True, 24, 16),  # window inside one block's rows
        (3, 4, 4, 1, 1, True, None, 64),  # one row
    ],
)
def test_flash_kv_tiles_are_the_tiles_with_a_live_pair(b, hq, hk, lq, lk, causal, window, bk):
    """The kv tiles an item walks are exactly those holding a pair the plain
    version's mask leaves live for one of its query rows."""
    from repro_torch.kernels import ref

    bq = FLASH_BQ
    mask = ref._mask(lq, lk, causal, window, "cpu")
    for qt in range(math.ceil(lq / bq)):
        rows = mask[qt * bq:(qt + 1) * bq]
        live = [t for t in range(math.ceil(lk / bk)) if bool(rows[:, t * bk:(t + 1) * bk].any())]
        lo, hi = ops.flash_kv_tiles(qt * bq, bq, bk, lq, lk, causal, window)
        assert list(range(lo, hi + 1)) == live


@pytest.mark.parametrize(
    "lq,lk,causal,window,q_offset,bk",
    [
        (250, 1000, True, None, 750, 64),  # the last rank's block of qwen2's prefill at model 4
        (250, 1000, True, None, 250, 64),
        (100, 300, True, 24, 150, 16),  # a window inside the block
        (64, 130, True, None, 66, 32),  # the block's end at Lk, ragged tiles
        (40, 90, False, 16, 50, 16),  # a window without the causal mask
    ],
)
def test_flash_kv_tiles_at_a_query_offset_are_the_tiles_with_a_live_pair(lq, lk, causal, window, q_offset, bk):
    """With query row i at position ``q_offset + i``: the kv tiles an item
    walks are exactly those holding a pair that the plain version's mask at
    that offset leaves live, and the work list costs each item by them."""
    from repro_torch.kernels import ref

    bq = FLASH_BQ
    mask = ref._mask(lq, lk, causal, window, "cpu", q_offset)
    costs = {}
    for qt in range(math.ceil(lq / bq)):
        rows = mask[qt * bq:(qt + 1) * bq]
        live = [t for t in range(math.ceil(lk / bk)) if bool(rows[:, t * bk:(t + 1) * bk].any())]
        lo, hi = ops.flash_kv_tiles(qt * bq, bq, bk, lq, lk, causal, window, q_offset)
        assert list(range(lo, hi + 1)) == live
        costs[qt] = len(live)
    offsets, items = ops.flash_work_list(2, 4, 2, lq, lk, causal, window, bq, bk, 3, q_offset)
    assert sorted(items) == list(range(2 * 4 * len(costs)))
    for i in range(len(offsets) - 1):
        mine = [costs[item % len(costs)] for item in items[offsets[i]:offsets[i + 1]]]
        assert mine == sorted(mine, reverse=True)


@pytest.mark.parametrize(
    "b,hq,hk,lq,lk,causal,window,bk,blocks",
    [
        (4, 14, 2, 1000, 1000, True, None, 64, 132),
        (1, 32, 8, 6000, 6000, True, 4096, 32, 132),
        (2, 6, 3, 70, 45, False, None, 64, 132),  # fewer items than blocks
        (1, 4, 1, 1000, 1000, True, 100, 64, 7),
        (3, 2, 2, 129, 129, True, None, 64, 1),
    ],
)
def test_flash_work_list_covers_every_item_once_longest_first(b, hq, hk, lq, lk, causal, window, bk, blocks):
    """Every (b, h, q tile) is in exactly one block's list; each block walks
    its items longest first; the greedy deal keeps every block within one
    item of the least loaded; equal lengths keep the heads of a kv head
    together."""
    bq = FLASH_BQ
    offsets, items = ops.flash_work_list(b, hq, hk, lq, lk, causal, window, bq, bk, blocks)
    qtiles = math.ceil(lq / bq)
    assert sorted(items) == list(range(b * hq * qtiles))
    assert offsets[0] == 0 and offsets[-1] == len(items) and len(offsets) == min(blocks, len(items)) + 1

    def cost(item):
        lo, hi = ops.flash_kv_tiles((item % qtiles) * bq, bq, bk, lq, lk, causal, window)
        return hi - lo + 1

    loads = []
    for i in range(len(offsets) - 1):
        mine = [cost(item) for item in items[offsets[i]:offsets[i + 1]]]
        assert mine and mine == sorted(mine, reverse=True)
        loads.append(sum(mine))
    longest = max(cost(item) for item in items)
    assert max(loads) - min(loads) <= longest
    firsts = [items[offsets[i]] for i in range(len(offsets) - 1)]
    assert [cost(item) for item in firsts] == sorted((cost(item) for item in firsts), reverse=True)


class _FlashLib:
    """A stand-in for the flash library: records each launch of either
    kernel and returns ``rc``; its tiles (DP, bk 16 fp32 or 32 bf16, bq 64)
    are not the compiled ones, so a test sees the wrapper take each
    kernel's own from the library."""

    def __init__(self, rc=0):
        self.rc, self.calls, self.names = rc, [], []

    def flash_tiles(self, d, field, bf16):
        return (16 * math.ceil(d / 16), 32 if bf16 else 16, 64)[field]

    def flash_attention(self, *args):
        self.calls.append(args)
        self.names.append("flash_attention")
        return self.rc

    def flash_attention_bf16(self, *args):
        self.calls.append(args)
        self.names.append("flash_attention_bf16")
        return self.rc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "make",
    [
        lambda dtype: _flash_views((2, 77, 14, 64), dtype),  # the model's strided views
        lambda dtype: torch.zeros((2, 14, 45, 17), dtype=dtype),  # D 17: 68-byte (34 at bf16) rows
        lambda dtype: torch.zeros(1 + 2 * 14 * 8 * 64, dtype=dtype)[1:].view(2, 14, 8, 64),  # base one element off
        lambda dtype: _flash_views((1, 130, 14, 80), dtype),  # h2o-danube's head dim
    ],
)
def test_flash_launch_hands_the_kernel_its_arguments(monkeypatch, make, dtype):
    """The wrapper's call into flash_attention.cu, with the library stubbed:
    the kernel of q's dtype, the operands and their strides as they are
    (any layout), K/V scratch of bk * DP * 2 floats a tile (fp32 only), and
    the work list on q's device (offsets, then items) built for the
    library's own tiles of that kernel."""
    lib = _FlashLib()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(ops, "_stream", lambda t: 77)
    monkeypatch.setattr(ops, "_sm_count", lambda device: 132)
    monkeypatch.setattr(ops, "_flash_work_cache", {})
    q = make(dtype)
    bsz, hq, length, d = q.shape
    k = v = q[:, :2]
    out = torch.empty_like(q)
    ops._flash_launch(q, k, v, out, 0.125, True, None)
    (args,) = lib.calls
    bf16 = dtype == torch.bfloat16
    assert lib.names == ["flash_attention_bf16" if bf16 else "flash_attention"]
    dp, bk, bq = 16 * math.ceil(d / 16), 32 if bf16 else 16, 64
    offsets, items = ops.flash_work_list(bsz, hq, 2, length, length, True, None, bq, bk, 132)
    ((work, blocks),) = ops._flash_work_cache.values()
    assert work.tolist() == list(offsets + items) and blocks == len(offsets) - 1
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if not bf16:  # the split images' scratch
        image = bsz * 2 * math.ceil(length / bk) * bk * dp * 2
        assert args[5] - args[4] == 4 * image
        args = args[:4] + args[6:]
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    assert args[4:] == (work.data_ptr(), blocks, bsz, hq, 2, length, length, d, *strides, 0.125, 1, 0, 0, 77)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_launch_copies_each_work_list_once(monkeypatch, dtype):
    """The work list goes to the device once per shape and tiles: a second
    call of the same shape reuses it; another length gets its own, and so
    does the other dtype's kernel where its tiles differ."""
    lib = _FlashLib()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(ops, "_sm_count", lambda device: 8)
    monkeypatch.setattr(ops, "_flash_work_cache", {})
    at = 4 if dtype == torch.bfloat16 else 6  # where the work list's pointer sits among the arguments
    for length in (40, 40, 90):
        q = torch.zeros((1, 4, length, 32), dtype=dtype)
        ops._flash_launch(q, q, q, torch.empty_like(q), 0.2, True, None)
    assert len(ops._flash_work_cache) == 2
    assert lib.calls[0][at] == lib.calls[1][at] != lib.calls[2][at]
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    q = torch.zeros((1, 4, 40, 32), dtype=other)
    ops._flash_launch(q, q, q, torch.empty_like(q), 0.2, True, None)
    assert len(ops._flash_work_cache) == 3


def test_flash_launch_raises_when_the_kernel_refuses(monkeypatch):
    """A refused launch raises, with the library's error code."""
    lib = _FlashLib(rc=1)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(ops, "_sm_count", lambda device: 132)
    q = torch.zeros((1, 2, 16, 32))
    with pytest.raises(RuntimeError, match="flash_attention: CUDA error 1"):
        ops._flash_launch(q, q, q, torch.empty_like(q), 0.2, True, None)
    assert len(lib.calls) == 1
