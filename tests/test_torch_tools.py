"""The port's measurement tools (``tools/``): the parts that run without a card.

The tools time and profile the port on a card; what they compute from what
they record (the profiler's device time, the pairwise shape histogram, the
operands of a recorded shape) is checked here on the CPU.
"""
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tools"), str(ROOT)]

import profile_ksearch  # noqa: E402
import time_mu  # noqa: E402
import time_pairwise  # noqa: E402


def _event(key, device_type, self_us, count=1):
    return types.SimpleNamespace(key=key, device_type=device_type, self_device_time_total=self_us, count=count)


def test_device_times_count_each_kernel_once():
    """A host-side op's own device time is that of the kernels it launched,
    which appear as events of their own: only device events are summed."""
    from torch.autograd import DeviceType

    prof = types.SimpleNamespace(key_averages=lambda: [
        _event("aten::bmm", DeviceType.CPU, 150_000.0, 412),
        _event("cutlass_sgemm", DeviceType.CUDA, 146_000.0, 407),
        _event("pairwise_thin<8>", DeviceType.CUDA, 38_000.0, 861),
        _event("aten::empty", DeviceType.CPU, 0.0, 9),
    ])
    times = profile_ksearch.device_times(prof)
    assert times == {"cutlass_sgemm": (146.0, 407), "pairwise_thin<8>": (38.0, 861)}


@pytest.mark.parametrize("update", ["h", "w"])
def test_mu_bound_is_chip_smokes_and_scales_with_lanes(update):
    """time_mu reports chip_smoke.py's bound: at the paper's 1000 x 1100,
    k 16 the bytes bind (0.044 ms at the batched wave's L=32), and it is
    linear in the lane count (the elastic executor's L=8 a quarter of it)."""
    import chip_smoke

    assert time_mu.mu_bound is chip_smoke.mu_bound
    ms32, by32 = chip_smoke.mu_bound(update, 32, 1000, 1100, 16)
    assert abs(ms32 - 0.044) < 0.001 and by32 == "bytes"
    ms8, by8 = chip_smoke.mu_bound(update, 8, 1000, 1100, 16)
    assert ms8 == pytest.approx(ms32 / 4) and by8 == "bytes"


def test_record_shapes_counts_launches_by_shape_and_restores_the_wrapper():
    def launch(x, y, lanes):
        return ("launched", lanes)

    ops = types.SimpleNamespace(_pairwise_launch=launch)
    x2, x3, y3 = torch.zeros((50, 6)), torch.zeros((2, 50, 6)), torch.zeros((2, 7, 6))
    seen = []

    def run():
        seen.append(ops._pairwise_launch(x2, y3, 2))
        seen.append(ops._pairwise_launch(x2, y3, 2))
        seen.append(ops._pairwise_launch(x3, y3, 2))

    hist = time_pairwise.record_shapes(ops, run)
    assert hist == {(2, 50, 7, 6, 2, 3): 2, (2, 50, 7, 6, 3, 3): 1}
    assert seen == [("launched", 2)] * 3
    assert ops._pairwise_launch is launch


@pytest.mark.parametrize("shape", [(1, 40, 24, 6, 2, 3), (3, 40, 7, 6, 3, 3), (1, 9, 9, 6, 2, 2)])
def test_operands_have_the_recorded_shape(shape):
    lanes, n, m, d, x_dim, y_dim = shape
    points = torch.randn((100, d))
    x, y = time_pairwise.operands(torch, points, shape)
    assert x.shape == ((lanes, n, d) if x_dim == 3 else (n, d))
    assert y.shape == ((lanes, m, d) if y_dim == 3 else (m, d))
    assert x.is_contiguous() and y.is_contiguous()


def test_sums_record_shapes_counts_launches_by_shape_and_restores_the_launch():
    import time_sums

    def launch(x, y, onehot):
        return ("launched", x.shape[0])

    ops = types.SimpleNamespace(_dist_sums_launch=launch)
    x3, y3 = torch.zeros((2, 64, 10)), torch.zeros((2, 30, 10))
    oh3, oh30 = torch.zeros((2, 64, 16)), torch.zeros((2, 30, 16))
    x2 = torch.zeros((52, 10))
    seen = []

    def run():
        seen.append(ops._dist_sums_launch(x3, x3, oh3))
        seen.append(ops._dist_sums_launch(x3, x3, oh3))
        seen.append(ops._dist_sums_launch(x3, y3, oh30))
        # the 2-D wrapper hands the launch views of one tensor: still y is x
        seen.append(ops._dist_sums_launch(x2.unsqueeze(0), x2.unsqueeze(0), torch.zeros((1, 52, 13))))

    hist = time_sums.record_shapes(ops, run)
    assert hist == {(2, 64, 64, 10, 16, True): 2, (2, 64, 30, 10, 16, False): 1, (1, 52, 52, 10, 13, True): 1}
    assert seen == [("launched", 2)] * 3 + [("launched", 1)]
    assert ops._dist_sums_launch is launch


@pytest.mark.parametrize("shape", [(1, 52, 52, 40, 13, True), (3, 64, 64, 17, 16, True), (2, 30, 20, 9, 7, False),
                                   (1, 258, 258, 12, 129, True)])
def test_sums_operands_have_the_recorded_shape(shape):
    import time_sums

    b, n, m, d, k, same = shape
    x, y, onehot = time_sums.operands(torch, shape, torch.device("cpu"))
    assert x.shape == (b, n, d) and y.shape == (b, m, d) and onehot.shape == (b, m, k)
    assert (y is x) == same
    assert x.is_contiguous() and y.is_contiguous() and onehot.is_contiguous()
    torch.testing.assert_close(x.norm(dim=-1), torch.ones((b, n)))  # unit columns, as NMFk pools them
    assert torch.equal(onehot.sum(dim=-1), torch.ones((b, m)))


def test_sums_phase_summary_scales_each_block_by_its_own_timer():
    import time_sums

    # two blocks: clocks at 2 and 1 cycles a ns; phases of 10, 20, 30, 40, 50 ns
    one = [0, 20, 60, 120, 200, 300, 1000, 1150]
    two = [5, 15, 35, 65, 105, 155, 1005, 1155]
    out = time_sums.phase_summary([one, two])
    assert len(one) == time_sums.STAMPS
    assert out["blocks"] == 2 and out["span_ns"] == 155 and out["start_spread_ns"] == 5
    assert out["clock_ghz"] == 1.5
    for name, want in zip(time_sums.PHASES, (10, 20, 30, 40, 50)):
        assert out["phases"][name] == {"median_ns": want, "max_ns": want}


def test_sums_thin_blocks_follow_the_kernel_rule():
    import time_sums

    assert time_sums.thin_blocks(1, 52, 1000, 132) == 8 * 4  # clusters of 8, 16-row units
    assert time_sums.thin_blocks(8, 64, 1000, 132) == 8 * 2 * 8  # 16-row units would need 256 > 132
    assert time_sums.thin_blocks(2, 40, 17, 132) == 1 * 3 * 2  # d <= 128: one block a cluster


def test_flash_parse_args_defaults_and_flags():
    import time_flash

    args = time_flash.parse_args([])
    assert Path(args.src) == Path(time_flash.__file__).resolve().parents[1] / "src"
    assert args.tag is None and args.seed == 11
    args = time_flash.parse_args(["--src", "build/parent/src", "--tag", "parent", "--seed", "3"])
    assert (args.src, args.tag, args.seed) == ("build/parent/src", "parent", 3)


@pytest.mark.parametrize(
    "lq,lk,causal,window",
    [(64, 64, True, None), (70, 45, False, None), (50, 50, True, 7), (33, 33, False, 5), (1, 1, True, None),
     (9, 30, True, 4)],
)
def test_flash_live_pairs_count_the_plain_versions_mask(lq, lk, causal, window):
    import time_flash
    from repro_torch.kernels import ref

    assert time_flash.live_pairs(lq, lk, causal, window) == int(ref._mask(lq, lk, causal, window, "cpu").sum())


def test_flash_bounds_at_the_serve_and_window_shapes():
    """The qwen2 prefill's 7.2 GFLOP and 15 MB: 0.107 ms on fp32 CUDA cores,
    0.0435 ms as three TF32 products on the tensor cores; h2o-danube's heads:
    165.8 GFLOP, 2.47 and 1.00 ms."""
    import time_flash

    flops, n_bytes = time_flash.work(4, 14, 2, 1000, 1000, 64, True, None)
    assert flops == 4 * 4 * 14 * 64 * 500_500 and n_bytes == 4 * (2 * 4 * 14 * 1000 * 64 + 2 * 4 * 2 * 1000 * 64)
    got = time_flash.bounds(flops, n_bytes)
    assert got["bound_fp32_ms"] == pytest.approx(flops / 67e12 * 1e3) and got["bound_fp32_ms"] == pytest.approx(
        0.1071, abs=1e-4)
    assert got["bound_3xtf32_ms"] == pytest.approx(3 * flops / 495e12 * 1e3) and got["bound_3xtf32_ms"] == pytest.approx(
        0.04349, abs=1e-4)
    flops, n_bytes = time_flash.work(1, 32, 8, 6000, 6000, 80, True, 4096)
    assert flops == pytest.approx(165.8e9, rel=1e-3)
    got = time_flash.bounds(flops, n_bytes)
    assert got["bound_fp32_ms"] == pytest.approx(2.475, abs=1e-3)
    assert got["bound_3xtf32_ms"] == pytest.approx(1.005, abs=1e-3)
    # a tiny call is bound by its bytes on both
    got = time_flash.bounds(10, 3_350_000)
    assert got == {"bound_fp32_ms": pytest.approx(1e-3), "bound_3xtf32_ms": pytest.approx(1e-3)}


def test_serve_parse_args_defaults_and_flags():
    import profile_serve

    args = profile_serve.parse_args([])
    assert Path(args.src) == Path(profile_serve.__file__).resolve().parents[1] / "src"
    assert (args.tag, args.repeats, args.turns, args.parent) == (None, 5, 0, None)
    args = profile_serve.parse_args(["--turns", "5", "--parent", "build/parent/src", "--repeats", "3"])
    assert (args.turns, args.parent, args.repeats) == (5, "build/parent/src", 3)
    for bad in (["--turns", "2"], ["--repeats", "0"]):
        with pytest.raises(SystemExit):
            profile_serve.parse_args(bad)


@pytest.mark.parametrize("turns", [1, 2, 5])
def test_serve_turns_alternate_which_version_runs_first(turns):
    import profile_serve

    order = profile_serve.turn_order(turns)
    assert order[:4] == ["parent", "change", "change", "parent"][: 2 * turns]
    assert order.count("parent") == order.count("change") == turns
    assert all({order[2 * i], order[2 * i + 1]} == {"parent", "change"} for i in range(turns))


def test_serve_summary_takes_median_and_range_of_each_version():
    import profile_serve

    def run(tag, x):
        return {"tag": tag, **{key: x for key in profile_serve.SUMMARY_KEYS}}

    runs = [run("parent", 3.0), run("change", 1.0), run("change", 2.0), run("parent", 5.0), run("change", 9.0)]
    got = profile_serve.summarize(runs)
    assert list(got) == ["parent", "change"]
    assert got["parent"]["runs"] == 2 and got["change"]["runs"] == 3
    assert got["parent"]["prefill_median_s"] == {"median": 4.0, "min": 3.0, "max": 5.0}
    assert got["change"]["flash_ms"] == {"median": 2.0, "min": 1.0, "max": 9.0}


def test_serve_flash_ms_counts_both_versions_kernels():
    import profile_serve

    times = {
        "void (anonymous namespace)::flash_kernel<4>(float const*, ...)": (2.0, 24),
        "void (anonymous namespace)::split_kv_kernel<4>(float const*, ...)": (0.25, 24),
        "cutlass_80_simt_sgemm_128x64": (50.0, 168),
    }
    assert profile_serve.flash_ms(times) == 2.25


def test_serve_host_waits_count_the_calls_that_hold_the_host():
    import profile_serve
    from torch.autograd import DeviceType

    prof = types.SimpleNamespace(key_averages=lambda: [
        _event("cudaStreamSynchronize", DeviceType.CPU, 0.0, 48),
        _event("cudaMemcpyAsync", DeviceType.CPU, 0.0, 49),
        _event("cudaLaunchKernel", DeviceType.CPU, 0.0, 1141),
        _event("aten::to", DeviceType.CPU, 0.0, 48),
    ])
    assert profile_serve.host_waits(prof) == {"cudaStreamSynchronize": 48, "cudaMemcpyAsync": 49}


def test_drop_count_counts_each_route_by_row_and_restores_it():
    """``chip_smoke.DropCount`` (the profilers' too) counts the dropped slots
    of each MoE route made while active, by batch row, and puts ``route``
    back."""
    import chip_smoke
    import profile_serve

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = configs.reduced_config(configs.get_config("granite-moe-1b-a400m"))
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.ones((2, 20, cfg.d_model))  # 40 equal tokens: each takes the same 2 experts
    real = moe.route
    with chip_smoke.DropCount(2) as drops:
        moe.moe_ffn(params, x, cfg)
        moe.moe_ffn(params, x, cfg, 2.0)
    # 40 tokens into each of 2 experts: 25 slots at capacity factor 1.25 (the
    # second row's last 15 tokens drop), 40 at 2.0
    assert drops.by_call == [[0, 2 * 15], [0, 0]] and drops.by_row() == [0, 30] and moe.route is real
    assert profile_serve.DropCount is chip_smoke.DropCount
    assert profile_serve.parse_args(["--arch", "granite-moe-1b-a400m"]).arch == "granite-moe-1b-a400m"


def test_rescalk_profile_runs_chip_smokes_search(monkeypatch):
    """``--search rescalk`` profiles chip_smoke.py's rescalk_1000: the same
    settings, and the serial and threads executors as 1 and 4 resources."""
    import chip_smoke

    assert profile_ksearch.RESCAL_DATA is chip_smoke.RESCAL_DATA
    calls = []

    def search(evaluate, **kw):
        calls.append(kw)
        return types.SimpleNamespace(k_optimal=4)

    import repro_torch.core

    monkeypatch.setattr(repro_torch.core, "binary_bleed_search", search)
    fake_torch = types.SimpleNamespace(cuda=types.SimpleNamespace(synchronize=lambda: None))
    x = torch.zeros((4, 6, 6))
    for executor in ("serial", "threads"):
        assert profile_ksearch.rescalk_1000(fake_torch, x, executor)["k_optimal"] == 4
    assert [c["num_resources"] for c in calls] == [1, chip_smoke.RESCAL_THREADS]
    assert all(c["k_range"] == (2, 11) and c["select_threshold"] == 0.8 for c in calls)
