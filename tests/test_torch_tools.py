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

import grad_spread  # noqa: E402
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


@pytest.mark.parametrize("elem,ms", [(4, 0.044), (2, 0.022)])
@pytest.mark.parametrize("update", ["h", "w"])
def test_mu_bound_is_chip_smokes_and_scales_with_lanes(update, elem, ms):
    """time_mu reports chip_smoke.py's bound: at the paper's 1000 x 1100,
    k 16 the bytes bind (0.044 ms at the batched wave's L=32 in fp32, half
    of it in bf16), and it is linear in the lane count (the elastic
    executor's L=8 a quarter of it)."""
    import chip_smoke

    assert time_mu.mu_bound is chip_smoke.mu_bound
    ms32, by32 = chip_smoke.mu_bound(update, 32, 1000, 1100, 16, elem)
    assert abs(ms32 - ms) < 0.001 and by32 == "bytes"
    ms8, by8 = chip_smoke.mu_bound(update, 8, 1000, 1100, 16, elem)
    assert ms8 == pytest.approx(ms32 / 4) and by8 == "bytes"


def test_mu_parse_args_takes_a_dtype():
    """time_mu times float32 by default and bf16 with --dtype bfloat16, each
    held at its own MU tolerance; another dtype is refused."""
    args = time_mu.parse_args([])
    assert args.dtype == "float32" and args.searches == 3 and not args.no_tma
    args = time_mu.parse_args(["--dtype", "bfloat16", "--src", "build/parent/src", "--tag", "parent"])
    assert (args.dtype, args.src, args.tag) == ("bfloat16", "build/parent/src", "parent")
    assert time_mu.MU_TOL["bfloat16"] == dict(rtol=2e-2, atol=2e-2)
    with pytest.raises(SystemExit):
        time_mu.parse_args(["--dtype", "float16"])


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


@pytest.mark.parametrize("b,n,k,elem,ms,by", [
    (1, 52, 13, 4, 8.352e-5, "operations"), (8, 64, 16, 4, 1.0115e-3, "operations"),
    (1, 52, 13, 2, 3.2255e-5, "bytes"), (8, 64, 16, 2, 3.2034e-4, "bytes"),
])
def test_sums_bound_is_chip_smokes_at_both_dtypes(b, n, k, elem, ms, by):
    """time_sums reports chip_smoke.py's silhouette bound: at fp32 the
    operations bind (the fp32 rate), at bf16 the bytes (bf16 x and one-hot
    in, fp32 sums out; x . y at the bf16 rate), at the threads path's 52
    points and the batched wave's 8 lanes of 64 (d 1000, x = y); y apart
    from x adds its bytes and its norms."""
    import chip_smoke
    import time_sums

    assert time_sums.sums_bound is chip_smoke.sums_bound
    got, got_by = chip_smoke.sums_bound(b, n, n, 1000, k, True, elem)
    assert got == pytest.approx(ms, rel=2e-3) and got_by == by
    if elem == 2:  # check_sums_bf16's bytes: bf16 x (= y) and one-hot read once, fp32 out
        assert got == pytest.approx(b * (2 * n * 1000 + 2 * n * k + 4 * n * k) / 3.35e12 * 1e3)
    apart, _ = chip_smoke.sums_bound(b, n, n, 1000, k, False, elem)
    assert apart > got


def test_sums_parse_args_takes_a_dtype():
    """time_sums times float32 by default and bf16 with --dtype bfloat16, each
    held at the reference's distance tolerance of its dtype; another dtype
    is refused."""
    import time_sums

    args = time_sums.parse_args([])
    assert args.dtype == "float32" and args.searches == 3 and not args.timeline
    args = time_sums.parse_args(["--dtype", "bfloat16", "--src", "build/parent/src", "--tag", "parent"])
    assert (args.dtype, args.src, args.tag) == ("bfloat16", "build/parent/src", "parent")
    assert time_sums.TOL == {"float32": dict(rtol=1e-4, atol=1e-3), "bfloat16": dict(rtol=5e-2, atol=5e-1)}
    with pytest.raises(SystemExit):
        time_sums.parse_args(["--dtype", "float16"])


def test_sums_thin_blocks_follow_the_kernel_rule():
    import time_sums

    assert time_sums.thin_blocks(1, 52, 1000, 132) == 8 * 4  # clusters of 8, 16-row units
    assert time_sums.thin_blocks(8, 64, 1000, 132) == 8 * 2 * 8  # 16-row units would need 256 > 132
    assert time_sums.thin_blocks(2, 40, 17, 132) == 1 * 3 * 2  # d <= 128: one block a cluster


def test_flash_parse_args_defaults_and_flags():
    import time_flash

    args = time_flash.parse_args([])
    assert Path(args.src) == Path(time_flash.__file__).resolve().parents[1] / "src"
    assert args.tag is None and args.seed == 11 and args.dtype == "float32"
    args = time_flash.parse_args(["--src", "build/parent/src", "--tag", "parent", "--seed", "3", "--dtype",
                                  "bfloat16"])
    assert (args.src, args.tag, args.seed, args.dtype) == ("build/parent/src", "parent", 3, "bfloat16")
    with pytest.raises(SystemExit):
        time_flash.parse_args(["--dtype", "float16"])


@pytest.mark.parametrize(
    "lq,lk,causal,window",
    [(64, 64, True, None), (70, 45, False, None), (50, 50, True, 7), (33, 33, False, 5), (1, 1, True, None),
     (9, 30, True, 4)],
)
def test_flash_live_pairs_count_the_plain_versions_mask(lq, lk, causal, window):
    import time_flash
    from repro_torch.kernels import ref

    q_offset = lk - lq if lq < lk else 0  # the rows at the sequence's end where Lq != Lk
    assert time_flash.live_pairs(lq, lk, causal, window, q_offset) == int(
        ref._mask(lq, lk, causal, window, "cpu", q_offset).sum())


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


def test_flash_bf16_bound_at_the_prefill_shapes():
    """At bf16 the bytes halve and the products run at 989 TFLOP/s: the
    qwen2 prefill's 7.2 GFLOP bind at 0.00725 ms, jamba's 34.4 GFLOP at
    0.0348 ms (chip_smoke.py's bf16 bounds); a tiny call is bound by its
    bytes."""
    import time_flash

    flops, n_bytes = time_flash.work(4, 14, 2, 1000, 1000, 64, True, None, elem=2)
    assert n_bytes == 2 * (2 * 4 * 14 * 1000 * 64 + 2 * 4 * 2 * 1000 * 64)
    assert time_flash.bounds(flops, n_bytes, "bfloat16") == {"bound_bf16_ms": pytest.approx(0.007255, abs=1e-5)}
    flops, n_bytes = time_flash.work(4, 32, 8, 1024, 1024, 128, True, None, elem=2)
    assert time_flash.bounds(flops, n_bytes, "bfloat16")["bound_bf16_ms"] == pytest.approx(0.03478, abs=1e-4)
    assert time_flash.bounds(10, 3_350_000, "bfloat16") == {"bound_bf16_ms": pytest.approx(1e-3)}
    assert [shape[0] for shape in time_flash.SHAPES][2:] == ["granite-moe-1b-a400m prefill", "jamba-v0.1-52b prefill"]


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


def test_serve_parse_args_depth_cut_and_prompt_length():
    """``--layers`` cuts the depth (0: the arch's own) and ``--prompt-len``
    sets the prompt (default: chip_smoke.py's serve phases' 1000)."""
    import profile_serve

    args = profile_serve.parse_args([])
    assert (args.layers, args.prompt_len) == (0, profile_serve.PROMPT) == (0, 1000)
    args = profile_serve.parse_args(["--arch", "jamba-v0.1-52b", "--layers", "8", "--prompt-len", "1024"])
    assert (args.arch, args.layers, args.prompt_len) == ("jamba-v0.1-52b", 8, 1024)
    for bad in (["--layers", "-1"], ["--prompt-len", "0"]):
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


def test_grad_spread_takes_the_mesh_runs_first_step():
    """grad_spread's one step is chip_smoke's mesh training run's (B 8, L
    64, remat full, seed 0, published widths) at the given microbatches."""
    from repro_torch.launch import train

    args = train._parser().parse_args(grad_spread.step_args("rwkv6-1.6b", None, 2))
    assert (args.arch, args.reduced, args.layers, args.steps, args.microbatches) == ("rwkv6-1.6b", False, None, 1, 2)
    assert (args.batch, args.seq, args.remat, args.seed, args.device) == (8, 64, "full", 0, "cuda")
    assert train._parser().parse_args(grad_spread.step_args("rwkv6-1.6b", 2, 1)).layers == 2


def test_rwkv_off_init_moves_the_time_mix_constants_alike_on_every_draw():
    """Inside ``grad_spread.rwkv_off_init`` RWKV-6's mixes, u, ln_scale and w0
    leave their init values (0.5, 0, 1, -6), the same on every draw from one seed;
    outside it, and with ``on`` False, init is as before."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.transformer import Model

    def draw():
        model = Model(reduced_config(get_config("rwkv6-1.6b")))
        return {k: v.clone() for k, v in model.init(torch.Generator().manual_seed(0)).named_parameters()}

    plain = draw()
    with grad_spread.rwkv_off_init():
        moved, again = draw(), draw()
    with grad_spread.rwkv_off_init(False):
        unmoved = draw()
    assert all(torch.equal(moved[k], again[k]) for k in moved)
    assert all(torch.equal(plain[k], unmoved[k]) and torch.equal(plain[k], draw()[k]) for k in plain)
    mixers = [k for k in moved if k.endswith("mixer.u")]
    assert mixers
    for key in mixers:
        stem = key[: -len("u")]
        assert float(plain[key].abs().max()) == 0.0 and 0.0 < float(moved[key].abs().mean()) < 0.3
        assert float((moved[stem + "ln_scale"] - 1).abs().mean()) > 0.01
        assert float((moved[stem + "mix_w"] - 0.5).abs().mean()) > 0.01
        assert float((moved[stem.replace("mixer", "ffn") + "mix_r"] - 0.5).abs().mean()) > 0.01
        assert abs(float(moved[stem + "w0"].mean()) + 1) < 0.3 and float(plain[stem + "w0"].mean()) == -6.0
    first = mixers[0][: -len("u")]  # the draws before the first layer's moves are the same
    assert all(torch.equal(moved[first + name], plain[first + name]) for name in ("wr", "w_b"))