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

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import profile_ksearch  # noqa: E402
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
