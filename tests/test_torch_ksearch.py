"""The port's k-search end to end on the CPU.

1. Port ``binary_bleed_search`` over the reference's V and the reference's
   draws gives the reference's ``k_optimal`` and visited set, through the
   port's ``NMFkBatchPlane`` (batched) and the port's evaluator (serial).
2. ``python -m repro_torch.launch.ksearch --device cpu`` finds the planted
   rank on the port's own V on every executor and with
   ``--distributed-fit``; the journal, trace and
   metrics outputs work; ``examples/torch_quickstart.py --device cpu``
   finds it with Binary Bleed and grid search.
3. The default device is the card: without one, entry points raise.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from _torch_reference import reference_draw_source  # noqa: E402
from repro.factorization.nmfk import make_nmfk_evaluator as j_evaluator  # noqa: E402
from repro.factorization.planes import NMFkBatchPlane as JPlane  # noqa: E402
from repro.factorization.synthetic import nmf_data as jnmf_data  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.factorization.nmfk import make_nmfk_evaluator as t_evaluator  # noqa: E402
from repro_torch.factorization.planes import NMFkBatchPlane as TPlane  # noqa: E402
from repro_torch.launch import ksearch  # noqa: E402

KEY = jax.random.PRNGKey(0)
P, ITERS, K_RANGE, THRESHOLD = 4, 80, (2, 12), 0.9
ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")


@pytest.fixture(scope="module")
def v_np():
    v, _, _ = jnmf_data(KEY, n=96, m=104, k_true=5)
    return np.array(v)


def _same_search(got, want):
    assert got.k_optimal == want.k_optimal
    assert sorted(got.visited_ks) == sorted(want.visited_ks)


def test_batched_plane_search_matches_reference(v_np):
    want = jcore.binary_bleed_search(
        JPlane(v_np, KEY, n_perturbs=P, nmf_iters=ITERS, k_pad=K_RANGE[1]),
        K_RANGE, THRESHOLD, executor="batched",
    )
    plane = TPlane(
        to_tensor(v_np, "cpu"), n_perturbs=P, nmf_iters=ITERS, k_pad=K_RANGE[1],
        draws=reference_draw_source(KEY, *v_np.shape, P),
    )
    got = tcore.binary_bleed_search(plane, K_RANGE, THRESHOLD, executor="batched")
    _same_search(got, want)
    assert want.k_optimal == 5


def test_evaluator_search_matches_reference(v_np):
    want = jcore.binary_bleed_search(
        j_evaluator(v_np, KEY, n_perturbs=P, nmf_iters=ITERS), K_RANGE, THRESHOLD
    )
    evaluate = t_evaluator(
        to_tensor(v_np, "cpu"), n_perturbs=P, nmf_iters=ITERS,
        draws=reference_draw_source(KEY, *v_np.shape, P),
    )
    _same_search(tcore.binary_bleed_search(evaluate, K_RANGE, THRESHOLD), want)
    threaded = tcore.binary_bleed_search(evaluate, K_RANGE, THRESHOLD, num_resources=4)
    assert threaded.k_optimal == want.k_optimal


def test_chunked_evaluate_one_runs_to_the_batched_score_and_aborts(v_np):
    plane = TPlane(to_tensor(v_np, "cpu"), n_perturbs=P, nmf_iters=60, k_pad=8)
    fused = plane.evaluate_batch([6])[0]
    chunked = plane.evaluate_one(6, should_abort=lambda: False)
    assert abs(chunked - fused) <= 1e-5
    assert plane.last_scalar_sweeps == 60 * P
    assert np.isnan(plane.evaluate_one(6, should_abort=lambda: True))
    polls = iter([False, True])
    plane.evaluate_one(6, should_abort=lambda: next(polls))
    assert plane.last_scalar_sweeps == plane.abort_chunk * P


def test_cli_finds_planted_rank_on_the_cpu(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.ksearch", "--device", "cpu",
           "--k-max", "12", "--n-perturbs", "4", "--nmf-iters", "80"]
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300, check=True)
    result = json.loads(out.stdout)
    assert result["k_optimal"] == result["k_true"] == 5
    assert result["device"] == "cpu" and result["executor"] == "threads"


def test_batched_executor_with_trace_and_metrics(tmp_path):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    out = ksearch.main(["--device", "cpu", "--k-max", "12", "--n-perturbs", "4", "--nmf-iters", "80",
                        "--executor", "batched", "--quiet", "--trace", str(trace), "--metrics", str(metrics)])
    assert out["k_optimal"] == 5 and out["waves"] >= 1
    assert json.loads(trace.read_text())["traceEvents"]
    assert json.loads(metrics.read_text())["result"]["k_optimal"] == 5


def test_elastic_executor_finds_planted_rank_with_accounting():
    out = ksearch.main(["--device", "cpu", "--k-max", "12", "--n-perturbs", "4", "--nmf-iters", "80",
                        "--executor", "elastic", "--quiet"])
    assert out["k_optimal"] == out["k_true"] == 5
    assert out["executor"] == "elastic" and out["ticks"] >= 1
    assert out["sweeps_run"] + out["sweeps_saved"] == out["sweeps_fixed_total"]
    assert out["sweeps_saved"] > 0 and out["warm_start_hits"] > 0  # the defaults: tol 1e-3, warm starts
    oracle = ksearch.main(["--device", "cpu", "--k-max", "12", "--n-perturbs", "4", "--nmf-iters", "80",
                           "--executor", "elastic", "--tol", "0", "--no-warm-start", "--fit-chunk", "30",
                           "--quiet"])
    assert oracle["k_optimal"] == 5 and oracle["warm_start_hits"] == 0
    assert oracle["sweeps_run"] == 4 * 80 * oracle["n_visited"]


def test_distributed_fit_finds_planted_rank_and_releases_its_groups():
    """``--distributed-fit``: each of the 2 workers runs ``distributed_nmf``
    over its own one-rank gloo group before scoring; the groups and the
    default group made for them are gone after the run."""
    import torch.distributed as dist

    out = ksearch.main(["--device", "cpu", "--distributed-fit", "--resources", "2", "--k-max", "12",
                        "--n-perturbs", "4", "--nmf-iters", "80", "--quiet"])
    assert out["k_optimal"] == out["k_true"] == 5
    assert out["distributed_fit"] and out["resources"] == 2
    assert not dist.is_initialized()


def test_quickstart_example_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_quickstart.py"), "--device", "cpu"],
                         capture_output=True, text=True, env=env, timeout=300, check=True)
    assert "Binary Bleed : k_optimal=5" in out.stdout and "Grid search  : k_optimal=5" in out.stdout


def test_journal_restart_replays_the_search(tmp_path):
    args = ["--device", "cpu", "--k-max", "8", "--n-perturbs", "3", "--nmf-iters", "40",
            "--quiet", "--journal", str(tmp_path / "journal")]
    first = ksearch.main(args)
    second = ksearch.main(args)
    assert second["k_optimal"] == first["k_optimal"]


def test_parser_refuses_unported_executors_and_flags():
    """The reference's ``--compile-cache`` has no counterpart (no jit cache to
    persist), and an executor or comm mode the reference lacks is refused.
    The sharded executor and its mesh flags are ported
    (``tests/test_torch_sharded.py``)."""
    for extra in (["--compile-cache", "x"], ["--executor", "mesh"], ["--comm", "async"], ["--lanes", "two"]):
        with pytest.raises(SystemExit):
            ksearch._parser().parse_args(extra)


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.factorization.synthetic import nmf_data

    with pytest.raises(RuntimeError, match="cuda"):
        ksearch.main(["--quiet"])
    with pytest.raises(RuntimeError, match="cuda"):
        nmf_data(n=8, m=8, k_true=2)
    with pytest.raises(RuntimeError, match="cuda"):
        to_tensor(np.zeros(3))
