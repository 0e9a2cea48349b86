#!/usr/bin/env python3
"""Profile the port's Binary Bleed searches on the card.

``--search nmfk`` (the default) runs the paper-scale NMFk search of
``chip_smoke.py`` (V 1000 x 1100, k_true 8, k 2..16, 4 perturbations, 120
sweeps); ``--search kmeans`` runs its ``kmeans_db_1m`` (K-Means with
Davies-Bouldin on 10^6 blob points, d 6, k_true 7, k 2..24); ``--search
rescalk`` its ``rescalk_1000`` (RESCALk on X 4 x 1000 x 1000, k_true 4, k
2..11, 3 perturbations, 150 sweeps; serial and 4 threads). Each runs on
each executor (NMFk also on ``sharded``, on a one-rank NCCL mesh, and on
``elastic``, at its defaults: tol 1e-3, chunks of 25, warm starts): once to
warm up, ``--repeats`` times on the host clock, then
once under ``torch.profiler``. Prints one JSON line per executor with the
wall times, the device's busy time (the sum of the kernels' own device
time), the part of it in NCCL's kernels and the kernels that took the most
of it. Run from the root of a
checkout on a machine with a card:

    python3 tools/profile_ksearch.py [--search nmfk|kmeans|rescalk] [--src src] [--repeats 3] [--threads N]

``--src`` points at the ``src`` directory of another checkout, to profile
that version of the port with the same script.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

SEARCH = ["--n", "1000", "--m", "1100", "--k-true", "8", "--k-max", "16", "--n-perturbs", "4",
          "--nmf-iters", "120", "--device", "cuda", "--quiet"]

# kmeans_db_1m, as chip_smoke.py runs it
KM_DATA = dict(n=1_000_000, d=6, k_true=7, std=0.5, noise=0.05, spread=8.0, seed=0)
KM_SEARCH = dict(k_range=(2, 24), select_threshold=0.6, stop_threshold=1.6, mode="minimize")
KM_K_PAD, KM_MAX_ITERS = 24, 100

# rescalk_1000: chip_smoke.py's own settings (X drawn on the CPU, then moved)
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (  # noqa: E402
    RESCAL_DATA,
    RESCAL_EPS,
    RESCAL_ITERS,
    RESCAL_P,
    RESCAL_SEARCH,
    RESCAL_THREADS,
    smi_line,
)


def kmeans_db_1m(torch, x, executor: str, threads: int = 2) -> dict:
    """One kmeans_db_1m search on ``executor`` over the points x (10^6, 6):
    k_optimal and the host-clock wall, ending in a synchronize."""
    from repro_torch.core import binary_bleed_search, davies_bouldin_score
    from repro_torch.factorization.kmeans import kmeans
    from repro_torch.factorization.planes import KMeansBatchPlane

    if executor == "batched":
        evaluate = KMeansBatchPlane(x, seed=0, score="davies_bouldin", max_iters=KM_MAX_ITERS, k_pad=KM_K_PAD)
        kw = dict(executor="batched")
    else:
        def evaluate(k, should_abort=None):
            res = kmeans(x, int(k), seed=0, max_iters=KM_MAX_ITERS)
            return float(davies_bouldin_score(x, res.labels, int(k)))
        kw = dict(num_resources=threads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = binary_bleed_search(evaluate, **KM_SEARCH, **kw)
    torch.cuda.synchronize()
    return {"k_optimal": res.k_optimal, "seconds": time.perf_counter() - t0}


def rescalk_1000(torch, x, executor: str, threads: int = RESCAL_THREADS) -> dict:
    """One rescalk_1000 search on ``executor`` ("serial", or "threads" with
    ``threads`` workers) over X (4, 1000, 1000): k_optimal and the
    host-clock wall."""
    from repro_torch.core import binary_bleed_search
    from repro_torch.factorization.rescal import make_rescalk_evaluator

    evaluate = make_rescalk_evaluator(x, seed=0, n_perturbs=RESCAL_P, iters=RESCAL_ITERS, epsilon=RESCAL_EPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = binary_bleed_search(evaluate, **RESCAL_SEARCH,
                              num_resources=1 if executor == "serial" else threads)
    torch.cuda.synchronize()
    return {"k_optimal": res.k_optimal, "seconds": time.perf_counter() - t0}


def device_times(prof) -> dict[str, tuple[float, int]]:
    """Device time (ms) and count by kernel name: the events that ran on the
    device (kernels, copies, fills). A host-side op's own device time is that
    of the kernels it launched, which are listed themselves, so host-side ops
    are left out; counting both would count those kernels twice."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        self_us = getattr(e, "self_device_time_total", None)
        if self_us is None:  # older torch
            self_us = getattr(e, "self_cuda_time_total", 0.0)
        if self_us > 0:
            out[e.key] = (self_us / 1e3, e.count)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--search", choices=("nmfk", "kmeans", "rescalk"), default="nmfk")
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--threads", type=int, default=None,
                    help="workers of the threads executor (default: chip_smoke.py's, "
                    "4 for NMFk and RESCALk, 2 for K-Means)")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_ksearch: needs an NVIDIA card", file=sys.stderr)
        return 1
    if args.search == "kmeans":
        from repro_torch.factorization.synthetic import blob_data

        x, _ = blob_data(**KM_DATA, device=torch.device("cuda"))

        def run(executor):
            return kmeans_db_1m(torch, x, executor, args.threads or 2)
        executors = ("threads", "batched")
    elif args.search == "rescalk":
        from repro_torch.factorization.synthetic import rescal_data

        x = rescal_data(**RESCAL_DATA, device="cpu")[0].to(torch.device("cuda"))

        def run(executor):
            return rescalk_1000(torch, x, executor, args.threads or RESCAL_THREADS)
        executors = ("serial", "threads")
    else:
        from repro_torch.launch import ksearch

        threads = ["--resources", str(args.threads)] if args.threads else []

        def run(executor):
            return ksearch.main(SEARCH + ["--executor", executor] + (threads if executor == "threads" else []))
        executors = ("threads", "batched", "sharded", "elastic")

    for executor in executors:
        run(executor)  # warm up: kernels built and loaded, plans cached
        walls = [round(run(executor)["seconds"], 4) for _ in range(args.repeats)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = run(executor)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        times = device_times(prof)
        busy = sum(ms for ms, _ in times.values())
        top = sorted(times.items(), key=lambda kv: -kv[1][0])[: args.top]
        print(json.dumps({
            "src": args.src, "search": args.search, "executor": executor, "threads": args.threads,
            "k_optimal": out["k_optimal"],
            "wall_s": walls, "profiled_wall_s": round(wall, 4), "device_busy_ms": round(busy, 2),
            "device_busy_share": round(busy / 1e3 / wall, 4),
            "nccl_ms": round(sum(ms for name, (ms, _) in times.items() if "nccl" in name.lower()), 3),
            "top": [[name[:70], round(ms, 3), count] for name, (ms, count) in top],
        }), flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    print(smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
