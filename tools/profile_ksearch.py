#!/usr/bin/env python3
"""Profile the port's NMFk Binary Bleed search on the card.

Runs the paper-scale search of ``chip_smoke.py`` (V 1000 x 1100, k_true 8,
k 2..16, 4 perturbations, 120 sweeps) on each executor: once to warm up,
``--repeats`` times on the host clock, then once under ``torch.profiler``.
Prints one JSON line per executor with the wall times, the device's busy
time (the sum of the kernels' own device time) and the kernels that took
the most of it. Run from the root of a checkout on a machine with a card:

    python3 tools/profile_ksearch.py [--src src] [--repeats 3]

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


def device_times(prof) -> dict[str, tuple[float, int]]:
    """Self device time (ms) and count by kernel name."""
    out = {}
    for e in prof.key_averages():
        self_us = getattr(e, "self_device_time_total", None)
        if self_us is None:  # older torch
            self_us = getattr(e, "self_cuda_time_total", 0.0)
        if self_us > 0:
            out[e.key] = (self_us / 1e3, e.count)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_ksearch: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.launch import ksearch

    for executor in ("threads", "batched"):
        run = SEARCH + ["--executor", executor]
        ksearch.main(run)  # warm up: kernels built and loaded, plans cached
        walls = [round(ksearch.main(run)["seconds"], 4) for _ in range(args.repeats)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = ksearch.main(run)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        times = device_times(prof)
        busy = sum(ms for ms, _ in times.values())
        top = sorted(times.items(), key=lambda kv: -kv[1][0])[: args.top]
        print(json.dumps({
            "src": args.src, "executor": executor, "k_optimal": out["k_optimal"], "wall_s": walls,
            "profiled_wall_s": round(wall, 4), "device_busy_ms": round(busy, 2),
            "device_busy_share": round(busy / 1e3 / wall, 4),
            "top": [[name[:70], round(ms, 3), count] for name, (ms, count) in top],
        }), flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
