#!/usr/bin/env python3
"""Time the port's pairwise wrappers on the card at the shapes K-Means
launches, and the K-Means searches that run them.

1. Runs one ``kmeans_db_1m`` search per executor (``chip_smoke.py``'s:
   10^6 blob points, d 6, k 2..24) with every launch of the pairwise kernel
   recorded by its shape (lanes, n, m, d, and whether x and y are 2-D,
   i.e. shared by the lanes), by wrapping ``ops._pairwise_launch`` in this
   process. Prints the histogram of each executor.
2. At every recorded shape, and at the fixed shapes (one lane and 16 lanes
   at m = 24 with x shared, one lane at m = 2, 7, 13), holds the kernel
   against the plain version (rtol 1e-4, atol 1e-3) and prints one JSON
   line with ``ms`` (device time per call: CUDA events behind a spin
   kernel), ``plain_ms``, ``cdist_ms`` (``torch.cdist``, which computes the
   square root of the same D^2 in one call), ``bound_ms`` (bytes over
   3.35 TB/s against operations over 67 TFLOP/s fp32, the larger), the
   launches per search of each executor, and ``bits``, a digest of the
   output's bits (the sum of its int32 views), so two versions can be
   compared bit for bit. At the fixed shapes also ``host_us``, the host
   time per call, and ``fill_ms``, the time PyTorch's fill kernel takes to
   write an output of the same size: the write rate the card reaches.
3. Per executor, the pairwise kernel's device time per search: the sum of
   launches x ms over its shapes.
4. Then the walls of ``--searches`` searches per executor.

Run from the root of a checkout on a machine with a card:

    python3 tools/time_pairwise.py [--src src] [--searches 3] [--tag name]

``--src`` points at the ``src`` directory of another checkout, to time that
version of the port with the same script.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

from profile_ksearch import KM_DATA, kmeans_db_1m
from time_mu import device_ms, host_us

HBM_BYTES_PER_S, FP32_FLOPS_PER_S = 3.35e12, 67e12  # H100 SXM data sheet
TOL = dict(rtol=1e-4, atol=1e-3)  # the reference's pairwise fp32 tolerance
# (lanes, n, m, d, x.dim(), y.dim()): the batched path's one-lane and full
# 16-lane waves, and the threads path at three of its k
FIXED = [(1, 10**6, 24, 6, 2, 3), (16, 10**6, 24, 6, 2, 3)] + [(1, 10**6, m, 6, 2, 2) for m in (2, 7, 13)]


def record_shapes(ops, run) -> collections.Counter:
    """Run ``run()`` with every pairwise launch counted by shape."""
    hist = collections.Counter()
    launch = ops._pairwise_launch

    def recording(x, y, lanes):
        hist[(lanes, x.shape[-2], y.shape[-2], x.shape[-1], x.dim(), y.dim())] += 1
        return launch(x, y, lanes)

    ops._pairwise_launch = recording
    try:
        run()
    finally:
        ops._pairwise_launch = launch
    return hist


def operands(torch, points, shape):
    """x and y of a recorded shape: x the first n blob points (per lane when
    3-D), y centroid slots near data points, as k-means++ and Lloyd place them."""
    lanes, n, m, d, x_dim, y_dim = shape
    gen = torch.Generator(device=points.device)
    gen.manual_seed(5)
    x = points[:n, :d]
    if x_dim == 3:
        x = x.expand(lanes, n, d)
    pick = torch.randint(0, points.shape[0], (lanes if y_dim == 3 else 1, m), device=points.device, generator=gen)
    y = points[pick][..., :d] + 0.1 * torch.randn((pick.shape[0], m, d), device=points.device, generator=gen)
    return x.contiguous(), (y if y_dim == 3 else y[0]).contiguous()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--searches", type=int, default=3)
    ap.add_argument("--tag", default=None, help="label of this version in the output (default: --src)")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("time_pairwise: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.factorization.synthetic import blob_data
    from repro_torch.kernels import ops, ref

    tag = args.tag or args.src
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"tag": tag, "card": smi, "torch": torch.__version__}), flush=True)
    points, _ = blob_data(**KM_DATA, device=torch.device("cuda"))
    executors = ("threads", "batched")
    for executor in executors:
        kmeans_db_1m(torch, points, executor)  # warm up: kernels built and loaded
    hists = {ex: record_shapes(ops, lambda ex=ex: kmeans_db_1m(torch, points, ex)) for ex in executors}
    for ex, hist in hists.items():
        print(json.dumps({"tag": tag, "histogram": ex, "launches": sum(hist.values()),
                          "shapes": [[*shape, count] for shape, count in sorted(hist.items())]}), flush=True)

    per_search = dict.fromkeys(executors, 0.0)
    shapes = list(dict.fromkeys(FIXED + sorted(set(hists["threads"]) | set(hists["batched"]))))
    for shape in shapes:
        lanes, n, m, d, x_dim, y_dim = shape
        x, y = operands(torch, points, shape)
        fn = ops.pairwise_sq_dists if x_dim == y_dim == 2 else ops.pairwise_sq_dists_batched
        got = fn(x, y)
        torch.testing.assert_close(got, ref.pairwise_sq_dists(x, y), **TOL)
        bits = int(got.view(torch.int32).sum(dtype=torch.int64))
        del got
        n_bytes = 4 * (x.numel() + y.numel() + lanes * n * m)
        flops = lanes * n * m * (2 * d + 3) + 2 * x.numel() + 2 * y.numel()
        x_lib = x.expand(lanes, n, d) if x_dim == 2 and y_dim == 3 else x
        entry = {
            "tag": tag, "shape": dict(zip(("lanes", "n", "m", "d", "x_dim", "y_dim"), shape)),
            "ms": device_ms(torch, lambda: fn(x, y)),
            "plain_ms": device_ms(torch, lambda: ref.pairwise_sq_dists(x, y)),
            "cdist_ms": device_ms(torch, lambda: torch.cdist(x_lib, y, compute_mode="use_mm_for_euclid_dist")),
            "bound_ms": max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3,
            "launches": {ex: hists[ex][shape] for ex in executors}, "bits": bits,
        }
        if shape in FIXED:
            entry["host_us"] = host_us(torch, lambda: fn(x, y))
            out = torch.empty((lanes, n, m), device=x.device)
            entry["fill_ms"] = device_ms(torch, lambda: out.fill_(1.0))
            del out
        for ex in executors:
            per_search[ex] += entry["launches"][ex] * entry["ms"]
        print(json.dumps(entry), flush=True)
        del x, y
    print(json.dumps({"tag": tag, "pairwise_device_ms_per_search": per_search}), flush=True)

    for ex in executors if args.searches else ():
        results = [kmeans_db_1m(torch, points, ex) for _ in range(args.searches)]
        print(json.dumps({"tag": tag, "search": f"kmeans_db_1m {ex}", "k_optimal": [r["k_optimal"] for r in results],
                          "wall_s": [r["seconds"] for r in results]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
