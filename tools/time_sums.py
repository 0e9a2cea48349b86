#!/usr/bin/env python3
"""Time the port's silhouette distance-sum wrappers on the card at the
shapes NMFk launches, and the NMFk searches that run them.

1. Runs one paper-scale NMFk search per executor (``chip_smoke.py``'s:
   V 1000 x 1100, k_true 8, k 2..16, 4 perturbations, 120 sweeps) with every
   launch of the distance-sum kernel recorded by its shape (lanes b, points
   n, y points m, dimension d, clusters k, and whether y is x), by wrapping
   ``ops._dist_sums_launch`` in this process. The threads executor calls the
   2-D wrapper, the batched one the batched wrapper. Prints the histogram
   of each executor.
2. At every recorded shape, and at the fixed shapes (52 points, k 13, 2-D;
   b 8, 64 points, k 16; both at d 1000), makes pooled near-duplicate
   columns (p = n / k copies of k components, L2-normalized, as NMFk pools
   its W columns), holds the kernel against the plain version run in
   float64 (rtol 1e-4, atol 1e-3, with the fp32 plain version's own gap
   beside), and prints one JSON line with ``ms`` (device time per call:
   CUDA events behind a spin kernel), ``plain_ms``, ``bound_ms`` (bytes
   over 3.35 TB/s against operations over 67 TFLOP/s fp32, the larger),
   ``fill_ms`` (PyTorch's ``fill_`` of an output of the same size: the
   launch floor), the launches per search of each executor, and ``bits``, a
   digest of the output's bits (the sum of its int32 views). At the fixed
   shapes also ``host_us``, the host time per call.
3. Per executor, the kernel's device time per search: the sum of launches
   x ms over its shapes.
4. Then the walls of ``--searches`` searches per executor.

``--timeline`` first builds ``silhouette_sums.cu`` with ``-DSIL_TIMELINE``
beside the usual library and, at the fixed shapes, prints where one
launch's time goes inside the kernel: per phase (first stage landed,
partial dots, partials pushed to their owners and cluster barrier,
distances, sums written) the median and largest time across blocks, from
each block's SM clock scaled by its global-timer span, and the kernel's
span and the spread of its blocks' starts on the global timer. The searches and timings then run on that build.

Run from the root of a checkout on a machine with a card:

    python3 tools/time_sums.py [--src src] [--searches 3] [--tag name] [--timeline]

``--src`` points at the ``src`` directory of another checkout, to time that
version of the port with the same script.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

from time_mu import SEARCH, device_ms, host_us

HBM_BYTES_PER_S, FP32_FLOPS_PER_S = 3.35e12, 67e12  # H100 SXM data sheet
TOL = dict(rtol=1e-4, atol=1e-3)  # the reference's distance fp32 tolerance, against float64
# (b, n, m, d, k, y is x, wrapper): the threads path's 52 points and the
# batched wave of 8 lanes
FIXED = [(1, 52, 52, 1000, 13, True, "2d"), (8, 64, 64, 1000, 16, True, "batched")]


# the thin kernel's phases (silhouette_sums.cu, -DSIL_TIMELINE), in order
PHASES = ("staged", "partials", "push_and_cluster_barrier", "distances", "sums")
STAMPS = len(PHASES) + 3  # SM clocks at entry and after each phase, global ns at entry and exit


def load_timeline_build(build) -> ctypes.CDLL:
    """Build silhouette_sums.cu with -DSIL_TIMELINE beside the usual library
    and make it the one the wrappers launch."""
    path = build.library_path("silhouette_sums")
    path = path.with_name(f"{path.stem}_timeline.so")
    if not path.is_file():
        path.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-DSIL_TIMELINE", "-o", str(path),
                        str(build.CSRC / "silhouette_sums.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in build.SIGNATURES["silhouette_sums"].items():
        getattr(lib, fn_name).argtypes = argtypes
        getattr(lib, fn_name).restype = ctypes.c_int
    lib.silhouette_timeline.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.silhouette_timeline.restype = ctypes.c_int
    build._loaded["silhouette_sums"] = lib
    return lib


def thin_blocks(b: int, n: int, d: int, sms: int) -> int:
    """Blocks of a thin launch (silhouette_sums.cu): clusters of
    min(8, ceil(d / 128)) blocks over units of 16 x rows, or 32 where 16
    would need more blocks than the card has SMs."""
    cluster = min(8, -(-d // 128))
    rows = 16 if cluster * -(-n // 16) * b <= sms else 32
    return cluster * -(-n // rows) * b


def phase_summary(stamps) -> dict:
    """Per-phase median and largest time (ns) across blocks, from rows of SM
    clocks (entry, then the end of each phase in ``PHASES``) and the global
    timer (ns) at entry and exit. A block's clocks are scaled to ns by its
    own global-timer span; ``clock_ghz`` is the median of that scale."""
    last = len(PHASES)
    rows = [r for r in stamps if 0 < r[1] and r[last] > r[0] and r[last + 2] > r[last + 1]]
    ghz = [(r[last] - r[0]) / (r[last + 2] - r[last + 1]) for r in rows]
    phases = {}
    for i, name in enumerate(PHASES):
        spans = [(r[i + 1] - r[i]) / g for r, g in zip(rows, ghz)]
        phases[name] = {"median_ns": statistics.median(spans), "max_ns": max(spans)}
    starts, ends = [r[last + 1] for r in rows], [r[last + 2] for r in rows]
    return {"blocks": len(rows), "span_ns": max(ends) - min(starts), "start_spread_ns": max(starts) - min(starts),
            "clock_ghz": statistics.median(ghz), "phases": phases}


def record_shapes(ops, run) -> collections.Counter:
    """Run ``run()`` with every distance-sum launch counted by shape."""
    hist = collections.Counter()
    launch = ops._dist_sums_launch

    def recording(x, y, onehot):
        b, n, d = x.shape
        hist[(b, n, y.shape[1], d, onehot.shape[-1], y is x or y.data_ptr() == x.data_ptr())] += 1
        return launch(x, y, onehot)

    ops._dist_sums_launch = recording
    try:
        run()
    finally:
        ops._dist_sums_launch = launch
    return hist


def operands(torch, shape, device):
    """x, y and onehot of a recorded shape (b, n, m, d, k, y is x, ...):
    p = m // k near-duplicate copies of k unit columns (the last m % k
    points take the first components again), labels by component; y is x
    when recorded so, else other columns of the same kind."""
    b, n, m, d, k, same = shape[:6]
    gen = torch.Generator(device=device)
    gen.manual_seed(3)

    def pooled(points):
        base = torch.rand((b, 1, k, d), device=device, generator=gen)
        reps = -(-points // k)
        cols = (base + 0.01 * torch.rand((b, reps, k, d), device=device, generator=gen)).reshape(b, reps * k, d)
        return (cols / cols.norm(dim=-1, keepdim=True))[:, :points].contiguous()

    x = pooled(n)
    y = x if same else pooled(m)
    labels = torch.arange(m, device=device) % k
    onehot = torch.nn.functional.one_hot(labels, k).float().expand(b, m, k).contiguous()
    return x, y, onehot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--searches", type=int, default=3)
    ap.add_argument("--tag", default=None, help="label of this version in the output (default: --src)")
    ap.add_argument("--timeline", action="store_true", help="time the thin kernel's phases (a -DSIL_TIMELINE build)")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("time_sums: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import ksearch

    tag = args.tag or args.src
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"tag": tag, "card": smi, "torch": torch.__version__}), flush=True)
    if args.timeline:
        lib = load_timeline_build(build)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for shape in FIXED:
            b, n, m, d, k, same, wrapper = shape
            x, _, onehot = operands(torch, shape, dev)
            for _ in range(3):  # warm: the last launch's stamps are read
                ops.silhouette_dist_sums_batched(x, onehot)
            torch.cuda.synchronize()
            blocks = thin_blocks(b, n, d, sms)
            host = (ctypes.c_ulonglong * (STAMPS * blocks))()
            if lib.silhouette_timeline(ctypes.addressof(host), blocks) != 0:
                raise RuntimeError("silhouette_timeline failed")
            stamps = [host[STAMPS * i:STAMPS * (i + 1)] for i in range(blocks)]
            print(json.dumps({"tag": tag, "timeline": dict(zip(("b", "n", "m", "d", "k"), shape[:5])),
                              **phase_summary(stamps)}), flush=True)
    executors = ("threads", "batched")
    wrapper_of = {"threads": "2d", "batched": "batched"}
    for executor in executors:
        ksearch.main(SEARCH + ["--executor", executor])  # warm up: kernels built and loaded
    hists = {ex: record_shapes(ops, lambda ex=ex: ksearch.main(SEARCH + ["--executor", ex])) for ex in executors}
    for ex, hist in hists.items():
        print(json.dumps({"tag": tag, "histogram": ex, "launches": sum(hist.values()),
                          "shapes": [[*shape, count] for shape, count in sorted(hist.items())]}), flush=True)

    per_search = dict.fromkeys(executors, 0.0)
    recorded = sorted({(*s, wrapper_of[ex]) for ex in executors for s in hists[ex]})
    for shape in list(dict.fromkeys(FIXED + recorded)):
        b, n, m, d, k, same, wrapper = shape
        x, y, onehot = operands(torch, shape, dev)
        if wrapper == "2d":
            x, y, onehot = x[0], (x[0] if same else y[0]), onehot[0]
            fn = ops.silhouette_dist_sums
        else:
            fn = ops.silhouette_dist_sums_batched
        call = (lambda: fn(x, onehot)) if same else (lambda: fn(x, onehot, y))
        got = call()
        want = ref.silhouette_dist_sums(x.double(), onehot.double(), y.double())
        torch.testing.assert_close(got.double(), want, **TOL)
        plain32_err = float((ref.silhouette_dist_sums(x, onehot, y).double() - want).abs().max())
        n_bytes = 4 * b * (n * d + (0 if same else m * d) + m * k + n * k)
        flops = b * (2 * n * m * d + 2 * (n + (0 if same else m)) * d + 5 * n * m + 2 * n * m * k)
        out = torch.empty_like(got)
        launches = {ex: hists[ex][shape[:6]] if wrapper == wrapper_of[ex] else 0 for ex in executors}
        entry = {
            "tag": tag, "shape": dict(zip(("b", "n", "m", "d", "k", "y_is_x", "wrapper"), shape)),
            "ms": device_ms(torch, call),
            "plain_ms": device_ms(torch, lambda: ref.silhouette_dist_sums(x, onehot, y)),
            "bound_ms": max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3,
            "fill_ms": device_ms(torch, lambda: out.fill_(1.0)),
            "max_abs_err_vs_fp64": float((got.double() - want).abs().max()), "plain_fp32_err_vs_fp64": plain32_err,
            "launches": launches, "bits": int(got.view(torch.int32).sum(dtype=torch.int64)),
        }
        if shape in FIXED:
            entry["host_us"] = host_us(torch, call)
        for ex in executors:
            per_search[ex] += launches[ex] * entry["ms"]
        print(json.dumps(entry), flush=True)
    print(json.dumps({"tag": tag, "sums_device_ms_per_search": per_search}), flush=True)

    for ex in executors if args.searches else ():
        results = [ksearch.main(SEARCH + ["--executor", ex]) for _ in range(args.searches)]
        print(json.dumps({"tag": tag, "search": f"nmfk_paper {ex}", "k_optimal": [r["k_optimal"] for r in results],
                          "wall_s": [r["seconds"] for r in results]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
