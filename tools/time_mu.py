#!/usr/bin/env python3
"""Time the port's MU wrappers on the card, and the NMFk searches that run them.

For ``mu_update_h`` and ``mu_update_w`` at the three main-path shapes (the
batched wave, L=32, the elastic executor's full lane batch, L=8, and the
threads executor, L=4, all at V 1000 x 1100, k=16), with V, W and H at
``--dtype`` (float32, or bfloat16: the wrappers' bf16 kernels), prints one
JSON line each with:

- ``ms``: the wrapper's device time per call, its G or Q ``bmm`` included
  (CUDA events behind a spin kernel, as ``chip_smoke.py`` times it);
- ``host_us``: the wrapper's host time per call, the median of five
  rounds of back-to-back calls queued behind a spin kernel (so the host
  never waits for the device);
- ``plain_ms``: the plain PyTorch version's device time;
- ``bound_ms``, ``bound_by``: the least time the card could take,
  ``chip_smoke.mu_bound`` (each input read and the output written once
  over 3.35 TB/s, or the operations over 67 TFLOP/s fp32 (at bf16 the
  products over 989 TFLOP/s of bf16), the larger).

Each wrapper is first held against its plain version at the reference's
MU tolerance of the dtype (3e-5 fp32, 2e-2 bf16).

Then the wall times of ``--searches`` paper-scale NMFk searches (the
search of ``chip_smoke.py``, at bf16 its ``nmfk_paper_bf16`` through the
API) on each executor (``elastic`` at its defaults: tol 1e-3, chunks of
25, warm starts), after one warm-up. Run from the root of a checkout on
a machine with a card:

    python3 tools/time_mu.py [--dtype float32|bfloat16] [--src src] [--searches 3] [--tag name] [--no-tma]

``--src`` points at the ``src`` directory of another checkout, to time that
version of the port with the same script. ``--no-tma`` builds the MU kernels
with ``-DMU_NO_TMA``, so every stage takes the cp.async copy path instead
of tensor-memory-accelerator boxes. ``--digests`` first prints, for both
wrappers at ``DIGEST_SHAPES`` (ranks up to 128, the tiled kernels), a
digest of the output's bits (the sum of its int32 views) on inputs made
with numpy from a seed, as ``tests/test_torch_cuda.py`` makes them, so two
versions can be compared bit for bit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import NMFK_PAPER, mu_bound, nmfk_api_search  # noqa: E402  (as chip_smoke.py reports and searches)

SEARCH = ["--n", "1000", "--m", "1100", "--k-true", "8", "--k-max", "16", "--n-perturbs", "4",
          "--nmf-iters", "120", "--device", "cuda", "--quiet"]
SHAPES = [(32, 1000, 1100, 16), (8, 1000, 1100, 16), (4, 1000, 1100, 16)]  # (L, n, m, k)
DIGEST_SHAPES = [(32, 1000, 1100, 16), (4, 1000, 1100, 16), (4, 129, 257, 13), (2, 300, 520, 100),
                 (6, 100, 90, 13), (2, 70, 50, 33), (2, 300, 320, 128)]
MU_TOL = {"float32": dict(rtol=3e-5, atol=3e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}  # chip_smoke's


def digests(torch, ops, dtype=None) -> dict[tuple, list[int]]:
    """Output-bit digests of both MU wrappers at ``DIGEST_SHAPES``: V in
    U[0, 1), W and H in U[0.1, 1) from numpy's generator seeded with the
    sum of the shape, the last two ranks masked to zero, then cast to
    ``dtype`` (default float32); the sum of the output's int32 (int16 at
    bf16) views."""
    import numpy as np

    dtype = dtype or torch.float32
    out = {}
    for shape in DIGEST_SHAPES:
        lanes, n, m, k = shape
        rng = np.random.default_rng(sum(shape))
        v = rng.uniform(0.0, 1.0, (lanes, n, m)).astype(np.float32)
        w = rng.uniform(0.1, 1.0, (lanes, n, k)).astype(np.float32)
        h = rng.uniform(0.1, 1.0, (lanes, k, m)).astype(np.float32)
        w[..., :, k - 2:] = 0.0
        h[..., k - 2:, :] = 0.0
        v, w, h = (torch.from_numpy(a).cuda().to(dtype) for a in (v, w, h))
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        out[shape] = [int(fn(v, w, h).view(bits).sum(dtype=torch.int64)) for fn in (ops.mu_update_h, ops.mu_update_w)]
    return out


def device_ms(torch, fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_us(torch, fn, reps: int = 100, rounds: int = 5) -> float:
    for _ in range(3):
        fn()
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)  # ~0.1 s: longer than the host takes to queue every call
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per_call.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def load_without_tma(build) -> None:
    """Build nmf_update.cu with -DMU_NO_TMA beside the usual library and
    make it the one the wrappers launch."""
    path = build.library_path("nmf_update")
    path = path.with_name(f"{path.stem}_no_tma.so")
    if not path.is_file():
        path.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-DMU_NO_TMA", "-o", str(path),
                        str(build.CSRC / "nmf_update.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in build.SIGNATURES["nmf_update"].items():
        getattr(lib, fn_name).argtypes = argtypes
        getattr(lib, fn_name).restype = ctypes.c_int
    build._loaded["nmf_update"] = lib


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--searches", type=int, default=3)
    ap.add_argument("--tag", default=None, help="label of this version in the output (default: --src)")
    ap.add_argument("--no-tma", action="store_true", help="time the MU kernels' cp.async copy path alone")
    ap.add_argument("--digests", action="store_true", help="first print output-bit digests at DIGEST_SHAPES")
    ap.add_argument("--dtype", choices=sorted(MU_TOL), default="float32", help="V, W and H's dtype")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("time_mu: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import ksearch

    if args.no_tma:
        load_without_tma(build)
    tag = args.tag or args.src
    dtype = getattr(torch, args.dtype)
    if args.digests:
        for shape, bits in digests(torch, ops, dtype).items():
            print(json.dumps({"tag": tag, "dtype": args.dtype, "digest": dict(zip(("L", "n", "m", "k"), shape)),
                              "bits": bits}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for lanes, n, m, k in SHAPES:
        v = torch.rand((lanes, n, m), device="cuda", generator=gen).to(dtype)
        w = (torch.rand((lanes, n, k), device="cuda", generator=gen) + 0.1).to(dtype)
        h = (torch.rand((lanes, k, m), device="cuda", generator=gen) + 0.1).to(dtype)
        for name, fn, plain in (("mu_update_h", ops.mu_update_h, ref.mu_update_h),
                                ("mu_update_w", ops.mu_update_w, ref.mu_update_w)):
            torch.testing.assert_close(fn(v, w, h).float(), plain(v, w, h).float(), **MU_TOL[args.dtype])
            b_ms, b_by = mu_bound(name[-1], lanes, n, m, k, v.element_size())
            print(json.dumps({
                "tag": tag, "dtype": args.dtype, "wrapper": name, "shape": {"L": lanes, "n": n, "m": m, "k": k},
                "ms": device_ms(torch, lambda: fn(v, w, h)),
                "host_us": host_us(torch, lambda: fn(v, w, h)),
                "plain_ms": device_ms(torch, lambda: plain(v, w, h)),
                "bound_ms": b_ms, "bound_by": b_by,
            }), flush=True)
    for executor in ("threads", "batched", "elastic") if args.searches else ():
        if dtype == torch.float32:
            run = SEARCH + ["--executor", executor]
            ksearch.main(run)  # warm up
            results = [ksearch.main(run) for _ in range(args.searches)]
            k_opt, walls = [r["k_optimal"] for r in results], [r["seconds"] for r in results]
        else:  # the launcher has no dtype: chip_smoke's bf16 search through the API
            from repro_torch.factorization.synthetic import nmf_data

            v = nmf_data(NMFK_PAPER["n"], NMFK_PAPER["m"], NMFK_PAPER["k_true"], seed=0, device="cuda",
                         dtype=dtype)[0]
            nmfk_api_search(v, executor)  # warm up
            k_opt, walls = [], []
            for _ in range(args.searches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                k_opt.append(nmfk_api_search(v, executor)[0].k_optimal)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        print(json.dumps({"tag": tag, "dtype": args.dtype, "search": executor, "k_optimal": k_opt,
                          "wall_s": walls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
