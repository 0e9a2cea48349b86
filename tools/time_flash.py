#!/usr/bin/env python3
"""Time the port's flash-attention wrapper on the card at the serve paths'
prefill shapes and at h2o-danube-1.8b's heads.

At each shape of ``SHAPES`` (qwen2-0.5b prefill: B 4, Hq 14, Hk 2, L 1000,
D 64, causal; h2o-danube-1.8b: B 1, Hq 32, Hk 8, L 6000, D 80, causal,
window 4096; granite-moe-1b-a400m prefill: B 4, Hq 16, Hk 8, L 1000, D 64,
causal; jamba-v0.1-52b prefill: B 4, Hq 32, Hk 8, L 1024, D 128, causal)
makes q, k and v on the card from a seed at ``--dtype`` (float32: the
split-TF32 kernel; bfloat16: the bf16 one), holds the wrapper against the
plain version at the reference's flash tolerance of that dtype (rtol and
atol 3e-5; 3e-2 at bf16), and prints one JSON line with:

- ``ms``: device time per call (CUDA events behind a spin kernel), and
  ``host_us``, the host time per call;
- ``plain_ms``: the plain PyTorch version; ``sdpa_ms``: one
  ``F.scaled_dot_product_attention`` call at the same dtype
  (``enable_gqa``; the window as an explicit mask); ``fill_ms``: a
  ``fill_`` of the output, the launch floor;
- the bounds, each the larger of the bytes (q, k, v read, out written, at
  the dtype's size) over 3.35 TB/s and the live pairs' multiply-adds over
  a peak (H100 SXM data sheet): at fp32 ``bound_fp32_ms`` (67 TFLOP/s of
  fp32 on CUDA cores) and ``bound_3xtf32_ms`` (three times the operations
  over 495 TFLOP/s of TF32 on the tensor cores); at bf16
  ``bound_bf16_ms`` (989 TFLOP/s of dense bf16);
- ``max_abs_err`` against the plain version and ``max_abs_err_vs_fp64``
  against the plain version in float64, with the plain version's own
  ``plain_err_vs_fp64`` beside; ``bits``, a digest of the output's bits
  (the sum of its int32 views, of its int16 views at bf16), to compare
  versions and repeated calls.

Run from the root of a checkout on a machine with a card:

    python3 tools/time_flash.py [--dtype float32|bfloat16] [--src src] [--tag name]

``--src`` points at the ``src`` directory of another checkout, to time that
version of the port with the same script; compare two versions by running
the script for each in turn (parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from time_mu import device_ms, host_us

HBM_BYTES_PER_S, FP32_FLOPS_PER_S, TF32_FLOPS_PER_S = 3.35e12, 67e12, 495e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 on the tensor cores (the same data sheet)
# the reference's flash tolerances (tests/test_kernels.py::test_flash_attention, ..._bf16)
FLASH_TOL = {"float32": dict(rtol=3e-5, atol=3e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# (label, B, Hq, Hk, Lq, Lk, D, causal, window)
SHAPES = [
    ("qwen2-0.5b prefill", 4, 14, 2, 1000, 1000, 64, True, None),
    ("h2o-danube-1.8b heads", 1, 32, 8, 6000, 6000, 80, True, 4096),
    ("granite-moe-1b-a400m prefill", 4, 16, 8, 1000, 1000, 64, True, None),
    ("jamba-v0.1-52b prefill", 4, 32, 8, 1024, 1024, 128, True, None),
]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--tag", default=None, help="label of this version in the output (default: --src)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--dtype", choices=sorted(FLASH_TOL), default="float32",
                    help="q, k and v's dtype: the split-TF32 kernel or the bf16 one")
    return ap.parse_args(argv)


def live_pairs(lq: int, lk: int, causal: bool, window: int | None, q_offset: int = 0) -> int:
    """(query, key) pairs the masks leave live, query row i at position
    ``q_offset + i`` (the kernel's and the plain version's convention): the
    work these inputs need."""
    total = 0
    for i in range(lq):
        pos = q_offset + i
        hi = min(pos, lk - 1) if causal else lk - 1
        lo = max(0, pos - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def work(b: int, hq: int, hk: int, lq: int, lk: int, d: int, causal: bool, window: int | None,
         elem: int = 4) -> tuple[int, int]:
    """(flops, bytes) of one call: q.k and p.v multiply-adds on the live
    pairs; q, k, v read once and out written once, ``elem`` bytes an
    element (4 fp32, 2 bf16)."""
    flops = 4 * b * hq * d * live_pairs(lq, lk, causal, window)
    n_bytes = elem * (2 * b * hq * lq * d + 2 * b * hk * lk * d)
    return flops, n_bytes


def bounds(flops: int, n_bytes: int, dtype: str = "float32") -> dict[str, float]:
    """The least time (ms) for the work, each the larger of bytes and
    operations: at fp32 on CUDA cores, and split TF32 (three products) on
    the tensor cores; at bf16 on the bf16 tensor cores."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    if dtype == "bfloat16":
        return {"bound_bf16_ms": max(t_bytes, flops / BF16_FLOPS_PER_S * 1e3)}
    return {
        "bound_fp32_ms": max(t_bytes, flops / FP32_FLOPS_PER_S * 1e3),
        "bound_3xtf32_ms": max(t_bytes, 3 * flops / TF32_FLOPS_PER_S * 1e3),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_flash: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops, ref

    tag = args.tag or args.src
    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"tag": tag, "card": smi, "torch": torch.__version__, "dtype": args.dtype}), flush=True)

    for label, b, hq, hk, lq, lk, d, causal, window in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        q = torch.randn((b, hq, lq, d), device=dev, generator=gen).to(dtype)
        k = torch.randn((b, hk, lk, d), device=dev, generator=gen).to(dtype)
        v = torch.randn((b, hk, lk, d), device=dev, generator=gen).to(dtype)

        def call():
            return ops.flash_attention(q, k, v, causal=causal, window=window)

        got = call()
        plain = ref.attention(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), plain.float(), **FLASH_TOL[args.dtype])
        again = call()
        err64 = plain_err64 = 0.0
        group = hq // hk
        for kh in range(hk):  # float64 one kv head at a time (bounded memory)
            hs = slice(kh * group, (kh + 1) * group)
            want = ref.attention(q[:, hs].double(), k[:, kh:kh + 1].double(), v[:, kh:kh + 1].double(),
                                 causal=causal, window=window)
            err64 = max(err64, float((got[:, hs].double() - want).abs().max()))
            plain_err64 = max(plain_err64, float((plain[:, hs].double() - want).abs().max()))
            del want
        if window is None:
            sdpa_kw = dict(is_causal=causal)
        else:  # SDPA takes a window only as an explicit mask
            i = torch.arange(lq, device=dev)
            sdpa_kw = dict(attn_mask=(i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window))
        flops, n_bytes = work(b, hq, hk, lq, lk, d, causal, window, got.element_size())
        out = torch.empty_like(got)
        entry = {
            "tag": tag, "dtype": args.dtype, "shape": label, "dims": [b, hq, hk, lq, lk, d, causal, window],
            "ms": device_ms(torch, call),
            "host_us": host_us(torch, call, reps=20),
            "plain_ms": device_ms(torch, lambda: ref.attention(q, k, v, causal=causal, window=window), reps=5),
            "sdpa_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **sdpa_kw),
                                 reps=5),
            "fill_ms": device_ms(torch, lambda: out.fill_(1.0)),
            **bounds(flops, n_bytes, args.dtype), "flops": flops, "bytes": n_bytes,
            "max_abs_err": float((got.float() - plain.float()).abs().max()), "max_abs_err_vs_fp64": err64,
            "plain_err_vs_fp64": plain_err64,
            "bits": int(got.view(torch.int32 if got.element_size() == 4 else torch.int16).sum(dtype=torch.int64)),
            "repeat_bitwise": bool(torch.equal(got, again)),
        }
        print(json.dumps(entry), flush=True)
        del q, k, v, got, again, plain, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
