#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

On a machine with four, ``python3 chip_smoke.py --multi-rank-only`` builds
the kernels and runs only the 4-rank searches of phase 5 and the one-rank
searches they are compared with.

Phases, each fatal on failure:

  1. print the card (nvidia-smi name and power limit, torch device name);
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc,
     one process per source, all at once (build time and ``-Xptxas -v``:
     registers, shared memory, spills);
  3. hold each kernel wrapper against its plain PyTorch version on the card
     at the shapes of the main paths, with the tolerance stated, and time
     kernel, plain version, the card's bound and, where one PyTorch call
     computes the same function, that call (CUDA events, warmed up); the
     flash kernel's cases also assert a bitwise repeat;
  4. hold the batched NMFk score, the elastic NMFk plane (ks 2..8 drained
     at tol 0, with and without warm starts: scores, sweep counts and
     warm-start hits), the K-Means + Davies-Bouldin search of
     ``tests/test_integration.py`` with a small K-Means silhouette wave, and
     the LM's prefill and greedy decode (qwen2-0.5b and granite-moe-1b-a400m
     at full width cut to 2 layers; deepseek-v2 at full widths cut to 2
     layers and 16 routed experts, MLA with no flash launch; reduced
     h2o-danube, whose window bites) on the card against the same
     computation on the CPU (plain versions, same draws and weights), every
     MoE route held to the CPU's on the CPU's layer input (a token may
     route differently only at a near-tie of its k-th and (k+1)-th
     probabilities, printed with its margin); LM training at the same cut
     (qwen2 and granite, B 2, L 32): the loss, the router aux loss and
     every parameter's gradient against the CPU's (each nonzero on the
     card), remat ``full`` and ``dots`` against ``none``, the routes; on
     qwen2 also 2 microbatches against 1, one AdamW step on the same
     gradients, a bitwise checkpoint round trip of (params, opt state), no
     flash launch, and the flash wrapper refusing an operand that requires
     grad;
     then RESCAL and RESCALk (96 entities, 3 relations, k 2..6) and the
     distributed fits on a one-rank NCCL group (``distributed_nmf`` sync and
     pipelined, bitwise equal at one rank; ``distributed_rescal``; the
     masked body against the single-device masked fit) against the CPU;
     then the sharded planes on a one-rank ``(lane, data)`` NCCL mesh
     against the unsharded ones on the card (``nmfk_score_sharded`` sync and
     pipelined bitwise; ``KMeansBatchPlane(mesh=)`` labels and scores; the
     elastic plane drained at tol 0: scores, sweep counts, warm-start hits);
  5. run each main path with every launch count set to 0 just before it and
     read just after, asserting the answer and that the run went through
     its kernels: the paper-scale NMFk search (V 1000x1100, k_true 8,
     k 2..16, 4 perturbations, 120 sweeps) through the port's ``ksearch``
     on the ``batched`` and ``threads`` executors (k_optimal 8), then on
     the ``elastic`` executor twice: at tol 0 without warm starts (the
     draw-for-draw oracle: each visited k's score against the batched
     plane's) and at its defaults (tol 1e-3, warm starts), each with
     k_optimal 8 and sweeps run + saved == the fixed-iteration total;
     ``nmfk_distributed_fit``: the same search on ``threads`` with
     ``--distributed-fit --resources 2`` (each worker's one-rank NCCL group
     runs ``distributed_nmf`` for every k it scores; k_optimal 8);
     ``nmfk_elastic_mesh``: the elastic defaults on a one-rank NCCL mesh
     (``--lanes 1``; the ``nmfk_elastic`` run's scores, sweeps and warm-start
     hits); ``nmfk_sharded``: the same search on ``--executor sharded --comm
     sync`` (a one-rank NCCL mesh; k_optimal 8); with 4 or more cards also
     ``torchrun`` runs at 4 ranks (sharded ``--lanes 4``, then ``--lanes 2
     --data-shards 2`` sync and pipelined, and elastic ``--lanes 2
     --data-shards 2``; every rank the same result, k_optimal 8), else one
     line saying they were not made;
     ``rescalk_1000``: Binary Bleed over RESCALk (§IV-C's RESCAL setup of
     ``benchmarks/bench_distributed.py`` at 1000 entities, 4 relations,
     k_true 4, k 2..11) on the serial and the threads executor (k_optimal 4);
     ``kmeans_db_1m`` — Binary Bleed over K-Means with Davies-Bouldin on
     10^6 blob points (d 6, k_true 7, k 2..24) — on the scalar executor (two
     threads) and the batched one (k_optimal 7); then the port's ``serve``
     with qwen2-0.5b and with granite-moe-1b-a400m at their published widths
     (24 layers, random weights from seed 0), 4 prompts of 1000 tokens, 32
     new tokens: one flash launch per layer, finite logits, and decode-step
     logits (plain attention over the cache) matching a flash prefill of the
     extended sequence in every row that kept all its MoE slots (each
     prefill's dropped slots printed); ``deepseek_serve_2l``: deepseek-v2 at
     its published widths (160 routed and 2 shared experts) cut to 2 layers,
     on the card only, B 1, prompt 256, 8 tokens: no kernel launch, the
     absorbed MLA decode's logits against the expanded forward, peak memory;
     then the port's ``train`` with qwen2-0.5b and with granite-moe-1b-a400m
     at their published widths (24 layers, fp32, random weights from seed 0),
     12 steps of B 8, L 64 in 2 microbatches: finite losses and gradient
     norms, the last loss below the first, no kernel launch (training takes
     plain attention), the median step time, tokens/s and peak memory logged
     (``qwen2_train``, ``granite_train``).

The second-to-last line is ``{"kernels": [...]}`` and the last line is
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout of
the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): HBM3, fp32 on CUDA cores, dense TF32 on tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12

MU_TOL = dict(rtol=3e-5, atol=3e-5)  # the reference's own MU kernel tolerance (fp32)
SUMS_TOL = dict(rtol=1e-4, atol=1e-3)  # the reference's distance tolerance (fp32)
NMFK_SIL_ATOL = 2e-3  # 120 sweeps of kernel vs plain arithmetic, then the greedy scorer
NMFK_ERR_RTOL = 1e-3  # the reference's kernel-vs-jnp tolerance for a whole fit
PAIRWISE_TOL = dict(rtol=1e-4, atol=1e-3)  # the reference's pairwise fp32 tolerance
# Davies-Bouldin's centroid separation sqrt(|c_i|^2 + |c_j|^2 - 2 c_i.c_j)
# is a cancellation at a k that splits a blob; two fp32 evaluation orders
# of the same labels differ there by ~1e-4 (tests/test_torch_kmeans.py).
# The fits must agree label for label; the scores are held at that floor.
KM_DB_RTOL = 5e-4
KM_SIL_ATOL = 1e-3  # the silhouette's self-distance is sqrt of fp32 noise (SUMS_TOL)

# kmeans_db_1m: examples/kmeans_earlystop.py with 10^6 points. One
# k-means++ draw per k (the paper's method) can put two seeds in one blob;
# at data seed 1 it did so at k = 7 and the search chose 6. At seed 0 the
# draws of seed 0 resolve every planted blob (their separation is logged).
KM_DATA = dict(n=1_000_000, d=6, k_true=7, std=0.5, noise=0.05, spread=8.0, seed=0)
KM_SEARCH = dict(k_range=(2, 24), select_threshold=0.6, stop_threshold=1.6, mode="minimize")
KM_K_PAD, KM_MAX_ITERS, KM_WAVE = 24, 100, 16

FLASH_TOL = dict(rtol=3e-5, atol=3e-5)  # the reference's flash tolerance (tests/test_kernels.py)
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)  # the reference's decode-vs-forward tolerance (tests/test_models.py)
# MoE routes, card against CPU on the same layer input: only the router's fp32
# matmul and softmax differ in reduction order, which moves a probability by
# up to 3.3e-7 on an H100 (granite, d 1024). A token may take
# other experts on the card only where its k-th and (k+1)-th probabilities
# are closer than this; a probability gap above half of it fails.
ROUTE_TIE_TOL = 1e-5
# deepseek-v2 card vs CPU: 16 of the 160 routed experts keep the CPU copy at
# 1.96 B parameters (7.8 GB) instead of 5.36 B
DEEPSEEK_SMALL_EXPERTS = 16

# RESCAL card vs CPU: cuBLAS against the CPU's BLAS, fp32, from the same
# draws. Held where NMFk is held (NMFK_SIL_ATOL, NMFK_ERR_RTOL); the
# factors, well determined at k_true, at the same relative tolerance.
RESCAL_SIL_ATOL = NMFK_SIL_ATOL
RESCAL_RTOL = NMFK_ERR_RTOL
# Distributed fits at one rank, card vs CPU: the same products, TF32 off.
DIST_RTOL = NMFK_ERR_RTOL

# rescalk_1000: benchmarks/bench_distributed.py's RESCAL setup (§IV-C:
# 4 relations, k_true 4, noise 0.003, k 2..11, select 0.8, stop 0.25, P 3,
# 150 sweeps, eps 0.015) with the entities raised from 80 to 1000. X is
# drawn on the CPU and moved to the card, so the reference's search can be
# run on the same X (PERF.md: both choose 4).
RESCAL_DATA = dict(n_entities=1000, n_relations=4, k_true=4, noise=0.003, seed=0)
RESCAL_SEARCH = dict(k_range=(2, 11), select_threshold=0.8, stop_threshold=0.25)
RESCAL_P, RESCAL_ITERS, RESCAL_EPS, RESCAL_THREADS = 3, 150, 0.015, 4

# the serve paths: qwen2-0.5b and granite-moe-1b-a400m at their published
# widths, weights from seed 0, 4 prompts of 1000 tokens, 32 new tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 1000, 32


def serve_args(arch: str) -> list[str]:
    return ["--arch", arch, "--no-reduced", "--batch", str(SERVE_BATCH), "--prompt-len", str(SERVE_PROMPT),
            "--tokens", str(SERVE_TOKENS), "--device", "cuda", "--seed", "0", "--quiet"]


# deepseek-v2 at its published widths (160 routed + 2 shared experts) cut to
# 2 layers, on the card only: B 1, prompt 256, 8 new tokens
DEEPSEEK_LAYERS, DEEPSEEK_PROMPT, DEEPSEEK_TOKENS = 2, 256, 8

# training, card vs CPU (qwen2-0.5b at full width cut to 2 layers, B 2, L 32,
# the same weights): fp32 with TF32 off, so only reduction orders differ.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_NORM_RTOL = 1e-4  # ||g_card - g_cpu|| / ||g_cpu||, each parameter
# one AdamW step on the same gradients: the same float32 arithmetic; the
# global norm summed in another order moves the clip factor by ~1e-7
ADAMW_TOL = dict(rtol=1e-5, atol=1e-9)
MICRO_LOSS_ATOL = 1e-4  # tests/test_train.py::test_microbatching_matches_single_batch

# the training paths: qwen2-0.5b and granite-moe-1b-a400m at their published
# widths (24 layers, fp32), random weights from seed 0, 12 steps of B 8, L 64
# in 2 microbatches
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 12, 8, 64, 2


def train_args(arch: str) -> list[str]:
    return ["--arch", arch, "--no-reduced", "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--microbatches", str(TRAIN_MICRO), "--lr", "1e-3", "--device", "cuda",
            "--seed", "0", "--quiet"]

PAPER_ARGS = ["--n", "1000", "--m", "1100", "--k-true", "8", "--k-max", "16",
              "--n-perturbs", "4", "--nmf-iters", "120", "--device", "cuda", "--quiet"]


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sync_wall(torch) -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def bound_ms(n_bytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mu_bound(update: str, lanes: int, n: int, m: int, k: int) -> tuple[float, str]:
    """The least time of one MU half-sweep (``update`` "h" or "w") over
    ``lanes`` fits: V, W, H, the k x k product and the output moved once,
    against its operations."""
    n_bytes = 4 * lanes * (n * m + n * k + k * m + k * k + (k * m if update == "h" else n * k))
    flops = lanes * (2 * n * m * k + (2 * k * k * m + 3 * k * m if update == "h" else 2 * n * k * k + 3 * n * k))
    return bound_ms(n_bytes, flops)


def time_ms(torch, fn, reps: int = 20) -> float:
    """Device milliseconds per call. A spin kernel is queued first, so the
    host enqueues every timed launch before the first one runs and the
    events see device time, not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of spinning at ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare(torch, got, want, rtol: float, atol: float, what: str) -> float:
    got, want = got.double(), want.double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    excess = float((err - (atol + rtol * want.abs())).max())
    max_abs = float(err.max())
    if excess > 0:
        raise AssertionError(f"{what}: max abs err {max_abs:.3e} exceeds rtol {rtol} / atol {atol}")
    return max_abs


def mu_problem(torch, dev, lanes: int, k_pad: int, k_effs, n: int = 1000, m: int = 1100):
    """Perturbed V per fit and a masked init, as a wave of NMFk fits has them."""
    from repro_torch.factorization.nmf import _masked_init
    from repro_torch.factorization.synthetic import nmf_data
    from repro_torch.random import make_draws, seeded_generator

    v, _, _ = nmf_data(n, m, 8, seed=1, device=dev)
    d = make_draws(seeded_generator(7, dev), n, m, k_pad, lanes, 0.015)
    vp = (v * d.noise).contiguous()
    k_eff = torch.tensor(k_effs, device=dev)
    w, h = _masked_init(vp, k_eff, d.w, d.h, k_pad)
    return vp, w.contiguous(), h.contiguous(), k_eff


def check_mu(torch, dev, ops, ref, records: dict, log) -> None:
    """Both MU wrappers against their plain versions at the batched wave's
    shape (L=32; k_pad 16, and ragged k_pad 13), the elastic executor's
    full lane batch (L=8, k_pad 16, one k per lane) and the threads
    executor's (L=4, k=16), the distributed fit's one lane (L=1, k=16),
    and past the tiled kernels' largest rank (k_pad 129 and
    200 at L=2, V 300 x 320: the any-rank kernel): masked components
    exactly zero, two calls bitwise equal; timed at k=16 with the wrapper's
    G or Q product alone beside (the kernels line reports the L=32 case,
    the first timed)."""
    cases = [
        ("k_pad=16, ks 9..16", 32, 16, [9 + i // 4 for i in range(32)], 1000, 1100),
        ("k_pad=13, ragged, ks 10..13", 32, 13, [10 + (i // 4) % 4 for i in range(32)], 1000, 1100),
        ("elastic: L=8, k=16, ks 9..16", 8, 16, [9 + i for i in range(8)], 1000, 1100),
        ("threads: L=4, k=16", 4, 16, [16] * 4, 1000, 1100),
        ("distributed fit: L=1, k=16", 1, 16, [16], 1000, 1100),
        ("any rank: k_pad=129, ks 129, 120", 2, 129, [129, 120], 300, 320),
        ("any rank: k_pad=200, ks 200, 150", 2, 200, [200, 150], 300, 320),
    ]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, lanes, k, k_effs, n, m in cases:
        v, w, h, k_eff = mu_problem(torch, dev, lanes, k, k_effs, n, m)
        dead = torch.arange(k, device=dev)[None, :] >= k_eff[:, None]  # (L, k) masked comps
        for name, fn, plain, out_of in (
            ("mu_update_h", ops.mu_update_h, ref.mu_update_h, "h"),
            ("mu_update_w", ops.mu_update_w, ref.mu_update_w, "w"),
        ):
            got, want = fn(v, w, h), plain(v, w, h)
            again = fn(v, w, h)
            torch.cuda.synchronize()
            err = compare(torch, got, want, MU_TOL["rtol"], MU_TOL["atol"], f"{name} [{label}]")
            if not torch.equal(got, again):
                raise AssertionError(f"{name} [{label}]: two calls differ bitwise")
            masked = got[dead] if out_of == "h" else got.transpose(1, 2)[dead]
            if masked.numel() and float(masked.abs().max()) != 0.0:
                raise AssertionError(f"{name} [{label}]: masked components are not exactly zero")
            entry = {"case": label, "shape": {"L": lanes, "n": n, "m": m, "k": k}, "max_abs_err": err,
                     "bitwise_equal_rerun": True}
            if k <= ops.MU_TILED_MAX_RANK:
                plan = ops._mu_plan(out_of, lanes, n, m, k, sms)
                entry["plan"] = {"whole": plan.whole, "split": plan.split, "chunk": plan.chunk, "items": plan.items,
                                 "blocks": plan.blocks, "scratch_bytes": 4 * math.prod(plan.scratch)}
            if k == 16:  # the main paths' shape: time it
                b_ms, b_by = mu_bound(out_of, lanes, n, m, k)
                # the wrapper's own k x k product (G = W^T W or Q = H H^T), timed alone
                gram = (lambda: torch.bmm(w.transpose(1, 2), w)) if out_of == "h" else (
                    lambda: torch.bmm(h, h.transpose(1, 2)))
                entry.update(
                    ms=time_ms(torch, lambda: fn(v, w, h)),
                    plain_ms=time_ms(torch, lambda: plain(v, w, h)),
                    bound_ms=b_ms, bound_by=b_by, gram_bmm_ms=time_ms(torch, gram),
                )
            log(json.dumps({"check": name, **entry}))
            records.setdefault(name, []).append(entry)


def pooled_columns(torch, dev, b: int, p: int, k: int, k_effs, d: int = 1000):
    """Pooled L2-normalized W columns of b lanes: p near-duplicate copies of
    k components (NMFk's normal case), labels and one-hot with masked rows."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    base = torch.rand((b, 1, d, k), device=dev, generator=gen)
    cols = base + 0.01 * torch.rand((b, p, d, k), device=dev, generator=gen)
    cols = cols / cols.norm(dim=2, keepdim=True)
    x = cols.transpose(2, 3).reshape(b, p * k, d).contiguous()
    labels = torch.arange(k, device=dev).repeat(p).expand(b, p * k)
    active = torch.arange(k, device=dev)[None, :] < torch.tensor(k_effs, device=dev)[:, None]
    onehot = (F.one_hot(labels, k).float() * active.repeat(1, p)[..., None]).contiguous()
    return x, onehot


def check_sums(torch, dev, ops, ref, records: dict, log) -> None:
    """Both silhouette wrappers on pooled near-duplicate columns (x = y), at
    d 1000: the batched wave (b 8, k_pad 16), the threads path's 2-D
    point counts (p 4: k 2, 7, 13, 16) and RESCALk's (p 3: k 4 and 11),
    timed; a ragged d (999); k past 128
    (p 2: k 129 in 2-D, k 200 at b 2; and 100 points over 200 clusters on
    the thin path); the thin path's largest point count
    (128) and, with one more y row whose one-hot row is zero, the same sums
    through the general path; and a K-Means-like general-path case (240
    points, d 5). Every case is called twice and must give the same bits.
    The kernels line reports the first timed case of each wrapper."""
    cases = [  # (label, b, p, k, k_effs, d, 2-D, timed)
        ("b=8, points=64, d=1000, k=16", 8, 4, 16, [9, 10, 11, 12, 13, 14, 15, 16], 1000, False, True),
        ("points=52, d=1000, k=13", 1, 4, 13, [13], 1000, True, True),
        ("points=8, d=1000, k=2", 1, 4, 2, [2], 1000, True, True),
        ("points=28, d=1000, k=7", 1, 4, 7, [7], 1000, True, True),
        ("points=64, d=1000, k=16", 1, 4, 16, [16], 1000, True, True),
        ("rescalk: points=12, d=1000, k=4", 1, 3, 4, [4], 1000, True, True),
        ("rescalk: points=33, d=1000, k=11", 1, 3, 11, [11], 1000, True, True),
        ("ragged d: points=52, d=999, k=13", 1, 4, 13, [13], 999, True, False),
        ("ragged d: b=8, points=64, d=999, k=16", 8, 4, 16, [16] * 8, 999, False, False),
        ("k past 128: points=258, d=1000, k=129", 1, 2, 129, [129], 1000, True, False),
        ("k past 128: b=2, points=400, d=1000, k=200", 2, 2, 200, [200, 170], 1000, False, False),
        ("k past 128, thin path: b=2, points=100, d=1000, k=200", 2, 1, 100, [100, 100], 1000, False, False),
        ("thin limit: b=2, points=128, d=1000, k=32", 2, 4, 32, [32, 32], 1000, False, False),
        ("general path: b=2, points=240, d=5, k=8", 2, 30, 8, [8, 6], 5, False, False),
    ]
    for label, b, p, k, k_effs, d, two_d, timed in cases:
        x, onehot = pooled_columns(torch, dev, b, p, k, k_effs, d)
        if label.startswith("k past 128, thin path"):  # 100 points (p 1, k 100), point j in cluster 2 j of 200
            points, k = k, 200
            labels = 2 * torch.arange(points, device=dev)
            onehot = torch.nn.functional.one_hot(labels, k).float().expand(b, points, k).contiguous()
        name, fn, args = "silhouette_dist_sums_batched", ops.silhouette_dist_sums_batched, (x, onehot)
        if two_d:
            name, fn, args = "silhouette_dist_sums", ops.silhouette_dist_sums, (x[0], onehot[0])
        # Near-duplicate pooled columns make |x|^2 + |y|^2 - 2 x.y a
        # cancellation: in fp32 at d=1000 its rounding noise (~1e-6) reaches
        # ~1e-3 after sqrt in ANY fp32 evaluation order, the plain version's
        # included. So the kernel is held against the plain version run in
        # float64 on the same inputs, and the fp32 plain version's own gap
        # to it is reported beside.
        got, again = fn(*args), fn(*args)
        want = ref.silhouette_dist_sums(*(a.double() for a in args))
        plain32 = ref.silhouette_dist_sums(*args)
        torch.cuda.synchronize()
        err = compare(torch, got, want, SUMS_TOL["rtol"], SUMS_TOL["atol"], f"{name} [{label}]")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} [{label}]: two calls differ bitwise")
        entry = {"case": label, "max_abs_err": err, "bitwise_equal_rerun": True,
                 "plain_fp32_max_abs_err": float((plain32.double() - want).abs().max())}
        if label.startswith("thin limit"):
            # the same sums through the general path: one more y row, whose
            # one-hot row is zero. The two paths add d in other orders, so
            # they agree at SUMS_TOL, not bit for bit.
            y_more = torch.cat([x, x[:, :1]], dim=1).contiguous()
            onehot_more = torch.cat([onehot, torch.zeros_like(onehot[:, :1])], dim=1).contiguous()
            general = fn(x, onehot_more, y_more)
            entry["thin_vs_general_max_abs_diff"] = compare(
                torch, general, got, SUMS_TOL["rtol"], SUMS_TOL["atol"], f"{name} [{label}]: general vs thin")
        if timed:
            n = x.shape[1]
            n_bytes = 4 * b * (n * d + n * k + n * k)  # x (= y) read once, one-hot, out
            flops = b * (2 * n * n * d + 2 * n * d + 5 * n * n + 2 * n * n * k)
            b_ms, b_by = bound_ms(n_bytes, flops)
            out = torch.empty_like(got)
            entry.update(
                ms=time_ms(torch, lambda: fn(*args)),
                plain_ms=time_ms(torch, lambda: ref.silhouette_dist_sums(*args)),
                bound_ms=b_ms, bound_by=b_by,
                fill_ms=time_ms(torch, lambda: out.fill_(1.0)),  # the launch floor
            )
            entry.update(bound_share=b_ms / entry["ms"], fill_multiple=entry["ms"] / entry["fill_ms"])
        log(json.dumps({"check": name, **entry}))
        records.setdefault(name, []).append(entry)


def check_pairwise(torch, dev, ops, ref, records: dict, log) -> None:
    """Both pairwise wrappers at the K-Means main paths' shapes: 10^6 blob
    points (d 6) against 24 centroid slots with x shared by the lanes (lane
    stride 0) of a 1-lane and a 16-lane wave, and in 2-D at m = 24 and at
    three more k of the threads path (2, 7, 13); a shape of the general
    path (m past the thin path's limit); a ragged small case. Every case is
    called twice and must give the same bits."""
    from repro_torch.factorization.synthetic import blob_data

    x, _ = blob_data(**KM_DATA, device=dev)
    n, d = x.shape
    b, m = KM_WAVE, KM_K_PAD
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    # centroid slots near data points, as k-means++ and Lloyd place them
    pick = torch.randint(0, n, (b, m), device=dev, generator=gen)
    y = (x[pick] + 0.1 * torch.randn((b, m, d), device=dev, generator=gen)).contiguous()
    rng_x = torch.randn((3, 70, 17), device=dev, generator=gen)
    rng_y = torch.randn((3, 30, 17), device=dev, generator=gen)
    m_gen = 4 * ops.PAIRWISE_THIN_COLS // 3  # past the thin path: the general one
    pick_gen = torch.randint(0, n, (2, m_gen), device=dev, generator=gen)
    y_gen = (x[pick_gen] + 0.1 * torch.randn((2, m_gen, d), device=dev, generator=gen)).contiguous()
    x_gen = x[: n // 10]
    cases = [
        # Binary Bleed prunes one side of most waves, so the batched run's
        # waves mostly carry one lane: that shape first (the kernels line
        # reports the first timed case), then a full 16-lane wave
        ("pairwise_sq_dists_batched", ops.pairwise_sq_dists_batched, (x, y[:1]),
         f"b=1 lane, x shared (n={n}, d={d}), m={m}", True),
        ("pairwise_sq_dists_batched", ops.pairwise_sq_dists_batched, (x, y),
         f"b={b} lanes, x shared (n={n}, d={d}), m={m}", True),
        ("pairwise_sq_dists", ops.pairwise_sq_dists, (x, y[0]), f"n={n}, m={m}, d={d}", True),
    ]
    cases += [("pairwise_sq_dists", ops.pairwise_sq_dists, (x, y[0, :k].contiguous()), f"n={n}, m={k}, d={d}", True)
              for k in (2, 7, 13)]
    cases += [
        ("pairwise_sq_dists_batched", ops.pairwise_sq_dists_batched, (x_gen, y_gen),
         f"general path: b=2 lanes, x shared (n={x_gen.shape[0]}, d={d}), m={m_gen}", True),
        ("pairwise_sq_dists_batched", ops.pairwise_sq_dists_batched, (rng_x, rng_y),
         "ragged b=3, n=70, m=30, d=17", False),
    ]
    for name, fn, (xx, yy), label, timed in cases:
        got, want = fn(xx, yy), ref.pairwise_sq_dists(xx, yy)
        again = fn(xx, yy)
        torch.cuda.synchronize()
        err = compare(torch, got, want, PAIRWISE_TOL["rtol"], PAIRWISE_TOL["atol"], f"{name} [{label}]")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} [{label}]: two calls differ bitwise")
        del want, again
        fp64_err = float((got.double() - ref.pairwise_sq_dists(xx.double(), yy.double())).abs().max())
        entry = {"case": label, "max_abs_err": err, "max_abs_err_vs_fp64": fp64_err, "bitwise_equal_rerun": True}
        del got
        if timed:
            lanes = yy.shape[0] if yy.dim() == 3 else 1
            n_x, n_y, dd = xx.shape[-2], yy.shape[-2], xx.shape[-1]
            x_bytes = xx.numel()  # a 2-D x is read once for every lane
            n_bytes = 4 * (x_bytes + yy.numel() + lanes * n_x * n_y)
            flops = lanes * n_x * n_y * (2 * dd + 3) + 2 * xx.numel() + 2 * yy.numel()
            b_ms, b_by = bound_ms(n_bytes, flops)
            x_lib = xx.expand(lanes, n_x, dd) if yy.dim() == 3 else xx
            entry.update(
                ms=time_ms(torch, lambda: fn(xx, yy)),
                plain_ms=time_ms(torch, lambda: ref.pairwise_sq_dists(xx, yy)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(
                    torch, lambda: torch.cdist(x_lib, yy, compute_mode="use_mm_for_euclid_dist")),
                library="torch.cdist(use_mm_for_euclid_dist): the square root of the same D^2, one call",
            )
        log(json.dumps({"check": name, **entry}))
        records.setdefault(name, []).append(entry)


def check_nmfk_small(torch, dev, log) -> None:
    """Batched NMFk on the card (kernels) vs on the CPU (plain), same draws:
    ks 2..8 at k_pad 8 (96 x 104, 120 sweeps), and a wave padded past 128
    ranks (ks 3 and 129 at k_pad 129; 40 x 44, 2 perturbations, 20 sweeps),
    whose fits take the any-rank MU kernel and whose 258 pooled columns the
    general silhouette path."""
    from repro_torch.factorization.nmfk import nmfk_score_batched
    from repro_torch.factorization.synthetic import nmf_data
    from repro_torch.kernels import ops
    from repro_torch.random import Draws, seeded_draws

    for (n, m, k_true), ks, k_pad, p, iters in (
        ((96, 104, 5), [2, 3, 4, 5, 6, 7, 8], 8, 4, 120),
        ((40, 44, 4), [3, 129], 129, 2, 20),
    ):
        v, _, _ = nmf_data(n, m, k_true, seed=0, device=dev)
        card_draws = seeded_draws(0, n, m, p, 0.015, dev)

        def cpu_draws(k, k_draw, card_draws=card_draws):
            return Draws(*(t.cpu() for t in card_draws(k, k_draw)))

        ops.reset_launch_counts()
        on_card = nmfk_score_batched(v, ks, k_pad=k_pad, n_perturbs=p, nmf_iters=iters, draws=card_draws)
        launches = ops.launch_counts()
        on_cpu = nmfk_score_batched(v.cpu(), ks, k_pad=k_pad, n_perturbs=p, nmf_iters=iters, draws=cpu_draws)
        for field in ("min_silhouette", "mean_silhouette"):
            gap = float((getattr(on_card, field).cpu() - getattr(on_cpu, field)).abs().max())
            if not gap <= NMFK_SIL_ATOL:
                raise AssertionError(f"NMFk k_pad {k_pad} {field}: card vs plain gap {gap:.3e} > {NMFK_SIL_ATOL}")
        rel = float(((on_card.rel_error.cpu() - on_cpu.rel_error) / on_cpu.rel_error).abs().max())
        if not rel <= NMFK_ERR_RTOL:
            raise AssertionError(f"NMFk k_pad {k_pad} rel_error: card vs plain relative gap {rel:.3e} > {NMFK_ERR_RTOL}")
        if min(launches["mu_update_h"], launches["mu_update_w"], launches["silhouette_dist_sums_batched"]) < 1:
            raise AssertionError(f"NMFk k_pad {k_pad} on the card missed a kernel: {launches}")
        log(json.dumps({"check": "nmfk_score_batched card vs plain", "shape": [n, m], "ks": ks, "k_pad": k_pad,
                        "min_silhouette_card": on_card.min_silhouette.tolist(),
                        "min_silhouette_plain": on_cpu.min_silhouette.tolist(),
                        "rel_error_max_rel_gap": rel}))


def drain(plane) -> dict[int, float]:
    """Tick an elastic plane until idle; {k: score}."""
    scores = {}
    while not plane.idle:
        scores.update(plane.tick())
    return scores


def check_nmfk_elastic_small(torch, dev, ops, log) -> None:
    """The elastic NMFk plane on the card (kernels) vs on the CPU (plain),
    same draws: ks 2..8 submitted at once and drained (96 x 104, k_pad 8,
    4 perturbations, 120 sweeps, chunks of 25, 8 slots), tol 0 with warm
    starts and without. Each k's scores within NMFK_SIL_ATOL; the sweep
    counts and warm-start hits equal on both devices."""
    from repro_torch.factorization.planes import NMFkElasticPlane
    from repro_torch.factorization.synthetic import nmf_data
    from repro_torch.random import Draws, seeded_draws

    n, m, p, ks = 96, 104, 4, list(range(2, 9))
    v, _, _ = nmf_data(n, m, 5, seed=0, device=dev)
    card_draws = seeded_draws(0, n, m, p, 0.015, dev)

    def cpu_draws(k, k_draw):
        return Draws(*(t.cpu() for t in card_draws(k, k_draw)))

    for warm in (True, False):
        runs = {}
        for where, vv, draws in (("card", v, card_draws), ("cpu", v.cpu(), cpu_draws)):
            plane = NMFkElasticPlane(vv, n_perturbs=p, nmf_iters=120, k_pad=8, tol=0.0, chunk=25,
                                     warm_start=warm, draws=draws)
            for k in ks:
                plane.submit(k)
            ops.reset_launch_counts()
            scores = drain(plane)
            runs[where] = (plane, scores, ops.launch_counts())
        (card, on_card, launches), (cpu, on_cpu, _) = runs["card"], runs["cpu"]
        what = f"elastic NMFk, warm_start={warm}"
        if sorted(on_card) != ks or sorted(on_cpu) != ks:
            raise AssertionError(f"{what}: scored ks card {sorted(on_card)}, cpu {sorted(on_cpu)}, want {ks}")
        gap = max(abs(on_card[k] - on_cpu[k]) for k in ks)
        if not gap <= NMFK_SIL_ATOL:
            raise AssertionError(f"{what}: card vs plain score gap {gap:.3e} > {NMFK_SIL_ATOL}")
        counts = {f: (getattr(card, f), getattr(cpu, f)) for f in ("sweeps_run", "sweeps_saved", "sweeps_fixed_total")}
        counts["warm_start_hits"] = (card.warm_cache.hits, cpu.warm_cache.hits)
        if any(a != b for a, b in counts.values()) or (counts["warm_start_hits"][0] > 0) != warm:
            raise AssertionError(f"{what}: card vs cpu counts (card, cpu) {counts}")
        if min(launches["mu_update_h"], launches["mu_update_w"], launches["silhouette_dist_sums_batched"]) < 1:
            raise AssertionError(f"{what} on the card missed a kernel: {launches}")
        log(json.dumps({"check": "NMFkElasticPlane card vs plain", "warm_start": warm, "shape": [n, m],
                        "ks": ks, "max_abs_gap": gap, "counts_card_cpu": counts,
                        "dispatched_shapes": sorted(card.shapes_dispatched), "launches": launches}))


def check_kmeans_small(torch, dev, ops, log) -> None:
    """tests/test_integration.py's K-Means + Davies-Bouldin search (serial,
    so the visit order is fixed) on the card (kernels) and on the CPU (plain
    versions) with the same draws; then a small K-Means silhouette wave."""
    from repro_torch.core import binary_bleed_search, davies_bouldin_score
    from repro_torch.factorization.kmeans import kmeans
    from repro_torch.factorization.planes import KMeansBatchPlane
    from repro_torch.factorization.synthetic import blob_data
    from repro_torch.random import KMeansDraws, seeded_kmeans_draws

    x, _ = blob_data(n=240, d=5, k_true=5, std=0.3, spread=10.0, seed=3, device=dev)
    card_draws = seeded_kmeans_draws(3, 240, dev)

    def cpu_draws(k, k_draw):
        return KMeansDraws(*(t.cpu() for t in card_draws(k, k_draw)))

    runs = {}
    for where, xx, draws in (("card", x, card_draws), ("cpu", x.cpu(), cpu_draws)):
        labels = {}

        def ev(k, should_abort=None, xx=xx, draws=draws, labels=labels):
            labels[k] = kmeans(xx, k, draws(k, k)).labels.cpu()
            return float(davies_bouldin_score(xx, labels[k].to(xx.device), k))

        ops.reset_launch_counts()
        res = binary_bleed_search(ev, (2, 12), 0.5, 1.6, mode="minimize", num_resources=1)
        runs[where] = (res, labels, ops.launch_counts())
    (card, card_labels, launches), (cpu, cpu_labels, _) = runs["card"], runs["cpu"]
    if card.k_optimal != cpu.k_optimal or card.k_optimal != 5:
        raise AssertionError(f"K-Means search: k_optimal card {card.k_optimal}, cpu {cpu.k_optimal}, want 5")
    if card.visited_ks != cpu.visited_ks:
        raise AssertionError(f"K-Means search visited {sorted(card.visited_ks)} on the card, "
                             f"{sorted(cpu.visited_ks)} on the CPU")
    card_db = {v.k: v.score for v in card.visits}
    cpu_db = {v.k: v.score for v in cpu.visits}
    for k in card_db:
        if not torch.equal(card_labels[k], cpu_labels[k]):
            raise AssertionError(f"K-Means k={k}: card and CPU labels differ")
        if abs(card_db[k] - cpu_db[k]) > KM_DB_RTOL * abs(cpu_db[k]):
            raise AssertionError(f"K-Means k={k}: DB card {card_db[k]} vs CPU {cpu_db[k]}")
    if launches["pairwise_sq_dists"] < 1:
        raise AssertionError("the card's K-Means search never launched pairwise_sq_dists")
    # k past one block of k-means++ draws (128): same draws, same labels
    fits = {where: kmeans(xx, 129, draws(129, 129), max_iters=25)
            for where, xx, draws in (("card", x, card_draws), ("cpu", x.cpu(), cpu_draws))}
    if not torch.equal(fits["card"].labels.cpu(), fits["cpu"].labels):
        raise AssertionError("K-Means k=129: card and CPU labels differ")
    if tuple(fits["card"].centroids.shape) != (129, x.shape[1]):
        raise AssertionError(f"K-Means k=129: centroids of shape {tuple(fits['card'].centroids.shape)}")
    gap = max(abs(card_db[k] - cpu_db[k]) for k in card_db)
    log(json.dumps({"check": "kmeans + davies_bouldin search card vs plain", "k_optimal": card.k_optimal,
                    "visited": sorted(card.visited_ks), "db_card": card_db, "db_max_abs_gap": gap,
                    "launches": launches, "k129_labels_equal": True, "k129_iters": int(fits["card"].iters)}))

    ks = [2, 3, 4, 5]
    ops.reset_launch_counts()
    on_card = KMeansBatchPlane(x, score="silhouette", max_iters=25, k_pad=8, draws=card_draws).evaluate_batch(ks)
    sil_launches = ops.launch_counts()["silhouette_dist_sums_batched"]
    on_cpu = KMeansBatchPlane(x.cpu(), score="silhouette", max_iters=25, k_pad=8,
                              draws=cpu_draws).evaluate_batch(ks)
    gap = max(abs(a - c) for a, c in zip(on_card, on_cpu))
    if not gap <= KM_SIL_ATOL or sil_launches < 1:
        raise AssertionError(f"K-Means silhouette wave: card vs plain gap {gap:.3e}, "
                             f"{sil_launches} silhouette_dist_sums_batched launches")
    log(json.dumps({"check": "kmeans silhouette wave card vs plain", "ks": ks, "card": on_card,
                    "max_abs_gap": gap, "silhouette_dist_sums_batched_launches": sil_launches}))


def run_kmeans_search(torch, dev, ops, executor: str, log) -> dict[str, int]:
    """kmeans_db_1m on one executor; counts reset just before, read just after."""
    from repro_torch.core import binary_bleed_search, davies_bouldin_score
    from repro_torch.factorization.kmeans import kmeans
    from repro_torch.factorization.planes import KMeansBatchPlane
    from repro_torch.factorization.synthetic import blob_data

    x, planted = blob_data(**KM_DATA, device=dev)
    centers = torch.stack([x[planted == c].mean(dim=0) for c in range(KM_DATA["k_true"])])
    gaps = (centers[:, None] - centers[None]).norm(dim=-1).fill_diagonal_(math.inf)
    if executor == "batched":
        evaluate = KMeansBatchPlane(x, seed=0, score="davies_bouldin", max_iters=KM_MAX_ITERS, k_pad=KM_K_PAD)
        kw = dict(executor="batched")
    else:
        def evaluate(k, should_abort=None):
            res = kmeans(x, int(k), seed=0, max_iters=KM_MAX_ITERS)
            return float(davies_bouldin_score(x, res.labels, int(k)))
        kw = dict(num_resources=2)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = sync_wall(torch)
    res = binary_bleed_search(evaluate, **KM_SEARCH, **kw)
    wall = sync_wall(torch) - t0
    counts = ops.launch_counts()
    log(json.dumps({"search": f"kmeans_db_1m {executor}", "k_optimal": res.k_optimal,
                    "planted_min_center_gap": float(gaps.min()),
                    "visited": {v.k: v.score for v in sorted(res.visits, key=lambda v: v.k)},
                    "waves": getattr(evaluate, "n_dispatches", None), "wall_s": wall,
                    "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": counts}))
    if res.k_optimal != KM_DATA["k_true"]:
        raise AssertionError(f"kmeans_db_1m {executor}: k_optimal {res.k_optimal} != {KM_DATA['k_true']}")
    name = "pairwise_sq_dists_batched" if executor == "batched" else "pairwise_sq_dists"
    if counts[name] < 1:
        raise AssertionError(f"kmeans_db_1m {executor}: kernel {name} was never launched on the main path")
    return counts


def run_search(torch, ops, ksearch, executor: str, log, extra: tuple[str, ...] = (), label: str | None = None) -> dict[str, int]:
    """The paper-scale search on one executor with ``extra`` flags; counts
    reset just before, read just after."""
    import torch.distributed as dist

    label = label or executor
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = ksearch.main(PAPER_ARGS + ["--executor", executor, *extra])
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(json.dumps({"search": label, "k_optimal": out["k_optimal"], "visited": out["visited"],
                    "waves": out.get("waves"), "wall_s": out["seconds"], "scores": out["scores"],
                    **{key: out[key] for key in ("mesh", "comm", "lane_utilization_last") if key in out},
                    "max_memory_allocated": peak, "launches": counts}))
    if out["k_optimal"] != 8:
        raise AssertionError(f"{label}: k_optimal {out['k_optimal']} != 8")
    if dist.is_initialized():
        raise AssertionError(f"{label}: the search's process groups outlived it")
    sums = "silhouette_dist_sums_batched" if executor in ("batched", "sharded") else "silhouette_dist_sums"
    for name in ("mu_update_h", "mu_update_w", sums):
        if counts[name] < 1:
            raise AssertionError(f"{label}: kernel {name} was never launched on the main path")
    return counts


MULTI_RANK_MESHES = {
    "nmfk_sharded_4rank_lanes4": ["--executor", "sharded", "--lanes", "4"],
    "nmfk_sharded_4rank_lanes2_data2_sync": ["--executor", "sharded", "--lanes", "2", "--data-shards", "2",
                                             "--comm", "sync"],
    "nmfk_sharded_4rank_lanes2_data2_pipelined": ["--executor", "sharded", "--lanes", "2", "--data-shards", "2",
                                                  "--comm", "pipelined"],
    "nmfk_elastic_4rank_lanes2_data2": ["--executor", "elastic", "--lanes", "2", "--data-shards", "2"],
}
MULTI_RANK_TIMEOUT_S = 300
# what every rank of a multi-rank search must return alike (those an executor reports)
RANK_AGREES = ("visited", "scores", "mesh", "sweeps_run", "sweeps_saved", "sweeps_fixed_total", "warm_start_hits")


def run_multi_rank_searches(torch, log) -> dict[str, dict[str, int]]:
    """The paper-scale search at 4 ranks, one process per card
    (``torchrun``, rendezvous on localhost), on each executor and mesh of
    ``MULTI_RANK_MESHES``, twice a process (``rank_search``): every rank
    writes its result and its launch counts; each rank must find k_optimal
    8 and all the same ``RANK_AGREES`` entries (the elastic run: also its
    sweep counts and warm-start hits). Launch counts (of each process's
    second search) are summed over the ranks. Needs 4 cards."""
    import os
    import signal
    import tempfile

    cards = torch.cuda.device_count()
    if cards < 4:
        log(f"multi-rank searches: not made ({cards} card(s) visible; the 4-rank runs need 4)")
        return {}
    by_path = {}
    for label, flags in MULTI_RANK_MESHES.items():
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as outdir:
            # the search's flags go in a file: torchrun's own parser takes an
            # abbreviation such as --n or --m after the script for one of its options
            (Path(outdir) / "argv.json").write_text(json.dumps([*PAPER_ARGS, *flags]))
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
                   str(ROOT / "chip_smoke.py"), "--rank-search", outdir]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                    start_new_session=True)
            try:
                text, _ = proc.communicate(timeout=MULTI_RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
                raise AssertionError(f"{label}: no result within {MULTI_RANK_TIMEOUT_S} s")
            if proc.returncode != 0:
                raise AssertionError(f"{label}: torchrun exited {proc.returncode}:\n{text[-4000:]}")
            ranks = [json.loads((Path(outdir) / f"rank{r}.json").read_text()) for r in range(4)]
        first = ranks[0]["out"]
        for r, rank in enumerate(ranks):
            got = rank["out"]
            if got["k_optimal"] != 8 or rank["cold_k_optimal"] != 8 or any(
                    got.get(key) != first.get(key) for key in RANK_AGREES):
                raise AssertionError(f"{label}: rank {r} returned {got}, rank 0 {first}")
        if "sweeps_run" in first and first["sweeps_run"] + first["sweeps_saved"] != first["sweeps_fixed_total"]:
            raise AssertionError(f"{label}: sweeps run + saved != the fixed-iteration total: {first}")
        counts = {name: sum(rank["launches"][name] for rank in ranks) for name in ranks[0]["launches"]}
        log(json.dumps({"search": label, "k_optimal": first["k_optimal"],
                        "visited": first["visited"], "scores": first["scores"], "mesh": first["mesh"], "comm": first["comm"],
                        "wall_s": first["seconds"], "cold_wall_s": ranks[0]["cold_seconds"],
                        **{key: first[key] for key in RANK_AGREES[3:] + ("overlap_fraction",) if key in first},
                        "launches_by_rank": [rank["launches"] for rank in ranks]}))
        for name in ("mu_update_h", "mu_update_w", "silhouette_dist_sums_batched"):
            if min(rank["launches"][name] for rank in ranks) < 1 and not (
                    name == "mu_update_h" and first["mesh"]["data"] > 1):
                raise AssertionError(f"{label}: a rank never launched {name}")
        by_path[label] = counts
    return by_path


def rank_search(outdir: Path) -> int:
    """One rank of ``run_multi_rank_searches`` (under ``torchrun``): the
    port's ``ksearch`` with the flags in ``outdir/argv.json``, twice (the
    first in a fresh process pays its cold start), the second's result and
    launch counts and the first's wall written to ``outdir/rank<RANK>.json``."""
    import os

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    from repro_torch.launch import ksearch

    argv = json.loads((outdir / "argv.json").read_text())
    cold = ksearch.main(argv)
    ops.reset_launch_counts()
    out = ksearch.main(argv)
    (outdir / f"rank{os.environ['RANK']}.json").write_text(json.dumps(
        {"out": out, "launches": ops.launch_counts(), "cold_k_optimal": cold["k_optimal"],
         "cold_seconds": cold["seconds"]}))
    return 0


def run_elastic_search(torch, dev, ops, ksearch, label: str, extra: list[str], log, oracle: bool = False,
                       same_as: dict | None = None) -> tuple[dict[str, int], dict]:
    """The paper-scale search on the elastic executor with ``extra`` flags;
    counts reset just before, read just after; returns them and the search's
    result. The ``oracle`` run (tol 0, no warm starts) also writes its trace,
    whose ``record`` events give the score of each visited k, and holds each
    against the batched executor's plane (same draws; its lane count, so not
    the same bits). With ``same_as`` (an earlier run's result) the visited
    ks, scores, sweep counts and warm-start hits must be that run's."""
    trace = ROOT / "build" / "chip_smoke" / f"{label}.jsonl"
    if oracle:
        trace.parent.mkdir(parents=True, exist_ok=True)
        extra = [*extra, "--trace", str(trace)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = ksearch.main(PAPER_ARGS + ["--executor", "elastic", *extra])
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    keys = ("ticks", "dispatched_shapes", "tol", "warm_start", "sweeps_run", "sweeps_saved",
            "sweeps_fixed_total", "warm_start_hits", "lane_occupancy", "mesh", "comm")
    entry = {"search": label, "k_optimal": out["k_optimal"], "visited": out["visited"], "wall_s": out["seconds"],
             "sweeps_run_share": out["sweeps_run"] / out["sweeps_fixed_total"],
             **{key: out[key] for key in keys if key in out}, "max_memory_allocated": peak, "launches": counts}
    if out["k_optimal"] != 8:
        raise AssertionError(f"{label}: k_optimal {out['k_optimal']} != 8")
    if out["sweeps_run"] + out["sweeps_saved"] != out["sweeps_fixed_total"]:
        raise AssertionError(f"{label}: sweeps run {out['sweeps_run']} + saved {out['sweeps_saved']} "
                             f"!= fixed total {out['sweeps_fixed_total']}")
    for name in ("mu_update_h", "mu_update_w", "silhouette_dist_sums_batched"):
        if counts[name] < 1:
            raise AssertionError(f"{label}: kernel {name} was never launched on the main path")
    if same_as is not None:
        agree = ("visited", "scores", "sweeps_run", "sweeps_saved", "warm_start_hits")
        if any(out[key] != same_as[key] for key in agree):
            raise AssertionError(f"{label}: {[out[key] for key in agree]} vs {[same_as[key] for key in agree]}")
        entry["same_as_unsharded"] = True
    if oracle:
        from repro_torch.factorization.planes import NMFkBatchPlane
        from repro_torch.factorization.synthetic import nmf_data

        records = [json.loads(line) for line in trace.read_text().splitlines()]
        scores = {r["args"]["k"]: r["args"]["score"] for r in records if r["name"] == "record"}
        if sorted(scores) != out["visited"]:
            raise AssertionError(f"{label}: the trace scored ks {sorted(scores)}, the search visited {out['visited']}")
        v, _, _ = nmf_data(1000, 1100, 8, seed=0, device=dev)
        plane = NMFkBatchPlane(v, 0, n_perturbs=4, nmf_iters=120, k_pad=16)
        batched = dict(zip(out["visited"], plane.evaluate_batch(out["visited"])))
        gap = max(abs(scores[k] - batched[k]) for k in scores)
        entry.update(scores=scores, batched_scores=batched, max_abs_gap_to_batched=gap)
        if not gap <= NMFK_SIL_ATOL:
            raise AssertionError(f"{label}: score gap to the batched plane {gap:.3e} > {NMFK_SIL_ATOL}")
    log(json.dumps(entry))
    return counts, out


def check_rescal_small(torch, dev, ops, log) -> None:
    """RESCAL and RESCALk on the card against the CPU, same X and draws (96
    entities, 3 relations, k_true 4): a 150-sweep ``rescal`` at k 4 (factors
    and error), then ``rescalk_score`` at k 2..6 (P 3, 150 sweeps):
    silhouettes and mean errors, and the silhouette kernel launched."""
    from repro_torch.factorization.rescal import rescal, rescalk_score
    from repro_torch.factorization.synthetic import rescal_data
    from repro_torch.random import RESCALDraws, seeded_rescal_draws

    n, nr, p = 96, 3, 3
    x, _, _ = rescal_data(n_entities=n, n_relations=nr, k_true=4, noise=0.01, seed=0, device="cpu")
    source = seeded_rescal_draws(0, n, nr, p, RESCAL_EPS, "cpu")
    d = source(4)
    cpu = rescal(x, 4, d.a[0], d.r[0], iters=150)
    card = rescal(x.to(dev), 4, d.a[0].to(dev), d.r[0].to(dev), iters=150)
    gaps = {"a": compare(torch, card.a.cpu(), cpu.a, RESCAL_RTOL, 1e-6, "rescal k=4: A"),
            "r": compare(torch, card.r.cpu(), cpu.r, RESCAL_RTOL, 1e-6, "rescal k=4: R"),
            "rel_error": compare(torch, card.rel_error.cpu(), cpu.rel_error, RESCAL_RTOL, 0.0, "rescal k=4: error")}
    scores = {}
    ops.reset_launch_counts()
    for k in range(2, 7):
        d = source(k)
        sil_cpu, err_cpu = rescalk_score(x, k, d, iters=150)
        sil, err = rescalk_score(x.to(dev), k, RESCALDraws(*(t.to(dev) for t in d)), iters=150)
        scores[k] = (float(sil), float(sil_cpu), float(err), float(err_cpu))
    launches = ops.launch_counts()
    sil_gap = max(abs(s - c) for s, c, _, _ in scores.values())
    err_gap = max(abs(e - c) / c for _, _, e, c in scores.values())
    if not sil_gap <= RESCAL_SIL_ATOL or not err_gap <= RESCAL_RTOL:
        raise AssertionError(f"rescalk_score card vs CPU: silhouette gap {sil_gap:.3e} (atol {RESCAL_SIL_ATOL}), "
                             f"error gap {err_gap:.3e} (rtol {RESCAL_RTOL})")
    if launches["silhouette_dist_sums"] < 5:
        raise AssertionError(f"rescalk_score on the card missed the silhouette kernel: {launches}")
    log(json.dumps({"check": "rescal / rescalk_score card vs CPU", "entities": n, "relations": nr,
                    "rescal_k4_max_abs_gap": gaps, "silhouette_max_abs_gap": sil_gap,
                    "rel_error_max_rel_gap": err_gap, "scores_card_cpu": scores, "launches": launches}))


def check_distributed_small(torch, dev, ops, log) -> None:
    """The distributed fits on a one-rank NCCL group (a ``file://`` store in
    a temporary directory, destroyed at the end of the phase) against the
    same calls on the CPU without a group: ``distributed_nmf`` sync and
    pipelined (bitwise equal at one rank), ``distributed_rescal``, and
    ``_dnmf_masked_local`` against the single-device ``_nmf_masked`` on the
    same draws. The collectives' spellings are called once on the group;
    the W-update's MU kernel launches are counted."""
    import torch.distributed as dist

    from repro_torch.factorization import distributed as D
    from repro_torch.factorization.nmf import _nmf_masked
    from repro_torch.factorization.synthetic import nmf_data, rescal_data
    from repro_torch.random import init_draws, rescal_init_draws, seeded_generator

    v, _, _ = nmf_data(96, 104, 5, seed=0, device="cpu")
    x, _, _ = rescal_data(n_entities=96, n_relations=3, k_true=4, noise=0.01, seed=0, device="cpu")
    w, h = init_draws(seeded_generator(1, "cpu"), 96, 104, 6)
    a, r = rescal_init_draws(seeded_generator(2, "cpu"), 96, 3, 4)
    entry = {"check": "distributed fits on a one-rank NCCL group vs CPU"}
    with D.local_groups(dev, 1) as (group,):
        entry["backend"] = str(dist.get_backend(group))
        probe = torch.arange(12.0, device=dev).reshape(4, 3)
        out = torch.empty_like(probe)
        D._reduce_scatter(out, probe, group=group, async_op=True).wait()
        gathered = torch.empty_like(probe)
        D._all_gather(gathered, probe, group=group)
        if not (torch.equal(out, probe) and torch.equal(gathered, probe)):
            raise AssertionError("one-rank reduce-scatter / all-gather is not the identity")
        entry["spellings"] = [D._reduce_scatter.__name__, D._all_gather.__name__]
        ops.reset_launch_counts()
        fits = {comm: D.distributed_nmf(v.to(dev), 5, w[:, :5].to(dev), h[:5].to(dev), group, iters=100, comm=comm)
                for comm in D.COMM_MODES}
        entry["nmf_launches"] = ops.launch_counts()
        sync, pipe = fits["sync"], fits["pipelined"]
        if not all(torch.equal(s_, p_) for s_, p_ in zip(sync, pipe)):
            raise AssertionError("distributed_nmf at one rank: pipelined differs from sync")
        cpu = D.distributed_nmf(v, 5, w[:, :5], h[:5], None, iters=100)
        entry["nmf_gap"] = [compare(torch, got.cpu(), want, DIST_RTOL, 1e-6, f"distributed_nmf {name}")
                            for name, got, want in zip(("w", "h", "err"), sync, cpu)]
        res = D.distributed_rescal(x.to(dev), 4, a.to(dev), r.to(dev), group, iters=100)
        cpu = D.distributed_rescal(x, 4, a, r, None, iters=100)
        entry["rescal_gap"] = [compare(torch, got.cpu(), want, DIST_RTOL, 1e-6, f"distributed_rescal {name}")
                               for name, got, want in zip(("a", "r", "err"), res, cpu)]
        w_l, err = D._dnmf_masked_local(v.to(dev), 4, w.to(dev), h.to(dev), 6, 100, group)
        single = _nmf_masked(v.to(dev), 4, w.to(dev), h.to(dev), 6, 100)
        cpu_w, cpu_err = D._dnmf_masked_local(v, 4, w, h, 6, 100, None)
        entry["masked_vs_single_gap"] = [compare(torch, w_l, single.w, DIST_RTOL, 1e-6, "masked vs single-device W"),
                                         compare(torch, err, single.rel_error, DIST_RTOL, 0.0, "masked vs single err")]
        entry["masked_vs_cpu_gap"] = [compare(torch, w_l.cpu(), cpu_w, DIST_RTOL, 1e-6, "masked W card vs CPU"),
                                      compare(torch, err.cpu(), cpu_err, DIST_RTOL, 0.0, "masked err card vs CPU")]
        if float(w_l[:, 4:].abs().max()) != 0.0:
            raise AssertionError("masked distributed fit: masked components are not exactly zero")
    if dist.is_initialized():
        raise AssertionError("the phase's process groups outlived it")
    if entry["nmf_launches"]["mu_update_w"] != 2 * 100:
        raise AssertionError(f"distributed_nmf: {entry['nmf_launches']['mu_update_w']} mu_update_w launches "
                             f"for 2 fits of 100 sweeps")
    log(json.dumps(entry))


def check_sharded_small(torch, dev, ops, log) -> None:
    """The sharded planes on a one-rank ``(lane, data)`` mesh (NCCL; the
    default group made by ``make_wave_mesh`` and destroyed on exit) against
    the unsharded ones on the card. At one rank the lane block is the whole
    wave and pipelined has nothing to overlap, so every result must be the
    same bits: ``nmfk_score_sharded`` sync and pipelined (ks 2..8, 96 x 104,
    k_pad 8, 4 perturbations, 120 sweeps) against ``nmfk_score_batched``;
    ``KMeansBatchPlane(mesh=)`` labels and Davies-Bouldin scores; the elastic
    plane drained at tol 0 with warm starts: scores, sweep counts and
    warm-start hits."""
    import torch.distributed as dist

    from repro_torch.factorization.nmfk import nmfk_score_batched, nmfk_score_sharded
    from repro_torch.factorization.planes import KMeansBatchPlane, NMFkElasticPlane
    from repro_torch.factorization.synthetic import blob_data, nmf_data
    from repro_torch.launch.mesh import make_wave_mesh

    n, m, p, ks = 96, 104, 4, list(range(2, 9))
    v, _, _ = nmf_data(n, m, 5, seed=0, device=dev)
    x, _ = blob_data(n=240, d=5, k_true=5, std=0.3, spread=10.0, seed=3, device=dev)
    km_ks = [2, 3, 4, 5, 6, 7, 8, 8]
    entry = {"check": "sharded planes on a one-rank NCCL mesh vs unsharded on the card"}
    with make_wave_mesh(device=dev) as mesh:
        entry.update(backend=str(dist.get_backend(mesh.lane_group)), mesh=mesh.shape, device=str(mesh.device))
        want = nmfk_score_batched(v, ks, k_pad=8, n_perturbs=p, nmf_iters=120)
        ops.reset_launch_counts()
        for comm in ("sync", "pipelined"):
            got = nmfk_score_sharded(v, ks, mesh=mesh, k_pad=8, n_perturbs=p, nmf_iters=120, comm=comm)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"nmfk_score_sharded {comm} at one rank differs from nmfk_score_batched")
        entry["nmfk_launches"] = ops.launch_counts()
        planes = [KMeansBatchPlane(x, seed=3, max_iters=25, k_pad=8, mesh=mm) for mm in (None, mesh)]
        km = [planes[0].evaluate_batch(km_ks)]
        ops.reset_launch_counts()
        km.append(planes[1].evaluate_batch(km_ks))
        entry["kmeans_launches"] = ops.launch_counts()
        if km[0] != km[1] or not torch.equal(planes[0].last_labels, planes[1].last_labels):
            raise AssertionError(f"KMeansBatchPlane(mesh=) at one rank: scores {km[1]} vs {km[0]} or labels differ")
        runs = []
        for mm in (None, mesh):
            plane = NMFkElasticPlane(v, n_perturbs=p, nmf_iters=120, k_pad=8, tol=0.0, chunk=25, mesh=mm)
            for k in ks:
                plane.submit(k)
            scores = drain(plane)
            runs.append((scores, plane.sweeps_run, plane.sweeps_saved, plane.sweeps_fixed_total, plane.warm_cache.hits))
        if runs[0] != runs[1] or runs[0][-1] < 1:
            raise AssertionError(f"elastic plane at one rank: sharded {runs[1]} vs unsharded {runs[0]}")
    if dist.is_initialized():
        raise AssertionError("the sharded phase's process groups outlived it")
    if min(entry["nmfk_launches"][name] for name in ("mu_update_h", "mu_update_w", "silhouette_dist_sums_batched")) < 1:
        raise AssertionError(f"nmfk_score_sharded on the card missed a kernel: {entry['nmfk_launches']}")
    if entry["kmeans_launches"]["pairwise_sq_dists_batched"] < 1:
        raise AssertionError(f"KMeansBatchPlane(mesh=) on the card missed its kernel: {entry['kmeans_launches']}")
    entry.update(nmfk_bitwise=True, kmeans_scores=km[1], kmeans_bitwise=True, elastic_scores=runs[1][0],
                 elastic_counts=list(runs[1][1:]))
    log(json.dumps(entry))


def run_rescalk_searches(torch, dev, ops, log) -> dict[str, dict[str, int]]:
    """rescalk_1000 on the serial and the threads executor: launch counts by path."""
    from repro_torch.factorization.synthetic import rescal_data

    x = rescal_data(**RESCAL_DATA, device="cpu")[0].to(dev)
    return {f"rescalk_1000_{ex}": run_rescalk_search(torch, ops, x, ex, log) for ex in ("serial", "threads")}


def run_rescalk_search(torch, ops, x, executor: str, log) -> dict[str, int]:
    """rescalk_1000 on one executor; counts reset just before, read just after."""
    from repro_torch.core import binary_bleed_search
    from repro_torch.factorization.rescal import make_rescalk_evaluator

    evaluate = make_rescalk_evaluator(x, seed=0, n_perturbs=RESCAL_P, iters=RESCAL_ITERS, epsilon=RESCAL_EPS)
    resources = 1 if executor == "serial" else RESCAL_THREADS
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = sync_wall(torch)
    res = binary_bleed_search(evaluate, **RESCAL_SEARCH, num_resources=resources)
    wall = sync_wall(torch) - t0
    counts = ops.launch_counts()
    log(json.dumps({"search": f"rescalk_1000 {executor}", "k_optimal": res.k_optimal, "resources": resources,
                    "visited": {v.k: v.score for v in sorted(res.visits, key=lambda v: v.k)}, "wall_s": wall,
                    "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": counts}))
    if res.k_optimal != RESCAL_DATA["k_true"]:
        raise AssertionError(f"rescalk_1000 {executor}: k_optimal {res.k_optimal} != {RESCAL_DATA['k_true']}")
    if counts["silhouette_dist_sums"] < 1:
        raise AssertionError(f"rescalk_1000 {executor}: silhouette_dist_sums was never launched on the main path")
    return counts


def run_distributed_fit_search(torch, ops, ksearch, log) -> dict[str, int]:
    """The paper-scale NMFk search on threads with --distributed-fit
    --resources 2; counts reset just before, read just after."""
    import torch.distributed as dist

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = ksearch.main(PAPER_ARGS + ["--executor", "threads", "--distributed-fit", "--resources", "2"])
    counts = ops.launch_counts()
    log(json.dumps({"search": "nmfk_distributed_fit", "k_optimal": out["k_optimal"], "visited": out["visited"],
                    "wall_s": out["seconds"], "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "launches": counts}))
    if out["k_optimal"] != 8:
        raise AssertionError(f"nmfk_distributed_fit: k_optimal {out['k_optimal']} != 8")
    if dist.is_initialized():
        raise AssertionError("nmfk_distributed_fit: the search's process groups outlived it")
    # each scored k: the distributed fit's W-update beside each NMFk sweep's H and W
    if counts["mu_update_h"] < 1 or counts["mu_update_w"] != 2 * counts["mu_update_h"]:
        raise AssertionError(f"nmfk_distributed_fit: MU launches {counts}, want W twice H")
    return counts


def _live_pairs(lq: int, lk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the masks leave live: the work this run's data needs."""
    if not causal and window is None:
        return lq * lk
    w = window if window is not None else lk
    return sum(min(i + 1, w) for i in range(lq))


def _plain_fp64_err(ref, q, k, v, got, plain32, causal, window) -> tuple[float, float]:
    """Max abs error of the kernel and of the fp32 plain version against the
    plain version in float64, taken one kv head at a time (bounded memory)."""
    group = q.shape[1] // k.shape[1]
    err_kernel = err_plain = 0.0
    for kh in range(k.shape[1]):
        hs = slice(kh * group, (kh + 1) * group)
        want = ref.attention(q[:, hs].double(), k[:, kh:kh + 1].double(), v[:, kh:kh + 1].double(),
                             causal=causal, window=window)
        err_kernel = max(err_kernel, float((got[:, hs].double() - want).abs().max()))
        err_plain = max(err_plain, float((plain32[:, hs].double() - want).abs().max()))
        del want
    return err_kernel, err_plain


def check_flash(torch, dev, ops, ref, records: dict, log) -> None:
    """The flash kernel at the serve paths' prefill shapes (qwen2-0.5b: B 4,
    Hq 14, Hk 2, L 1000, D 64, causal; granite-moe-1b-a400m: B 4, Hq 16,
    Hk 8, L 1000, D 64, causal, drawn last so that the other cases keep
    their inputs), at h2o-danube-1.8b's heads with its
    window (B 1, Hq 32, Hk 8, L 6000, D 80, window 4096: ragged, and the
    window skip bites) and on a small ragged non-causal case with D 17 and
    an offset base (element-by-element loads and stores). Held against the
    fp32 plain version at the reference's tolerance; the errors of both
    against a float64 plain version are reported beside. Each case must give
    the same bits on a second call. The timed cases log both bounds: fp32 on
    CUDA cores, and the split-TF32 products on the tensor cores (the
    kernel's)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    cases = (
        ("qwen2-0.5b prefill: B 4, Hq 14, Hk 2, L 1000, D 64, causal", (4, 14, 2, 1000, 1000, 64), True, None,
         True),
        ("h2o-danube-1.8b heads: B 1, Hq 32, Hk 8, L 6000, D 80, causal, window 4096",
         (1, 32, 8, 6000, 6000, 80), True, 4096, True),
        ("ragged non-causal, offset base: B 2, Hq 6, Hk 3, Lq 70, Lk 45, D 17", (2, 6, 3, 70, 45, 17), False,
         None, False),
        ("granite-moe-1b-a400m prefill: B 4, Hq 16, Hk 8, L 1000, D 64, causal", (4, 16, 8, 1000, 1000, 64), True,
         None, True),
    )
    for label, (b, hq, hk, lq, lk, d), causal, window, timed in cases:
        q, k, v = (torch.randn((b, h, n, d), device=dev, generator=gen) for h, n in ((hq, lq), (hk, lk), (hk, lk)))
        if not timed:  # one float past a 16-byte boundary
            q, k, v = (torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape).copy_(t) for t in (q, k, v))
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        plain = ref.attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = compare(torch, got, plain, FLASH_TOL["rtol"], FLASH_TOL["atol"], f"flash_attention [{label}]")
        if not torch.equal(got, ops.flash_attention(q, k, v, causal=causal, window=window)):
            raise AssertionError(f"flash_attention [{label}]: two calls differ")
        err64, plain_err64 = _plain_fp64_err(ref, q, k, v, got, plain, causal, window)
        entry = {"case": label, "max_abs_err": err, "max_abs_err_vs_fp64": err64,
                 "plain_fp32_max_abs_err_vs_fp64": plain_err64, "repeat_bitwise": True}
        del got, plain
        if timed:
            pairs = _live_pairs(lq, lk, causal, window)
            flops = 4 * b * hq * d * pairs  # q.k and p.v multiply-adds on the live pairs
            n_bytes = 4 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v read; out written
            b32_ms, b32_by = bound_ms(n_bytes, flops)
            # the kernel's own work: three TF32 products for each fp32 one
            btc_ms, btc_by = bound_ms(n_bytes, 3 * flops, TF32_FLOPS_PER_S)
            if window is None:
                lib_kw = dict(is_causal=causal)
            else:  # SDPA takes a window only as an explicit mask
                i = torch.arange(lq, device=dev)
                lib_kw = dict(attn_mask=(i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window))
            entry.update(
                flops=flops, ms=time_ms(torch, lambda: ops.flash_attention(q, k, v, causal=causal, window=window)),
                plain_ms=time_ms(torch, lambda: ref.attention(q, k, v, causal=causal, window=window), reps=10),
                bound_ms=btc_ms, bound_by=btc_by, bound_fp32_ms=b32_ms, bound_fp32_by=b32_by,
                library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **lib_kw)),
                library="F.scaled_dot_product_attention(fp32, enable_gqa=True): the same function, one call",
            )
        del q, k, v
        log(json.dumps({"check": "flash_attention", **entry}))
        records.setdefault("flash_attention", []).append(entry)


def _decided(torch, logits, tokens) -> None:
    """Greedy tokens must agree wherever the top-2 logit margin exceeds the tolerance."""
    top2 = torch.topk(logits, 2, dim=-1).values
    tol = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * top2[..., 0].abs()
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol
    bad = decided & (torch.argmax(logits, dim=-1) != tokens)
    if bool(bad.any()):
        raise AssertionError(f"greedy tokens differ at a decided logit margin: {bad.nonzero().tolist()}")


class RouteWatch:
    """Hold the card's MoE routes to the CPU's, on the CPU's layer input.

    While active, every ``models.moe.route`` call on a CPU tensor is also
    made on the card (the same router and tokens moved there, the same
    capacity), and the two are compared token by token: each token's set of
    experts, and which of its slots are kept. A token may route differently
    only where the CPU's top-k margin (its k-th probability less its
    (k+1)-th) is below ``ROUTE_TIE_TOL``; a kept/dropped difference is
    allowed only on an expert such a flip touched, for a later token (its
    queue shifted). Anything else raises at once."""

    def __init__(self, torch, dev, label: str):
        from repro_torch.models import moe

        self.torch, self.dev, self.label, self.moe = torch, dev, label, moe
        self.calls, self.flips, self.dropped, self.min_margin, self.max_prob_gap = 0, [], 0, math.inf, 0.0

    def __enter__(self) -> "RouteWatch":
        self.real = self.moe.route

        def spy(params, xt, cfg, capacity):
            r = self.real(params, xt, cfg, capacity)
            if not xt.is_cuda:
                with self.torch.no_grad():
                    self._compare(params, xt, cfg, capacity, r)
            return r

        self.moe.route = spy
        return self

    def __exit__(self, *exc) -> None:
        self.moe.route = self.real

    def _compare(self, params, xt, cfg, capacity: int, r_cpu) -> None:
        torch = self.torch
        k = cfg.moe.top_k
        r_card = self.real({"router": params["router"].detach().to(self.dev)}, xt.detach().to(self.dev), cfg, capacity)
        self.calls += 1
        self.dropped += int((~r_cpu.keep).sum())
        self.min_margin = min(self.min_margin, float(r_cpu.margin.min()))
        self.max_prob_gap = max(self.max_prob_gap, float((r_card.probs.cpu() - r_cpu.probs).abs().max()))
        if self.max_prob_gap > ROUTE_TIE_TOL / 2:
            raise AssertionError(f"{self.label}: route {self.calls}: the card's router probabilities are "
                                 f"{self.max_prob_gap:.3e} from the CPU's")
        ids_cpu, order_cpu = r_cpu.expert_ids.view(-1, k).sort(dim=1)
        ids_card, order_card = r_card.expert_ids.cpu().view(-1, k).sort(dim=1)
        keep_cpu = r_cpu.keep.view(-1, k).gather(1, order_cpu)
        keep_card = r_card.keep.cpu().view(-1, k).gather(1, order_card)
        flipped = (ids_cpu != ids_card).any(dim=1).nonzero()[:, 0].tolist()
        margins = r_cpu.margin
        far = [t for t in flipped if float(margins[t]) >= ROUTE_TIE_TOL]
        if far:
            raise AssertionError(f"{self.label}: route {self.calls}: the card routes tokens {far[:8]} to other "
                                 f"experts at CPU margins {[float(margins[t]) for t in far[:8]]} >= {ROUTE_TIE_TOL}")
        touched = set()
        for t in flipped:
            touched |= set(ids_cpu[t].tolist()) ^ set(ids_card[t].tolist())
            self.flips.append({"route": self.calls, "token": t, "margin": float(margins[t]),
                               "cpu": ids_cpu[t].tolist(), "card": ids_card[t].tolist()})
            print(f"{self.label}: near-tie route flip {self.flips[-1]}", flush=True)
        first = min(flipped, default=None)
        for t, j in (keep_cpu != keep_card).nonzero().tolist():
            if t in flipped:
                continue
            if first is None or t < first or int(ids_cpu[t, j]) not in touched:
                raise AssertionError(f"{self.label}: route {self.calls}: token {t} slot of expert "
                                     f"{int(ids_cpu[t, j])} kept on one side only, with no near-tie flip before it")

    def blame(self, e: AssertionError) -> AssertionError:
        """``e`` again, saying whether it coincides with near-tie route flips."""
        if not self.flips:
            return e
        return AssertionError(f"{e} (coincides with {len(self.flips)} near-tie route flips, margins "
                              f"{[f['margin'] for f in self.flips]})")

    def summary(self) -> dict:
        return {"routes_compared": self.calls, "route_flips": self.flips, "min_route_margin": self.min_margin,
                "max_prob_gap": self.max_prob_gap, "route_tie_tol": ROUTE_TIE_TOL, "dropped_slots_cpu": self.dropped}


def check_lm_small(torch, dev, ops, log) -> None:
    """The LM's prefill logits and 8 greedy tokens on the card (flash kernel
    for GQA) against the CPU (plain path), same weights, teacher-forced with
    the card's tokens: qwen2-0.5b at full width (vocab 151,936) cut to 2
    layers, B 1, prompt 200; reduced h2o-danube-1.8b (window 16), B 2,
    prompt 40; granite-moe-1b-a400m at full width cut to 2 layers, B 1,
    prompt 200; deepseek-v2 at full widths cut to 2 layers (the dense first
    layer and one MoE layer) and 16 of its 160 routed experts, B 1, prompt
    64 (MLA: no flash launch). Every MoE route is held to the CPU's
    (``RouteWatch``)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import setup
    from repro_torch.serve.decode import generate

    cpu = torch.device("cpu")
    deepseek = get_config("deepseek-v2-236b")
    cases = (
        ("qwen2-0.5b, full width, 2 layers", dataclasses.replace(get_config("qwen2-0.5b"), num_layers=2), 1, 200),
        ("h2o-danube-1.8b reduced, window 16", reduced_config(get_config("h2o-danube-1.8b")), 2, 40),
        ("granite-moe-1b-a400m, full width, 2 layers",
         dataclasses.replace(get_config("granite-moe-1b-a400m"), num_layers=2), 1, 200),
        (f"deepseek-v2, full widths, 2 layers (dense + MoE), {DEEPSEEK_SMALL_EXPERTS} routed experts",
         dataclasses.replace(deepseek, num_layers=2,
                             moe=dataclasses.replace(deepseek.moe, num_experts=DEEPSEEK_SMALL_EXPERTS)), 1, 64),
    )
    steps = 8
    for label, cfg, batch, plen in cases:
        cpu_model, prompt, _, _ = setup(cfg, batch, plen, cpu, seed=0)
        card_model = copy.deepcopy(cpu_model).to(dev)
        ops.reset_launch_counts()
        lg_card, c_card = card_model.prefill({"tokens": prompt.to(dev)}, cache_len=plen + steps)
        flash = ops.launch_counts()["flash_attention"]
        with RouteWatch(torch, dev, label) as routes:
            lg_cpu, c_cpu = cpu_model.prefill({"tokens": prompt}, cache_len=plen + steps)
            gaps = []
            try:
                gaps.append(compare(torch, lg_card.cpu(), lg_cpu, LOGIT_TOL["rtol"], LOGIT_TOL["atol"],
                                    f"{label}: prefill logits"))
                tok = torch.argmax(lg_card[:, -1], dim=-1)[:, None]
                _decided(torch, lg_cpu[:, -1], tok[:, 0].cpu())
                tokens = [tok]
                for i in range(steps - 1):
                    lg_card, c_card = card_model.decode_step(c_card, tok, plen + i)
                    lg_cpu, c_cpu = cpu_model.decode_step(c_cpu, tok.cpu(), plen + i)
                    gaps.append(compare(torch, lg_card.cpu(), lg_cpu, LOGIT_TOL["rtol"], LOGIT_TOL["atol"],
                                        f"{label}: decode step {i} logits"))
                    tok = torch.argmax(lg_card[:, -1], dim=-1)[:, None]
                    _decided(torch, lg_cpu[:, -1], tok[:, 0].cpu())
                    tokens.append(tok)
            except AssertionError as e:
                raise routes.blame(e) from e
        tokens = torch.cat(tokens, dim=1)
        if not torch.equal(generate(card_model, prompt.to(dev), steps=steps), tokens.to(torch.int32)):
            raise AssertionError(f"{label}: generate's greedy tokens differ from the teacher-forced loop's")
        want_flash = 0 if cfg.attention == "mla" else cfg.num_layers
        if flash != want_flash:
            raise AssertionError(f"{label}: {flash} flash launches in one prefill of {cfg.num_layers} layers, "
                                 f"not {want_flash}")
        if cfg.moe is not None and not routes.calls:
            raise AssertionError(f"{label}: no MoE route was compared")
        log(json.dumps({"check": f"lm card vs plain: {label}", "batch": batch, "prompt": plen,
                        "logits_max_abs_gap": max(gaps), "tokens": tokens.tolist(),
                        "flash_launches_per_prefill": flash,
                        **(routes.summary() if cfg.moe is not None else {})}))
        del card_model, c_card, cpu_model, c_cpu


def _train_vs_cpu(torch, dev, log, label: str, cfg):
    """Loss, router aux loss and every gradient of ``cfg`` on the card
    against the CPU (B 2, L 32, the same weights and batch), MoE routes held
    to the CPU's; remat ``full`` and ``dots`` against ``none``, bit for bit
    wherever two ``none`` runs are. Returns (CPU model, card batch, card
    loss, card gradients, CPU gradients)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import SyntheticTokenSource, device_put_batch
    from repro_torch.models.transformer import Model
    from repro_torch.train.train_step import accumulate_grads

    cpu = torch.device("cpu")
    cpu_model = Model(cfg, remat="none")
    cpu_model.init(torch.Generator().manual_seed(0))
    batch_np = SyntheticTokenSource(cfg, ShapeConfig("smoke", 32, 2, "train")).batch_at(0)
    batch_cpu = device_put_batch(batch_np, cpu)
    with RouteWatch(torch, dev, f"train {label}") as routes:
        loss_cpu, g_cpu = accumulate_grads(cpu_model, batch_cpu, 1)
        with torch.no_grad():
            _, aux_cpu = cpu_model.hidden(cpu_model.embed_input(batch_cpu))
    batch = device_put_batch(batch_np, dev)

    def card_model(remat: str = "none") -> "Model":
        m = Model(cfg, remat=remat)
        m.params = copy.deepcopy(cpu_model.params).to(dev)
        return m

    runs = {name: accumulate_grads(card_model(name.split()[0]), batch, 1)
            for name in ("none", "none again", "full", "dots")}
    loss, grads = runs["none"]
    m = card_model()
    with torch.no_grad():
        _, aux = m.hidden(m.embed_input(batch))
    del m
    loss_gap = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
    aux_gap = abs(float(aux) - float(aux_cpu)) / max(abs(float(aux_cpu)), 1e-30)
    try:
        if not math.isfinite(float(loss)) or loss_gap > TRAIN_LOSS_RTOL:
            raise AssertionError(f"train {label}: card loss {float(loss)} against the CPU's {float(loss_cpu)}")
        if cfg.moe is not None and (aux_gap > TRAIN_LOSS_RTOL or not float(aux_cpu) > 0):
            raise AssertionError(f"train {label}: card aux loss {float(aux)} against the CPU's {float(aux_cpu)}")
        worst = 0.0
        for name, g in grads.items():
            if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0.0:
                raise AssertionError(f"train {label}: the card's gradient of {name} is zero or not finite")
            want = g_cpu[name].to(dev)
            gap = float(torch.linalg.norm(g - want) / torch.linalg.norm(want))
            worst = max(worst, gap)
            if gap > TRAIN_GRAD_NORM_RTOL:
                raise AssertionError(f"train {label}: gradient of {name}: relative norm error {gap:.3e} "
                                     "against the CPU's")
    except AssertionError as e:
        raise routes.blame(e) from e
    bitwise = {}
    for name in ("none again", "full", "dots"):
        l_r, g_r = runs[name]
        bitwise[name] = bool(torch.equal(l_r, loss)) and all(torch.equal(g_r[k], grads[k]) for k in grads)
        gap = max(float(torch.linalg.norm(g_r[k] - grads[k]) / torch.linalg.norm(grads[k])) for k in grads)
        if gap > TRAIN_GRAD_NORM_RTOL or (bitwise["none again"] and not bitwise[name]):
            raise AssertionError(f"train {label}: remat {name} differs from none (relative norm error {gap:.3e}; "
                                 f"two none runs bitwise: {bitwise['none again']})")
    del runs
    if cfg.moe is not None and not routes.calls:
        raise AssertionError(f"train {label}: no MoE route was compared")
    log(json.dumps({"check": f"train card vs plain: {label}", "batch": 2, "seq": 32,
                    "loss": float(loss), "loss_rel_gap": loss_gap, "aux": float(aux), "aux_rel_gap": aux_gap,
                    "grad_worst_rel_norm_err": worst, "params_with_grad": len(grads), "bitwise_vs_none": bitwise,
                    **(routes.summary() if cfg.moe is not None else {})}))
    return cpu_model, batch, loss, grads, g_cpu


def check_train_small(torch, dev, ops, log) -> None:
    """Training on the card against the CPU, the same weights and batch
    (``_train_vs_cpu``): qwen2-0.5b and granite-moe-1b-a400m, each at full
    width (vocab 151,936 / 49,155) cut to 2 layers, B 2, L 32. Then, on
    qwen2 only, 2 microbatches' accumulated gradients against 1's, and
    against a planted fault (the second microbatch dropped) that the check
    must catch; one AdamW step on the same gradients; a bitwise checkpoint
    round trip of (params, opt state). No flash launch, and the flash
    wrapper refuses an operand that requires grad."""
    import tempfile

    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state
    from repro_torch.train.train_step import accumulate_grads

    ops.reset_launch_counts()
    granite = dataclasses.replace(get_config("granite-moe-1b-a400m"), num_layers=2)
    _train_vs_cpu(torch, dev, log, "granite-moe-1b-a400m, full width, 2 layers", granite)
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=2)
    cpu_model, batch, loss, grads, g_cpu = _train_vs_cpu(torch, dev, log, "qwen2-0.5b, full width, 2 layers", cfg)

    def card_model() -> "Model":
        from repro_torch.models.transformer import Model

        m = Model(cfg, remat="none")
        m.params = copy.deepcopy(cpu_model.params).to(dev)
        return m

    def worst_gap(got: dict, want: dict) -> float:
        return max(float(torch.linalg.norm(got[k] - want[k]) / torch.linalg.norm(want[k])) for k in want)

    # 2 microbatches against 1, on qwen2 only: an MoE layer's capacity is per
    # microbatch and its load-balance loss is not linear over microbatches
    # (as in the reference), so on granite the two do not agree
    m = card_model()
    loss_micro, g_micro = accumulate_grads(m, batch, 2)
    loss_gap_micro = abs(float(loss_micro) - float(loss))
    grad_gap_micro = worst_gap(g_micro, grads)
    if loss_gap_micro > MICRO_LOSS_ATOL or grad_gap_micro > TRAIN_GRAD_NORM_RTOL:
        raise AssertionError(f"train: 2 microbatches against 1: loss gap {loss_gap_micro:.3e}, "
                             f"gradients' relative norm error {grad_gap_micro:.3e}")
    # the planted fault: the first microbatch's gradients alone, divided by 2
    _, g_first = accumulate_grads(m, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, 1)
    fault_gap = worst_gap({k: g / 2 for k, g in g_first.items()}, grads)
    if fault_gap <= TRAIN_GRAD_NORM_RTOL:
        raise AssertionError(f"train: dropping the second microbatch moves the gradients by {fault_gap:.3e} only")
    del m, g_micro, g_first

    adamw_cfg = AdamWConfig(lr=1e-3)
    params_cpu = copy.deepcopy(cpu_model.params)
    params = copy.deepcopy(cpu_model.params).to(dev)
    _, st_cpu, met_cpu = adamw_update(params_cpu, g_cpu, init_opt_state(params_cpu, adamw_cfg), adamw_cfg)
    _, st, met = adamw_update(params, {k: g.to(dev) for k, g in g_cpu.items()}, init_opt_state(params, adamw_cfg),
                              adamw_cfg)
    adamw_gap = max(
        [compare(torch, a.detach().cpu(), b.detach(), what=f"adamw: {n}", **ADAMW_TOL)
         for (n, a), b in zip(params.named_parameters(), params_cpu.parameters())]
        + [compare(torch, st.m[k].cpu(), st_cpu.m[k], what=f"adamw: m of {k}", **ADAMW_TOL) for k in st.m]
        + [compare(torch, st.v[k].cpu(), st_cpu.v[k], what=f"adamw: v of {k}", **ADAMW_TOL) for k in st.v])

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ckpt.save(root, 1, (params, st))
        (got_p, got_st), step = ckpt.restore(root, (params, st))
        ckpt_s = time.perf_counter() - t0
    same = (step == 1 and torch.equal(got_st.step, st.step)
            and all(a.device == b.device and torch.equal(a, b) for a, b in zip(got_p.parameters(), params.parameters()))
            and all(torch.equal(got_st.m[k], st.m[k]) and torch.equal(got_st.v[k], st.v[k]) for k in st.m))
    if not same:
        raise AssertionError("train: the checkpoint round trip of (params, opt state) is not bitwise")

    q = torch.zeros((1, 2, 8, 16), device=dev, requires_grad=True)
    try:
        ops.flash_attention(q, q[:, :1].detach(), q[:, :1].detach())
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
    else:
        raise AssertionError("train: the flash wrapper took an operand that requires grad")
    flash = ops.launch_counts()["flash_attention"]
    if flash:
        raise AssertionError(f"train: {flash} flash launches in the training checks")
    log(json.dumps({"check": "train card vs plain, qwen2-0.5b: microbatches, AdamW, checkpoint, flash guard",
                    "microbatch_loss_gap": loss_gap_micro, "microbatch_grad_worst_rel_norm_err": grad_gap_micro,
                    "microbatch_dropped_fault_rel_norm_err": fault_gap,
                    "adamw_max_abs_err": adamw_gap, "grad_norm": float(met["grad_norm"]),
                    "grad_norm_cpu": float(met_cpu["grad_norm"]), "checkpoint_roundtrip_s": ckpt_s,
                    "flash_launches": flash, "flash_guard": "raised"}))
    del params, params_cpu, st, st_cpu, got_p, got_st, cpu_model


def run_train(torch, dev, ops, train, log, arch: str) -> dict[str, int]:
    """The training path at full width; counts reset just before, read just after."""
    import statistics

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = train.main(train_args(arch))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, norms, walls = out["losses"], out["grad_norms"], out["step_seconds"]
    median = statistics.median(walls)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(p.numel() for p in out["params"].parameters())
    # matmul work of a step: 6 flops a parameter a token (forward and
    # backward), counting each MoE layer's active experts (top-k of them)
    n_active = cfg.active_param_count() if cfg.moe is not None else n_params
    bound, bound_by = bound_ms(0, 6 * n_active * tokens)
    log(json.dumps({"train": f"{arch} full width", "layers": cfg.num_layers, "params": n_params,
                    "active_params": n_active, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                    "microbatches": TRAIN_MICRO, "steps": len(losses),
                    "losses": losses, "grad_norms": norms, "step_seconds": walls, "median_step_s": median,
                    "tokens_per_s_median": tokens / median, "tokens_per_s": out["tokens_per_s"],
                    "step_bound_ms": bound, "step_bound_by": bound_by, "max_memory_allocated": peak,
                    "launches": counts, "card": smi_line()}))
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train {arch}: losses {losses}, grad norms {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train {arch}: the loss did not fall: {losses[0]} -> {losses[-1]}")
    if not all(bool(torch.isfinite(p).all()) for p in out["params"].parameters()):
        raise AssertionError(f"train {arch}: non-finite parameters after training")
    if any(counts.values()):
        raise AssertionError(f"train {arch}: kernel launches on the training path: {counts}")
    del out
    return counts


class DropCount:
    """Count the dropped MoE slots of every ``models.moe.route`` call made
    while active, by batch row (``rows`` rows of the same length; one host
    read a call)."""

    def __init__(self, rows: int):
        from repro_torch.models import moe

        self.moe, self.rows, self.by_call = moe, rows, []

    def __enter__(self) -> "DropCount":
        self.real = self.moe.route

        def spy(params, xt, cfg, capacity):
            r = self.real(params, xt, cfg, capacity)
            self.by_call.append((~r.keep).view(self.rows, -1).sum(dim=1).tolist())
            return r

        self.moe.route = spy
        return self

    def __exit__(self, *exc) -> None:
        self.moe.route = self.real

    def by_row(self) -> list[int]:
        return [sum(call[b] for call in self.by_call) for b in range(self.rows)]


def _teacher_forced(torch, model, prompt, tokens, arch: str, order: list[int]) -> dict:
    """One pass of ``run_serve``'s teacher-forced check, with the batch rows
    in ``order``: two decode steps fed the served tokens, each held against
    the last row of a flash prefill of the extended sequence, on the rows
    that kept every MoE slot in both prefills. Such a row is computed alike
    by both: its slots never pass an expert's capacity (decode's batch of 4
    never does). A row with a dropped slot is not: the prefill dropped what
    decode keeps. Queues fill in batch order, so the later rows drop
    first."""
    prompt, tokens = prompt[order], tokens[order]
    with DropCount(SERVE_BATCH) as drops:
        lg, caches = model.prefill({"tokens": prompt}, cache_len=SERVE_PROMPT + 2)
    row_drops = drops.by_row()
    dropped = [sum(row_drops)]
    gaps, dropped_row_gaps = [], []
    for i in range(2):
        lg_dec, caches = model.decode_step(caches, tokens[:, i:i + 1], SERVE_PROMPT + i)
        seq = torch.cat([prompt, tokens[:, :i + 1].long()], dim=1)
        with DropCount(SERVE_BATCH) as drops:
            lg_full, _ = model.prefill({"tokens": seq})
        dropped.append(sum(drops.by_row()))
        row_drops = [a + b for a, b in zip(row_drops, drops.by_row())]
        rows = [b for b in range(SERVE_BATCH) if row_drops[b] == 0]
        if rows:
            what = (f"serve {arch}: decode step {i} vs flash prefill of {seq.shape[1]} tokens, "
                    f"prompts {[order[b] for b in rows]} in rows {rows}")
            gaps.append(compare(torch, lg_dec[rows], lg_full[rows], LOGIT_TOL["rtol"], LOGIT_TOL["atol"], what))
            _decided(torch, lg_dec[rows, -1], tokens[rows, i + 1])
        if len(rows) < SERVE_BATCH:
            dropped_row_gaps.append(float((lg_dec - lg_full).abs().amax(dim=(1, 2)).max()))
    del caches
    return {"order": order, "prompts_compared": [order[b] for b in rows], "logits_max_abs_gap": max(gaps, default=0.0),
            "logits_max_abs": float(lg_full.abs().max()), "dropped_slots_by_prefill": dropped,
            "dropped_slots_by_row": row_drops, "max_abs_gap_with_dropped_rows": max(dropped_row_gaps, default=0.0)}


def run_serve(torch, dev, ops, serve, log, arch: str) -> dict[str, int]:
    """The serve path at full width; counts reset just before, read just
    after. Then a teacher-forced check with the same weights: decode-step
    logits (plain attention over the cache) against the last row of a flash
    prefill of the extended sequence, with each prefill's dropped MoE slots
    (capacity factor 2.0, as decode). With MoE it runs twice, the second
    time with the two halves of the batch swapped, and every prompt must be
    compared in one of the two passes: granite's capacity at factor 2.0
    (t · 8 · 2 / 32) is half the tokens and a token takes one slot of an
    expert at most, so the first half of the batch never drops."""
    from repro_torch.configs import get_config

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve.main(serve_args(arch))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = out["tokens"]
    new = SERVE_BATCH * (SERVE_TOKENS - 1)
    log(json.dumps({"serve": f"{arch} full width", "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
                    "tokens": SERVE_TOKENS, "wall_s": out["seconds"], "prefill_s": out["prefill_s"],
                    "decode_s": out["decode_s"], "decode_tokens_per_s": new / out["decode_s"],
                    "tokens_per_s": SERVE_BATCH * SERVE_TOKENS / out["seconds"],
                    "max_memory_allocated": peak, "launches": counts,
                    "sample": tokens[0].tolist()}))
    cfg = get_config(arch)
    if tuple(tokens.shape) != (SERVE_BATCH, SERVE_TOKENS):
        raise AssertionError(f"serve {arch}: tokens of shape {tuple(tokens.shape)}")
    if counts["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"serve {arch}: {counts['flash_attention']} flash launches for one prefill of "
                             f"{cfg.num_layers} layers")

    model, prompt, _, _ = serve.setup(cfg, SERVE_BATCH, SERVE_PROMPT, dev, seed=0)
    orders = [list(range(SERVE_BATCH))]
    if cfg.moe is not None:
        half = SERVE_BATCH // 2
        orders.append(orders[0][half:] + orders[0][:half])
    passes = [_teacher_forced(torch, model, prompt, tokens, arch, order) for order in orders]
    compared = sorted(set().union(*(p["prompts_compared"] for p in passes)))
    if compared != orders[0]:
        raise AssertionError(f"serve {arch}: prompts {sorted(set(orders[0]) - set(compared))} dropped MoE slots "
                             f"in every pass; not compared ({passes})")
    log(json.dumps({"check": f"serve {arch} decode vs flash prefill, teacher-forced", "steps": 2,
                    "logits_max_abs_gap": max(p["logits_max_abs_gap"] for p in passes),
                    "logits_max_abs": max(p["logits_max_abs"] for p in passes),
                    **({"passes": passes} if cfg.moe is not None else {})}))
    del model
    return counts


def run_deepseek_serve(torch, dev, ops, log) -> dict[str, int]:
    """deepseek-v2 at its published widths (MLA, 160 routed and 2 shared
    experts) cut to 2 layers, on the card only: ``generate`` with counts reset
    just before, read just after (no flash launch: MLA takes plain
    attention); then the absorbed MLA decode's logits, teacher-forced,
    against the last row of the expanded full forward of the extended
    sequence, routed at a capacity factor of E / top_k + 1, where every
    expert has a slot for every token and none can drop (the reference's
    ``test_decode_matches_full_forward`` aligns its capacity factor the same
    way): a prefill of 257 tokens at 2.0 has 19 slots an expert and may drop
    the newest token's, which the decode step keeps."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import setup
    from repro_torch.models.transformer import Model
    from repro_torch.serve.decode import generate

    full = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(full, num_layers=DEEPSEEK_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model, prompt, _, _ = setup(cfg, 1, DEEPSEEK_PROMPT, dev, seed=0)
    n_params = sum(p.numel() for p in model.params.parameters())
    timings: dict = {}
    ops.reset_launch_counts()
    t0 = sync_wall(torch)
    tokens = generate(model, prompt, steps=DEEPSEEK_TOKENS, timings=timings)
    wall = sync_wall(torch) - t0
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"deepseek serve: kernel launches {counts} (MLA takes no kernel)")
    aligned = Model(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k + 1)))
    aligned.params = model.params
    with DropCount(1) as drops:
        lg, caches = model.prefill({"tokens": prompt}, cache_len=DEEPSEEK_PROMPT + DEEPSEEK_TOKENS)
    prefill_dropped = sum(drops.by_row())
    gaps = []
    for i in range(DEEPSEEK_TOKENS - 1):
        lg_dec, caches = model.decode_step(caches, tokens[:, i:i + 1], DEEPSEEK_PROMPT + i)
        seq = torch.cat([prompt, tokens[:, :i + 1].long()], dim=1)
        with DropCount(1) as drops:
            h, _ = aligned.backbone(aligned.embed_input({"tokens": seq}))
        if any(drops.by_row()):
            raise AssertionError(f"deepseek serve: the aligned forward dropped {drops.by_row()} slots")
        gaps.append(compare(torch, lg_dec, aligned.logits(h[:, -1:]), LOGIT_TOL["rtol"], LOGIT_TOL["atol"],
                            f"deepseek serve: absorbed decode step {i} vs the expanded forward of {seq.shape[1]}"))
        _decided(torch, lg_dec[:, -1], tokens[:, i + 1])
    peak = torch.cuda.max_memory_allocated()
    log(json.dumps({"serve": f"deepseek-v2 full widths, {DEEPSEEK_LAYERS} layers", "params": n_params,
                    "batch": 1, "prompt": DEEPSEEK_PROMPT, "tokens": DEEPSEEK_TOKENS, "wall_s": wall,
                    "prefill_s": timings["prefill_s"], "decode_s": timings["decode_s"],
                    "sample": tokens[0].tolist(), "launches": counts,
                    "decode_vs_expanded_max_abs_gap": max(gaps), "logits_max_abs": float(lg_dec.abs().max()),
                    "prefill_dropped_slots": prefill_dropped, "max_memory_allocated": peak}))
    del model, aligned, caches
    return counts


SOURCES = {
    "mu_update_h": ("src/repro_torch/kernels/csrc/nmf_update.cu", "src/repro/kernels/nmf_update.py:98"),
    "mu_update_w": ("src/repro_torch/kernels/csrc/nmf_update.cu", "src/repro/kernels/nmf_update.py:129"),
    "silhouette_dist_sums": (
        "src/repro_torch/kernels/csrc/silhouette_sums.cu", "src/repro/kernels/silhouette_sums.py:80"),
    "silhouette_dist_sums_batched": (
        "src/repro_torch/kernels/csrc/silhouette_sums.cu", "src/repro/kernels/silhouette_sums.py:156"),
    "pairwise_sq_dists": ("src/repro_torch/kernels/csrc/pairwise_dist.cu", "src/repro/kernels/pairwise_dist.py:48"),
    "pairwise_sq_dists_batched": (
        "src/repro_torch/kernels/csrc/pairwise_dist.cu", "src/repro/kernels/pairwise_dist.py:103"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:102"),
}


def multi_rank_only() -> int:
    """``--multi-rank-only``, on a machine with 4 cards: build the kernels,
    run the world-1 searches the 4-rank ones are compared with (batched,
    sharded sync and elastic; twice, in turns), then only the multi-rank
    phase (``run_multi_rank_searches``)."""
    import torch

    if torch.cuda.device_count() < 4:
        print(f"chip_smoke --multi-rank-only: needs 4 cards, sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve
    from repro_torch.kernels import build, ops
    from repro_torch.launch import ksearch

    def log(line: str) -> None:
        print(line, flush=True)

    log(smi_line())
    log(f"torch: {torch.__version__} cuda {torch.version.cuda} cards {torch.cuda.device_count()}")
    dev = resolve("cuda")
    t0 = time.perf_counter()
    build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for _ in range(2):
        run_search(torch, ops, ksearch, "batched", log)
        run_search(torch, ops, ksearch, "sharded", log, ("--comm", "sync"), "nmfk_sharded")
        run_elastic_search(torch, dev, ops, ksearch, "nmfk_elastic", [], log)
    t0 = time.perf_counter()
    by_path = run_multi_rank_searches(torch, log)
    log(f"multi-rank phase: {time.perf_counter() - t0:.1f} s")
    log(smi_line())
    log(json.dumps(by_path))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--rank-search"]:  # one rank of run_multi_rank_searches
        return rank_search(Path(sys.argv[2]))
    if sys.argv[1:] == ["--multi-rank-only"]:
        return multi_rank_only()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import ksearch, serve, train

    def log(line: str) -> None:
        print(line, flush=True)

    t_start = time.perf_counter()
    dev = resolve("cuda")
    log(smi_line())
    log(f"torch: {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(built)} libraries (parallel nvcc)")
    for b in built.values():
        log(f"build {b.name}: {b.path.name} nvcc {b.seconds if b.seconds is None else round(b.seconds, 2)} s")
        for line in b.log.splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"  {line.strip()}")
    mu_lib = build.load("nmf_update")
    log("nmf_update dynamic shared memory (bytes) by rank bucket: " + json.dumps(
        {f"{upd}_kb{kb}": mu_lib.mu_dynamic_smem(i, kb) for i, upd in enumerate("hw") for kb in (16, 32, 64, 128)}))

    records: dict[str, list] = {}
    check_mu(torch, dev, ops, ref, records, log)
    check_sums(torch, dev, ops, ref, records, log)
    check_pairwise(torch, dev, ops, ref, records, log)
    check_flash(torch, dev, ops, ref, records, log)
    check_nmfk_small(torch, dev, log)
    check_nmfk_elastic_small(torch, dev, ops, log)
    check_kmeans_small(torch, dev, ops, log)
    check_lm_small(torch, dev, ops, log)
    check_train_small(torch, dev, ops, log)
    check_rescal_small(torch, dev, ops, log)
    check_distributed_small(torch, dev, ops, log)
    check_sharded_small(torch, dev, ops, log)

    by_path = {f"nmfk_{ex}": run_search(torch, ops, ksearch, ex, log) for ex in ("batched", "threads")}
    by_path["nmfk_elastic_oracle"], _ = run_elastic_search(
        torch, dev, ops, ksearch, "nmfk_elastic_oracle", ["--tol", "0", "--no-warm-start"], log, oracle=True)
    by_path["nmfk_elastic"], elastic = run_elastic_search(torch, dev, ops, ksearch, "nmfk_elastic", [], log)
    by_path["nmfk_elastic_mesh"], _ = run_elastic_search(
        torch, dev, ops, ksearch, "nmfk_elastic_mesh", ["--lanes", "1"], log, same_as=elastic)
    by_path["nmfk_distributed_fit"] = run_distributed_fit_search(torch, ops, ksearch, log)
    by_path["nmfk_sharded"] = run_search(torch, ops, ksearch, "sharded", log, ("--comm", "sync"), "nmfk_sharded")
    by_path.update(run_multi_rank_searches(torch, log))
    by_path.update(run_rescalk_searches(torch, dev, ops, log))
    by_path.update({f"kmeans_{ex}": run_kmeans_search(torch, dev, ops, ex, log) for ex in ("threads", "batched")})
    by_path["serve"] = run_serve(torch, dev, ops, serve, log, "qwen2-0.5b")
    by_path["granite_serve"] = run_serve(torch, dev, ops, serve, log, "granite-moe-1b-a400m")
    by_path["deepseek_serve_2l"] = run_deepseek_serve(torch, dev, ops, log)
    by_path["qwen2_train"] = run_train(torch, dev, ops, train, log, "qwen2-0.5b")
    by_path["granite_train"] = run_train(torch, dev, ops, train, log, "granite-moe-1b-a400m")

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        timed = next(r for r in records[name] if "ms" in r)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {ex: c[name] for ex, c in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in records[name]),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed.get("library_ms"), "case": timed["case"],
            **({"bound_fp32_ms": timed["bound_fp32_ms"]} if "bound_fp32_ms" in timed else {}),
        })
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
