#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

On a machine with four, ``python3 chip_smoke.py --multi-rank-only`` builds
the kernels and runs only the 4-rank searches of phase 5 and the one-rank
searches they are compared with, then phase 5's 4-rank serves and trains
(each with the one-card runs it is held to) and the training options on a
mesh (``granite_train_opts_mesh22``).

Phases, each fatal on failure:

  1. print the card (nvidia-smi name and power limit, torch device name);
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc,
     one process per source, all at once (build time and ``-Xptxas -v``:
     registers, shared memory, spills); then start the dry run
     (``launch.dryrun``) on the host in two processes of its own, one a
     production mesh ((16, 16) and (2, 16, 16)), with no card visible:
     every arch's decode_32k and long_500k, train_4k of llama3-405b,
     granite-moe-1b-a400m and qwen2-0.5b (the sequence-parallel residual),
     the prefill_32k of granite and deepseek-v2, each cell's step run
     once on ``meta`` over a fake process group; read at the end of phase
     5: ``ok`` where ``check_mesh`` admits the arch at model 16 (every
     arch of the registry), ``error`` with exactly its refusal, ``skip``
     exactly where ``shape_applicable`` says, one line a cell (bytes a
     rank, peak, FLOPs, census bytes), qwen2-0.5b's train_4k peak below
     80 × 10^9 bytes a rank (its loss keeps the logits cut over the
     vocabulary);
  3. hold each kernel wrapper against its plain PyTorch version on the card
     at the shapes of the main paths (flash also at jamba's D 128, at
     one rank's heads of ``jamba_serve_tp4``: Hq 8, Hk 2, and at each
     rank's query block of ``qwen2_serve_seq14``'s sequence-parallel
     prefill: Lq 250 of Lk 1000 at q_offset 0, 250, 500, 750), with the
     tolerance stated, and time
     kernel, plain version, the card's bound and, where one PyTorch call
     computes the same function, that call (CUDA events, warmed up); the
     flash kernel's cases also assert a bitwise repeat; the bf16 halves
     of the MU kernels (L 32, 8, 4 and 1 at 1000 x 1100, k 16; then both
     updates at every rank bucket, split units and past rank 128, with the
     C entry point each took) and of the silhouette kernel (52, 12 and 33
     points in 2-D; 8 lanes and one lane of 64 points; d 1000; the fp32
     kernel's bits on the widened operands on the thin and the general
     path, a ``fill_`` floor beside each time) at the reference's bf16
     tolerances, each kernel's float64 error at most twice its plain
     version's, a bitwise repeat, the bound from bf16 bytes; the bf16 half of the pairwise kernels at
     the pairwise shapes (``check_pairwise_bf16``): the reference's bf16
     tolerance against the plain version, the fp32 kernel's bits on the
     widened operands, a bitwise repeat, the float64 error at most twice
     the plain version's, ``torch.cdist`` at bf16 beside;
  4. hold the batched NMFk score, the elastic NMFk plane (ks 2..8 drained
     at tol 0, with and without warm starts: scores, sweep counts and
     warm-start hits), the K-Means + Davies-Bouldin search of
     ``tests/test_integration.py`` with a small K-Means silhouette wave, and
     the LM's prefill and greedy decode (qwen2-0.5b and granite-moe-1b-a400m
     at full width cut to 2 layers; deepseek-v2 at full widths cut to 2
     layers and 16 routed experts, MLA with no flash launch; jamba-v0.1-52b
     at full widths cut to one 8-layer period and 4 experts, one flash
     launch; rwkv6-1.6b at full width cut to 2 layers, at prompts taking the
     token recurrence and the chunked WKV; reduced h2o-danube, whose window
     bites) on the card against the same
     computation on the CPU (plain versions, same draws and weights), every
     MoE route held to the CPU's on the CPU's layer input (a token may
     route differently only at a near-tie of its k-th and (k+1)-th
     probabilities, printed with its margin); LM training at the same cut
     (qwen2, granite and rwkv6; jamba cut to 2 layers, Mamba with the dense
     FFN and with MoE; B 2, L 32): the loss, the router aux loss and
     every parameter's gradient against the CPU's (each nonzero on the
     card), remat ``full`` and ``dots`` against ``none``, the routes; on
     qwen2 also 2 microbatches against 1, one AdamW step on the same
     gradients, a bitwise checkpoint round trip of (params, opt state), no
     flash launch, and the flash wrapper refusing an operand that requires
     grad;
     the K-Means search and silhouette wave again on the blobs at bf16
     (the bf16 kernels alone launched, labels and visits equal, DB at the
     same gate);
     then RESCAL and RESCALk (96 entities, 3 relations, k 2..6; RESCALk
     again at bf16: each k within twice the CPU's own bf16-vs-fp32 gap of
     the CPU's bf16 run, which replays the card's column alignments) and the
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
     sync`` (a one-rank NCCL mesh; k_optimal 8); ``nmfk_paper_bf16``: the
     same search through the API on ``nmf_data(dtype=torch.bfloat16)`` on
     the threads, batched and elastic executors: k_optimal 8 on the card
     and on the CPU (the card's draws copied), each visited k's min and
     mean silhouette within twice the CPU's own bf16-vs-fp32 gap (floor
     2e-2) of the CPU's bf16 run, elastic's sweep identity, only the bf16
     MU and silhouette kernels launched (and no bf16 kernel on the fp32
     NMFk paths), wall, device busy share and peak memory beside the fp32
     search's through the same API; with 4 or more cards also
     ``torchrun`` runs at 4 ranks (sharded ``--lanes 4``, then ``--lanes 2
     --data-shards 2`` sync and pipelined, and elastic ``--lanes 2
     --data-shards 2``; every rank the same result, k_optimal 8), else one
     line saying they were not made;
     ``rescalk_1000``: Binary Bleed over RESCALk (§IV-C's RESCAL setup of
     ``benchmarks/bench_distributed.py`` at 1000 entities, 4 relations,
     k_true 4, k 2..11) on the serial and the threads executor (k_optimal 4);
     ``kmeans_db_1m`` — Binary Bleed over K-Means with Davies-Bouldin on
     10^6 blob points (d 6, k_true 7, k 2..24) — on the scalar executor (two
     threads) and the batched one (k_optimal 7); ``rescalk_1000_bf16`` and
     ``kmeans_db_1m_bf16``: the same searches on their data at bf16 through
     the API (k_optimal 4, or the CPU's bf16 search's where bf16 chooses
     otherwise, and 7; only the bf16 silhouette or pairwise kernels
     launched; walls, busy share and peak beside fp32's), then the centroid
     sums at 10^6 points against a bf16 GEMM with PyTorch's reduced-precision
     reduction on and off (logged); then the port's ``serve``
     with qwen2-0.5b and with granite-moe-1b-a400m at their published widths
     (24 layers, random weights from seed 0), 4 prompts of 1000 tokens, 32
     new tokens: one flash launch per layer, finite logits, and decode-step
     logits (plain attention over the cache) matching a flash prefill of the
     extended sequence in every row that kept all its MoE slots (each
     prefill's dropped slots printed); ``deepseek_serve_2l``: deepseek-v2 at
     its published widths (160 routed and 2 shared experts) cut to 2 layers,
     on the card only, B 1, prompt 256, 8 tokens: no kernel launch, the
     absorbed MLA decode's logits against the expanded forward, peak memory;
     ``rwkv6_serve``: the port's ``serve`` with rwkv6-1.6b at its published
     widths (24 layers), 4 prompts of 1024 tokens (the chunked WKV), 32 new
     tokens: no kernel launch, decode logits against a prefill of the
     extended sequence; ``jamba_serve_8l``: jamba-v0.1-52b at its published
     widths cut to one 8-layer period (13.30 B parameters, 53.2 GB), on the
     card only, 4 prompts of 1024 tokens, 32 new tokens: one flash launch
     (D 128), prompt 0's decode against the full forward at a capacity
     factor where nothing drops, peak memory; ``qwen2_serve_bf16`` and
     ``jamba_serve_8l_bf16``: the same two serves (qwen2 after ``serve``,
     jamba after ``jamba_serve_8l``) with the weights at bf16, the
     reference Model's own dtype: 24 and 1 launches of the bf16 flash
     kernel and none of any other, prompt 0 teacher-forced over 3 decode
     steps on the card against the CPU's plain bf16 copy (within twice the
     bf16-vs-fp32 gap of the same weights, the fp32 side run on the card),
     walls and peak memory beside the fp32 serve's; with 4 or more cards the serve
     path on a ``(data, model)`` mesh of 4 ranks, one process a card
     (``torchrun``): ``jamba_serve_tp4``, jamba-v0.1-52b whole (32 layers,
     51.57 B parameters, 206 GB) at (1, 4) through the port's ``serve``
     (``--model-shards 4``): 4 flash launches on each rank (Hq 8, Hk 2),
     every rank the same tokens, prompt 0's decode against the full
     forward at a capacity factor where nothing drops, each rank's peak
     memory and times; then, each teacher-forced against the one-card
     run of the same weights and prompts (logits within 2e-3, the served
     tokens the one-card run's up to a printed near-tie), every rank of a
     model group the same tokens: ``jamba_serve_8l_mesh22``, the 8-layer
     cut at (2, 2); ``qwen2_serve_seq14``, qwen2-0.5b whole at (1, 4)
     (14 heads over 4: the sequence-parallel prefill, 24 flash launches
     a rank, each at its rank's query offset); ``deepseek_serve_2l_tp4``,
     deepseek-v2's 2-layer cut with 16 routed experts at (1, 4) (MLA cut
     over the model axis, 0 launches); ``rwkv6_serve_tp4``, rwkv6-1.6b
     whole at (1, 4), prompts of 1024 and 1000 (the chunked WKV and the
     token loop; 0 launches); else one line saying they were not made;
     with 4 or more cards then ``jamba_train_8l_mesh``: jamba-v0.1-52b's
     8-layer cut at its published widths (13.30 B parameters; ≈ 213 GB
     with gradients and AdamW's moments) trained through ``launch.train
     --data-shards --model-shards`` at (1, 4), (2, 2) and (4, 1) (FSDP
     over the data axis), 3 steps of B 8, L 64 in 2 microbatches, remat
     full, the three held against each other (step 0's loss at 1e-5,
     gradient norms and losses at 1e-4), every rank the same numbers, no
     kernel launch, and at (2, 2) reduced jamba and granite against a
     one-card step; ``qwen2_train_seq14`` (qwen2-0.5b at (1, 1, 4), the
     sequence-parallel residual), ``rwkv6_train_2l_mesh22`` and
     ``deepseek_train_2l_mesh22`` (each cut to 2 layers, at (1, 2, 2)),
     each held against the
     one-card run of its arch and args (step 0's loss at 1e-5, gradient
     norms and losses at 1e-4); then
     ``granite_train_pod``: granite-moe-1b-a400m at its published widths,
     the same step at (pod 2, data 2, model 1) against (pod 1, data 4,
     model 1), the same gates; each run's parameters and optimizer-state
     bytes a rank exactly its dry-run cell's (``launch.dryrun.measure`` at
     that mesh and shape, in a process of its own), its peak memory logged
     beside the dry run's; then ``granite_train_opts_mesh22``: granite at
     its published widths at (pod 1, data 2, model 2), FSDP off, 4 steps:
     ZeRO-1 moments bitwise the plain run (losses, norms, joined
     parameters) with a rank's moment bytes exactly its zero1 blocks',
     ``int8``'s step-0 gradients joined bitwise one card's
     ``compress_tree`` of the joined gradients, and ``launch.train --ckpt``
     resumed at step 2 bitwise an uninterrupted run, its checkpoint
     restored on one card bitwise the mesh run's parameters; else one
     line saying they were not made; then
     the port's ``train`` with
     qwen2-0.5b, granite-moe-1b-a400m and rwkv6-1.6b at their published
     widths (24 layers, fp32, random weights from seed 0), 12 steps of B 8,
     L 64 in 2 microbatches: finite losses and gradient norms, the last loss
     below the first, no kernel launch (training takes plain attention), the
     median step time, tokens/s and peak memory logged (``qwen2_train``,
     ``granite_train``, ``rwkv6_train``).

After phase 5, every path without bf16 in its name is checked to have
launched no bf16 kernel. The second-to-last line is ``{"kernels": [...]}``
and the last line is
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout of
the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): HBM3, fp32 on CUDA cores, dense TF32 on tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12  # dense bf16 on the tensor cores

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
# the reference's bf16 flash tolerance (tests/test_kernels.py::test_flash_attention_bf16); the kernel's
# error from float64 at most this many times the plain version's (its own bf16 output rounding)
BF16_FLASH_TOL, BF16_FP64_RATIO = dict(rtol=3e-2, atol=3e-2), 2.0
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)  # the reference's decode-vs-forward tolerance (tests/test_models.py)
# bf16 on the card against the CPU's plain bf16 run of the same weights
# (tests/test_torch_bf16.py's bound): at each of a prefill and BF16_STEPS
# teacher-forced decode steps, the logits within BF16_GAP_RATIO times the
# gap between the CPU's bf16 logits and an fp32 run of the same weights;
# greedy tokens equal wherever the CPU's top-2 margin exceeds twice that
BF16_STEPS, BF16_GAP_RATIO = 3, 2.0
# MoE routes, card against CPU on the same layer input: only the router's fp32
# matmul and softmax differ in reduction order, which moves a probability by
# up to 3.3e-7 on an H100 (granite, d 1024). A token may take
# other experts on the card only where its k-th and (k+1)-th probabilities
# are closer than this; a probability gap above half of it fails.
ROUTE_TIE_TOL = 1e-5
# deepseek-v2 card vs CPU: 16 of the 160 routed experts keep the CPU copy at
# 1.96 B parameters (7.8 GB) instead of 5.36 B
DEEPSEEK_SMALL_EXPERTS = 16
# jamba-v0.1-52b card vs CPU: one 8-layer period (m m m m a m m m, MoE on
# layers 1, 3, 5, 7) with 4 of its 16 experts (top-2 kept): 4.84 B
# parameters (19.4 GB) a side instead of 13.30 B
JAMBA_LAYERS, JAMBA_SMALL_EXPERTS = 8, 4

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
# each fp32 serve path's walls and peak memory, beside which its bf16 twin logs its own
SERVE_RECORDS: dict[str, dict] = {}


def serve_args(arch: str, prompt: int = SERVE_PROMPT) -> list[str]:
    return ["--arch", arch, "--no-reduced", "--batch", str(SERVE_BATCH), "--prompt-len", str(prompt),
            "--tokens", str(SERVE_TOKENS), "--device", "cuda", "--seed", "0", "--quiet"]


# deepseek-v2 at its published widths (160 routed + 2 shared experts) cut to
# 2 layers, on the card only: B 1, prompt 256, 8 new tokens
DEEPSEEK_LAYERS, DEEPSEEK_PROMPT, DEEPSEEK_TOKENS = 2, 256, 8
# the scan archs' serve paths, SERVE_BATCH prompts of 1024 tokens (16
# divides it: the reference's chunked branch of both scans), SERVE_TOKENS
# new tokens: rwkv6-1.6b whole, and jamba-v0.1-52b at its published widths
# cut to one 8-layer period (13.30 B parameters, 53.2 GB in fp32; the whole
# model is 51.57 B, 206 GB) on the card only, its decode held over
# JAMBA_CHECK_STEPS steps
SCAN_SERVE_PROMPT, JAMBA_CHECK_STEPS = 1024, 3

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


def bound_ms(n_bytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S,
             fp32_flops: float = 0.0) -> tuple[float, str]:
    """The larger of the bytes over HBM's rate and the operations over their
    peak: ``flops`` at ``flops_per_s`` and, where a function mixes types,
    ``fp32_flops`` beside them on the CUDA cores (the two units run at once,
    so the slower of the two bounds)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / flops_per_s, fp32_flops / FP32_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mu_bound(update: str, lanes: int, n: int, m: int, k: int, elem: int = 4) -> tuple[float, str]:
    """The least time of one MU half-sweep (``update`` "h" or "w") over
    ``lanes`` fits: V, W, H, the k x k product and the output moved once
    (``elem`` bytes an element: 2 at bf16), against its operations: at fp32
    all on the CUDA cores; at bf16 the two products (bf16 operands, fp32
    sums: a bf16 tensor-core product) at the bf16 rate and the elementwise
    epilogue at fp32's."""
    n_bytes = elem * lanes * (n * m + n * k + k * m + k * k + (k * m if update == "h" else n * k))
    products = lanes * (2 * n * m * k + (2 * k * k * m if update == "h" else 2 * n * k * k))
    epilogue = lanes * 3 * (k * m if update == "h" else n * k)
    if elem == 2:
        return bound_ms(n_bytes, products, BF16_FLOPS_PER_S, fp32_flops=epilogue)
    return bound_ms(n_bytes, products + epilogue)


def sums_bound(b: int, n: int, m: int, d: int, k: int, same: bool, elem: int = 4) -> tuple[float, str]:
    """The least time of one silhouette distance-sum call over ``b`` lanes of
    n x points against m y points (``same``: y is x, read once) in d
    dimensions and k clusters: x, y and the one-hot read once at ``elem``
    bytes an element and the fp32 sums written once, against the
    operations: at fp32 all on the CUDA cores; at bf16 x . y (bf16
    operands, fp32 sums: a bf16 tensor-core product) at the bf16 rate, and
    the norms, the square root and the contraction with the one-hot beside
    it in fp32."""
    n_bytes = b * (elem * (n * d + (0 if same else m * d) + m * k) + 4 * n * k)
    dots = b * 2 * n * m * d
    rest = b * (2 * (n + (0 if same else m)) * d + 5 * n * m + 2 * n * m * k)
    if elem == 2:
        return bound_ms(n_bytes, dots, BF16_FLOPS_PER_S, fp32_flops=rest)
    return bound_ms(n_bytes, dots + rest)


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


# the reference's bf16 tolerances (tests/test_kernels.py): MU, and pairwise's for the distance sums; each
# bf16 kernel's error from float64 at most BF16_FP64_RATIO times its plain version's
MU_BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SUMS_BF16_TOL = dict(rtol=5e-2, atol=5e-1)


def fp64_gate(torch, got, plain, want64, what: str) -> dict:
    """The kernel's float64 error against the plain version's: at most BF16_FP64_RATIO times."""
    err, plain_err = (float((t.double() - want64).abs().max()) for t in (got, plain))
    if not err <= BF16_FP64_RATIO * plain_err:
        raise AssertionError(f"{what}: float64 error {err:.3e} > {BF16_FP64_RATIO} x the plain version's "
                             f"{plain_err:.3e}")
    return {"fp64_err": err, "plain_fp64_err": plain_err}


class EntryPoints:
    """A library whose calls are recorded by name (``names``): which C entry
    point, so which kernel, a wrapper took."""

    def __init__(self, lib):
        self.lib, self.names = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def call(*args):
            self.names.append(name)
            return fn(*args)
        return call


def check_mu_bf16(torch, dev, ops, ref, records: dict, log) -> None:
    """The bf16 halves of both MU wrappers against their plain versions (bf16
    Gram, fp32 products and epilogue, one rounding) at the main path's
    shapes: the batched wave (L 32, k_pad 16), the elastic lane batch (L 8),
    the threads executor's fits (L 4, k 16) and one fit (L 1), each timed
    with its bf16 bound; then both updates (untimed) at each rank bucket of
    the tiled kernels (k 1, 17, 32, 64, 128), split units with ragged n and
    m, and past them (k 129, 200: the any-rank kernel). At the reference's
    bf16 tolerance, the float64 error at most twice the plain version's,
    masked components exactly zero, two calls bitwise equal, only the bf16
    kernel counted, and the C entry point the tiled ``mu_update_h_bf16`` /
    ``mu_update_w_bf16`` up to rank 128 (``..._any`` above), with its plan
    recorded."""
    from repro_torch.kernels import build

    cases = [
        ("bf16: k_pad=16, ks 9..16", 32, 16, [9 + i // 4 for i in range(32)], 1000, 1100, True),
        ("bf16 elastic: L=8, k=16, ks 9..16", 8, 16, [9 + i for i in range(8)], 1000, 1100, True),
        ("bf16 threads: L=4, k=16", 4, 16, [16] * 4, 1000, 1100, True),
        ("bf16 one fit: L=1, k=16", 1, 16, [16], 1000, 1100, True),
        ("bf16 KB 16: k=1", 2, 1, [1, 1], 300, 520, False),
        ("bf16 KB 32: k_pad=17, ks 17, 15", 2, 17, [17, 15], 300, 520, False),
        ("bf16 KB 32: k_pad=32, ks 32, 30", 2, 32, [32, 30], 300, 520, False),
        ("bf16 KB 64: k_pad=64, ks 64, 50", 2, 64, [64, 50], 300, 520, False),
        ("bf16 KB 128: k_pad=128, ks 128, 100", 2, 128, [128, 100], 300, 520, False),
        ("bf16 split units, ragged: L=4, n=129, m=257, k_pad=13", 4, 13, [13, 12, 11, 10], 129, 257, False),
        ("bf16 split units, boxes: L=4, n=1000, m=256, k_pad=16", 4, 16, [16, 15, 14, 13], 1000, 256, False),
        ("bf16 any rank: k_pad=129, ks 129, 120", 2, 129, [129, 120], 300, 320, False),
        ("bf16 any rank: k_pad=200, ks 200, 150", 2, 200, [200, 150], 300, 320, False),
    ]
    lib = EntryPoints(build.load("nmf_update"))
    real_load = build.load
    build.load = lambda name: lib if name == "nmf_update" else real_load(name)
    try:
        for label, lanes, k, k_effs, n, m, main in cases:
            _mu_bf16_case(torch, dev, ops, ref, records, log, lib, label, lanes, k, k_effs, n, m, main)
    finally:
        build.load = real_load


def _mu_bf16_case(torch, dev, ops, ref, records, log, lib, label, lanes, k, k_effs, n, m, main) -> None:
    v, w, h, k_eff = (t.bfloat16().contiguous() if t.is_floating_point() else t
                      for t in mu_problem(torch, dev, lanes, k, k_effs, n, m))
    dead = torch.arange(k, device=dev)[None, :] >= k_eff[:, None]
    for wrapper, plain, out_of in ((ops.mu_update_h, ref.mu_update_h, "h"),
                                   (ops.mu_update_w, ref.mu_update_w, "w")):
        name = ops.bf16_name(wrapper)
        entry = f"{wrapper.__name__}_bf16" + ("" if k <= ops.MU_TILED_MAX_RANK else "_any")
        ops.reset_launch_counts()
        lib.names.clear()
        got = wrapper(v, w, h)
        counts = ops.launch_counts()
        if counts[name] != 1 or counts[wrapper.__name__] != 0 or lib.names != [entry]:
            raise AssertionError(f"{name} [{label}]: launches {counts}, entry points {lib.names}, not [{entry}]")
        again, want = wrapper(v, w, h), plain(v, w, h)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"{name} [{label}]: output dtype {got.dtype}")
        err = compare(torch, got, want, MU_BF16_TOL["rtol"], MU_BF16_TOL["atol"], f"{name} [{label}]")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} [{label}]: two calls differ bitwise")
        masked = got[dead] if out_of == "h" else got.transpose(1, 2)[dead]
        if masked.numel() and float(masked.abs().max()) != 0.0:
            raise AssertionError(f"{name} [{label}]: masked components are not exactly zero")
        record = {"case": label, "shape": {"L": lanes, "n": n, "m": m, "k": k}, "max_abs_err": err,
                  "bitwise_equal_rerun": True, "entry_point": entry,
                  **fp64_gate(torch, got, want, plain(v.double(), w.double(), h.double()), f"{name} [{label}]")}
        if k <= ops.MU_TILED_MAX_RANK:
            plan = ops._mu_plan(out_of, lanes, n, m, k, torch.cuda.get_device_properties(dev).multi_processor_count,
                                elem=2)
            record["plan"] = {"whole": plan.whole, "split": plan.split, "chunk": plan.chunk,
                              "items": plan.items, "blocks": plan.blocks}
        if main:  # the main paths' shapes: time them
            b_ms, b_by = mu_bound(out_of, lanes, n, m, k, elem=2)
            record.update(ms=time_ms(torch, lambda: wrapper(v, w, h)),
                          plain_ms=time_ms(torch, lambda: plain(v, w, h)), bound_ms=b_ms, bound_by=b_by)
        log(json.dumps({"check": name, **record}))
        records.setdefault(name, []).append(record)


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
            b_ms, b_by = sums_bound(b, n, n, d, k, True)  # x (= y) read once, one-hot, out
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


def check_sums_bf16(torch, dev, ops, ref, records: dict, log) -> None:
    """The bf16 half of both silhouette wrappers (bf16 x, y and one-hot; fp32
    sums) on pooled near-duplicate columns at d 1000: the threads path's 52
    points (p 4, k 13), the batched wave (b 8, k_pad 16), the elastic
    plane's one lane of 64 points and RESCALk's 12 and 33 points (p 3, k 4
    and 11), all timed with their bf16 bound and a same-size ``fill_`` (the
    launch floor); a ragged d (999), the thin path's limit (128 points) and
    one point more (129: the general path), and k past 128 (b 2, k 130).
    Against the plain version at the reference's bf16 distance tolerance,
    the float64 error at most twice the plain version's, two calls bitwise
    equal, only the bf16 kernel launched, and the sums the fp32 kernel's
    on the widened operands, bit for bit, on both paths."""
    cases = [  # (label, b, p, k, k_effs, d, 2-D, timed)
        ("bf16: points=52, d=1000, k=13", 1, 4, 13, [13], 1000, True, True),
        ("bf16: b=8, points=64, d=1000, k=16", 8, 4, 16, [9, 10, 11, 12, 13, 14, 15, 16], 1000, False, True),
        ("bf16 elastic: b=1, points=64, d=1000, k=16", 1, 4, 16, [16], 1000, False, True),
        ("bf16 rescalk: points=12, d=1000, k=4", 1, 3, 4, [4], 1000, True, True),
        ("bf16 rescalk: points=33, d=1000, k=11", 1, 3, 11, [11], 1000, True, True),
        ("bf16 ragged d: b=8, points=64, d=999, k=16", 8, 4, 16, [16] * 8, 999, False, False),
        ("bf16 thin limit: b=2, points=128, d=1000, k=32", 2, 4, 32, [32, 32], 1000, False, False),
        ("bf16 general path: b=2, points=129, d=1000, k=43", 2, 3, 43, [43, 43], 1000, False, False),
        ("bf16 k past 128: b=2, points=260, d=1000, k=130", 2, 2, 130, [130, 100], 1000, False, False),
    ]
    for label, b, p, k, k_effs, d, two_d, timed in cases:
        x, onehot = (t.bfloat16().contiguous() for t in pooled_columns(torch, dev, b, p, k, k_effs, d))
        wrapper, args = ops.silhouette_dist_sums_batched, (x, onehot)
        if two_d:
            wrapper, args = ops.silhouette_dist_sums, (x[0], onehot[0])
        name = ops.bf16_name(wrapper)
        ops.reset_launch_counts()
        got = wrapper(*args)
        counts = ops.launch_counts()
        if counts[name] != 1 or counts[wrapper.__name__] != 0:
            raise AssertionError(f"{name} [{label}]: launches {counts}")
        again, want = wrapper(*args), ref.silhouette_dist_sums(*args)
        torch.cuda.synchronize()
        if got.dtype != torch.float32:
            raise AssertionError(f"{name} [{label}]: output dtype {got.dtype}")
        err = compare(torch, got, want, SUMS_BF16_TOL["rtol"], SUMS_BF16_TOL["atol"], f"{name} [{label}]")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} [{label}]: two calls differ bitwise")
        if not torch.equal(got, wrapper(*(a.float() for a in args))):
            raise AssertionError(f"{name} [{label}]: not the fp32 kernel's bits on the widened operands")
        entry = {"case": label, "path": "thin" if x.shape[1] <= ops.SILHOUETTE_THIN_POINTS else "general",
                 "max_abs_err": err, "bitwise_equal_rerun": True, "fp32_kernel_bits_on_widened": True,
                 **fp64_gate(torch, got, want, ref.silhouette_dist_sums(*(a.double() for a in args)),
                             f"{name} [{label}]")}
        if timed:
            b_ms, b_by = sums_bound(b, x.shape[1], x.shape[1], d, k, True, elem=2)  # bf16 in, fp32 out
            out = torch.empty_like(got)
            entry.update(ms=time_ms(torch, lambda: wrapper(*args)),
                         plain_ms=time_ms(torch, lambda: ref.silhouette_dist_sums(*args)), bound_ms=b_ms, bound_by=b_by,
                         fill_ms=time_ms(torch, lambda: out.fill_(1.0)))  # the launch floor
            entry.update(fill_multiple=entry["ms"] / entry["fill_ms"])
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


def check_pairwise_bf16(torch, dev, ops, ref, records: dict, log) -> None:
    """The bf16 half of both pairwise wrappers (bf16 x and y; fp32 D^2) at
    ``check_pairwise``'s shapes, on ``KM_DATA`` at bf16: 1 and 16 lanes with
    x shared at m 24, 2-D at m 24, 2, 7 and 13, the general path, a ragged
    case. Against the plain version at the reference's bf16 tolerance;
    bitwise the fp32 kernel's output on the widened operands (widening is
    exact and the adds are the fp32 kernel's); two calls bitwise equal; the
    float64 error at most twice the plain version's; only the bf16 kernel
    launched. The timed cases report their bf16 bound and ``torch.cdist``
    at bf16 where it runs."""
    from repro_torch.factorization.synthetic import blob_data

    bf16 = torch.bfloat16
    x, _ = blob_data(**KM_DATA, device=dev, dtype=bf16)
    n, d = x.shape
    b, m = KM_WAVE, KM_K_PAD
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    pick = torch.randint(0, n, (b, m), device=dev, generator=gen)
    y = (x[pick] + 0.1 * torch.randn((b, m, d), device=dev, generator=gen, dtype=bf16)).contiguous()
    rng_x = torch.randn((3, 70, 17), device=dev, generator=gen).to(bf16)
    rng_y = torch.randn((3, 30, 17), device=dev, generator=gen).to(bf16)
    m_gen = 4 * ops.PAIRWISE_THIN_COLS // 3
    pick_gen = torch.randint(0, n, (2, m_gen), device=dev, generator=gen)
    y_gen = (x[pick_gen] + 0.1 * torch.randn((2, m_gen, d), device=dev, generator=gen, dtype=bf16)).contiguous()
    x_gen = x[: n // 10]
    batched, two_d = ops.pairwise_sq_dists_batched, ops.pairwise_sq_dists
    cases = [  # the order of check_pairwise: the kernels line reports each wrapper's first timed case
        (batched, (x, y[:1]), f"bf16: b=1 lane, x shared (n={n}, d={d}), m={m}", True),
        (batched, (x, y), f"bf16: b={b} lanes, x shared (n={n}, d={d}), m={m}", True),
        (two_d, (x, y[0]), f"bf16: n={n}, m={m}, d={d}", True),
        *[(two_d, (x, y[0, :k].contiguous()), f"bf16: n={n}, m={k}, d={d}", True) for k in (2, 7, 13)],
        (batched, (x_gen, y_gen), f"bf16 general path: b=2 lanes, x shared (n={x_gen.shape[0]}, d={d}), "
                                  f"m={m_gen}", False),
        (batched, (rng_x, rng_y), "bf16 ragged b=3, n=70, m=30, d=17", False),
    ]
    for wrapper, (xx, yy), label, timed in cases:
        name = ops.bf16_name(wrapper)
        ops.reset_launch_counts()
        got = wrapper(xx, yy)
        counts = ops.launch_counts()
        if counts[name] != 1 or counts[wrapper.__name__] != 0:
            raise AssertionError(f"{name} [{label}]: launches {counts}")
        again, widened = wrapper(xx, yy), wrapper(xx.float(), yy.float())
        want = ref.pairwise_sq_dists(xx, yy)
        torch.cuda.synchronize()
        if got.dtype != torch.float32:
            raise AssertionError(f"{name} [{label}]: output dtype {got.dtype}")
        err = compare(torch, got, want, SUMS_BF16_TOL["rtol"], SUMS_BF16_TOL["atol"], f"{name} [{label}]")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} [{label}]: two calls differ bitwise")
        if not torch.equal(got, widened):
            raise AssertionError(f"{name} [{label}]: not the fp32 kernel's bits on the widened operands")
        entry = {"case": label, "max_abs_err": err, "bitwise_equal_rerun": True, "bitwise_fp32_widened": True,
                 **fp64_gate(torch, got, want, ref.pairwise_sq_dists(xx.double(), yy.double()), f"{name} [{label}]")}
        del got, again, widened, want
        if timed:
            lanes = yy.shape[0] if yy.dim() == 3 else 1
            n_x, n_y = xx.shape[-2], yy.shape[-2]
            n_bytes = 2 * (xx.numel() + yy.numel()) + 4 * lanes * n_x * n_y  # bf16 in, fp32 D^2 out
            # x . y of bf16 operands with fp32 sums at the bf16 rate; norms and epilogue in fp32
            b_ms, b_by = bound_ms(n_bytes, lanes * 2 * n_x * n_y * d, BF16_FLOPS_PER_S,
                                  fp32_flops=lanes * 3 * n_x * n_y + 2 * xx.numel() + 2 * yy.numel())
            entry.update(ms=time_ms(torch, lambda: wrapper(xx, yy)),
                         plain_ms=time_ms(torch, lambda: ref.pairwise_sq_dists(xx, yy)), bound_ms=b_ms, bound_by=b_by)
            x_lib = xx.expand(lanes, n_x, d) if yy.dim() == 3 else xx
            try:
                entry["library_ms"] = time_ms(
                    torch, lambda: torch.cdist(x_lib, yy, compute_mode="use_mm_for_euclid_dist"))
                entry["library"] = "torch.cdist(use_mm_for_euclid_dist) at bf16: the square root of D^2, one call"
            except RuntimeError as exc:  # a refusal of the dtype: no PyTorch call computes it
                entry.update(library_ms=None, library=f"none: torch.cdist at bf16 raised {str(exc).splitlines()[0]!r}")
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


def check_kmeans_small(torch, dev, ops, log, dtype=None) -> None:
    """tests/test_integration.py's K-Means + Davies-Bouldin search (serial,
    so the visit order is fixed) on the card (kernels) and on the CPU (plain
    versions) with the same draws; then a small K-Means silhouette wave.
    ``dtype`` bf16 runs both on the blobs at bf16: the bf16 kernels alone
    launched (fp32 distances of bf16 centroids, as on the reference's
    kernel route), the same labels, visits and DB gate."""
    from repro_torch.core import binary_bleed_search, davies_bouldin_score
    from repro_torch.factorization.kmeans import kmeans
    from repro_torch.factorization.planes import KMeansBatchPlane
    from repro_torch.factorization.synthetic import blob_data
    from repro_torch.random import KMeansDraws, seeded_kmeans_draws

    dtype = dtype or torch.float32
    tag = " bf16" if dtype == torch.bfloat16 else ""

    def kernel(wrapper) -> str:  # launch_counts' name of the kernel this dtype takes
        return ops.bf16_name(wrapper) if tag else wrapper.__name__

    def other(wrapper) -> str:
        return wrapper.__name__ if tag else ops.bf16_name(wrapper)

    x, _ = blob_data(n=240, d=5, k_true=5, std=0.3, spread=10.0, seed=3, device=dev, dtype=dtype)
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
        raise AssertionError(f"K-Means{tag} search: k_optimal card {card.k_optimal}, cpu {cpu.k_optimal}, want 5")
    if card.visited_ks != cpu.visited_ks:
        raise AssertionError(f"K-Means{tag} search visited {sorted(card.visited_ks)} on the card, "
                             f"{sorted(cpu.visited_ks)} on the CPU")
    card_db = {v.k: v.score for v in card.visits}
    cpu_db = {v.k: v.score for v in cpu.visits}
    for k in card_db:
        if not torch.equal(card_labels[k], cpu_labels[k]):
            raise AssertionError(f"K-Means{tag} k={k}: card and CPU labels differ at "
                                 f"{int((card_labels[k] != cpu_labels[k]).sum())} points")
        if abs(card_db[k] - cpu_db[k]) > KM_DB_RTOL * abs(cpu_db[k]):
            raise AssertionError(f"K-Means{tag} k={k}: DB card {card_db[k]} vs CPU {cpu_db[k]}")
    if launches[kernel(ops.pairwise_sq_dists)] < 1 or launches[other(ops.pairwise_sq_dists)]:
        raise AssertionError(f"the card's K-Means{tag} search launched {launches}")
    # k past one block of k-means++ draws (128): same draws, same labels
    fits = {where: kmeans(xx, 129, draws(129, 129), max_iters=25)
            for where, xx, draws in (("card", x, card_draws), ("cpu", x.cpu(), cpu_draws))}
    if not torch.equal(fits["card"].labels.cpu(), fits["cpu"].labels):
        raise AssertionError(f"K-Means{tag} k=129: card and CPU labels differ")
    if tuple(fits["card"].centroids.shape) != (129, x.shape[1]) or fits["card"].centroids.dtype != dtype:
        raise AssertionError(f"K-Means{tag} k=129: centroids {tuple(fits['card'].centroids.shape)} "
                             f"{fits['card'].centroids.dtype}")
    gap = max(abs(card_db[k] - cpu_db[k]) for k in card_db)
    log(json.dumps({"check": f"kmeans + davies_bouldin search{tag} card vs plain", "k_optimal": card.k_optimal,
                    "visited": sorted(card.visited_ks), "db_card": card_db, "db_max_abs_gap": gap,
                    "launches": launches, "k129_labels_equal": True, "k129_iters": int(fits["card"].iters)}))

    ks = [2, 3, 4, 5]
    ops.reset_launch_counts()
    on_card = KMeansBatchPlane(x, score="silhouette", max_iters=25, k_pad=8, draws=card_draws).evaluate_batch(ks)
    counts = ops.launch_counts()
    sil_launches = counts[kernel(ops.silhouette_dist_sums_batched)]
    on_cpu = KMeansBatchPlane(x.cpu(), score="silhouette", max_iters=25, k_pad=8,
                              draws=cpu_draws).evaluate_batch(ks)
    gap = max(abs(a - c) for a, c in zip(on_card, on_cpu))
    if not gap <= KM_SIL_ATOL or sil_launches < 1 or counts[other(ops.silhouette_dist_sums_batched)]:
        raise AssertionError(f"K-Means{tag} silhouette wave: card vs plain gap {gap:.3e}, launches {counts}")
    log(json.dumps({"check": f"kmeans silhouette wave{tag} card vs plain", "ks": ks, "card": on_card,
                    "max_abs_gap": gap, "silhouette_dist_sums_batched_launches": sil_launches}))


def kmeans_api_search(x, executor: str):
    """kmeans_db_1m's search on x (at its dtype) on one executor: the
    batched plane (k_pad 24), or per-k fits on two threads."""
    from repro_torch.core import binary_bleed_search, davies_bouldin_score
    from repro_torch.factorization.kmeans import kmeans
    from repro_torch.factorization.planes import KMeansBatchPlane

    if executor == "batched":
        evaluate = KMeansBatchPlane(x, seed=0, score="davies_bouldin", max_iters=KM_MAX_ITERS, k_pad=KM_K_PAD)
        return binary_bleed_search(evaluate, **KM_SEARCH, executor="batched"), evaluate

    def evaluate(k, should_abort=None):
        res = kmeans(x, int(k), seed=0, max_iters=KM_MAX_ITERS)
        return float(davies_bouldin_score(x, res.labels, int(k)))
    return binary_bleed_search(evaluate, **KM_SEARCH, num_resources=2), None


def run_kmeans_search(torch, dev, ops, executor: str, log) -> dict[str, int]:
    """kmeans_db_1m on one executor; counts reset just before, read just after."""
    from repro_torch.factorization.synthetic import blob_data

    x, planted = blob_data(**KM_DATA, device=dev)
    centers = torch.stack([x[planted == c].mean(dim=0) for c in range(KM_DATA["k_true"])])
    gaps = (centers[:, None] - centers[None]).norm(dim=-1).fill_diagonal_(math.inf)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = sync_wall(torch)
    res, plane = kmeans_api_search(x, executor)
    wall = sync_wall(torch) - t0
    counts = ops.launch_counts()
    KM_RECORDS[executor] = {"wall_s": wall, "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(json.dumps({"search": f"kmeans_db_1m {executor}", "k_optimal": res.k_optimal,
                    "planted_min_center_gap": float(gaps.min()),
                    "visited": {v.k: v.score for v in sorted(res.visits, key=lambda v: v.k)},
                    "waves": getattr(plane, "n_dispatches", None), **KM_RECORDS[executor], "launches": counts}))
    if res.k_optimal != KM_DATA["k_true"]:
        raise AssertionError(f"kmeans_db_1m {executor}: k_optimal {res.k_optimal} != {KM_DATA['k_true']}")
    name = "pairwise_sq_dists_batched" if executor == "batched" else "pairwise_sq_dists"
    if counts[name] < 1:
        raise AssertionError(f"kmeans_db_1m {executor}: kernel {name} was never launched on the main path")
    return counts


# kmeans_db_1m's wall and peak by executor, beside which kmeans_db_1m_bf16 logs its own
KM_RECORDS: dict[str, dict] = {}


def run_kmeans_bf16(torch, dev, ops, log) -> dict[str, dict[str, int]]:
    """``kmeans_db_1m_bf16``: kmeans_db_1m's search on ``KM_DATA`` at bf16
    through the API, on threads and batched: k_optimal 7; the main path's
    launches (counts reset just before, read just after) the bf16 pairwise
    kernel's alone; wall, device busy share and peak beside kmeans_db_1m's,
    with the card's name and power limit. Then the centroid sums at 10^6
    points (k 7): the port's (float32 operands, one rounding to bf16)
    against a bf16 GEMM of the same one-hot and x with PyTorch's
    ``allow_bf16_reduced_precision_reduction`` on and off, and against the
    CPU's; logged, not gated."""
    from repro_torch.core.scoring import _cluster_sums, _one_hot
    from repro_torch.factorization.kmeans import kmeans
    from repro_torch.factorization.synthetic import blob_data

    x, _ = blob_data(**KM_DATA, device=dev, dtype=torch.bfloat16)
    out, smi = {}, smi_line()
    for executor in ("threads", "batched"):
        label = f"kmeans_db_1m_bf16_{executor}"
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = sync_wall(torch)
        res, plane = kmeans_api_search(x, executor)
        wall = sync_wall(torch) - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        busy = busy_share(torch, lambda: kmeans_api_search(x, executor))[0]
        wrapper = ops.pairwise_sq_dists_batched if executor == "batched" else ops.pairwise_sq_dists
        stray = {name: c for name, c in counts.items() if not name.endswith("[bf16]") and c}
        log(json.dumps({"search": label, "k_optimal": res.k_optimal,
                        "visited": {v.k: v.score for v in sorted(res.visits, key=lambda v: v.k)},
                        "waves": getattr(plane, "n_dispatches", None), "wall_s": wall, "busy_share": busy,
                        "max_memory_allocated": peak, "fp32": KM_RECORDS.get(executor), "launches": counts,
                        "card": smi}))
        if res.k_optimal != KM_DATA["k_true"]:
            raise AssertionError(f"{label}: k_optimal {res.k_optimal} != {KM_DATA['k_true']}")
        if counts[ops.bf16_name(wrapper)] < 1 or stray:
            raise AssertionError(f"{label}: the main path's launches {counts}")
        out[label] = counts

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    shapes = (  # one fit's labels at k 7, and a full batched wave's shape (16 lanes of 24 slots)
        ("k7", kmeans(x, KM_DATA["k_true"], seed=0, max_iters=KM_MAX_ITERS).labels, KM_DATA["k_true"]),
        ("wave16_k24", torch.randint(0, KM_K_PAD, (KM_WAVE, x.shape[0]), device=dev, generator=gen), KM_K_PAD))
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    for shape, labels, k in shapes:
        onehot = _one_hot(labels, k, torch.float32)
        port, gemm = _cluster_sums(onehot, x), {}
        try:
            for reduced in (True, False):
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
                got = torch.matmul(onehot.bfloat16().transpose(-1, -2), x)
                gemm[f"bf16_gemm_reduced_{str(reduced).lower()}"] = {
                    "elements_differing": int((got != port).sum()),
                    "max_abs_diff": float((got.float() - port.float()).abs().max())}
        finally:
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved
        gemm["cpu_elements_differing"] = int((_cluster_sums(onehot.cpu(), x.cpu()) != port.cpu()).sum())
        log(json.dumps({"check": "kmeans bf16 centroid sums at 10^6 points, the port's against a bf16 GEMM",
                        "shape": shape, "elements": port.numel(), **gemm}))
    return out


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
    no_bf16_launch(counts, label)
    return counts


def no_bf16_launch(counts: dict[str, int], label: str) -> None:
    """A float32 path launches no bf16 kernel."""
    stray = {name: c for name, c in counts.items() if name.endswith("[bf16]") and c}
    if stray:
        raise AssertionError(f"{label}: a float32 path launched bf16 kernels {stray}")


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
    no_bf16_launch(counts, label)
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


def check_rescal_small_bf16(torch, dev, ops, log) -> None:
    """``check_rescal_small``'s X and draws at bf16 (the fit at bf16, the
    silhouette through the bf16 silhouette kernel): ``rescalk_score`` at k
    2..6 on the card against the CPU's bf16 run and, for the gap, the CPU's
    float32 run of the same values. The greedy column alignment takes the
    largest bf16 similarity, so the CPU's bf16 run takes the card's
    alignments and every flip's first split must be a near-tie
    (``AlignLog``). Each k's silhouette within twice the CPU's own
    bf16-vs-fp32 gap (floor ``BF16_SIL_FLOOR``), its error likewise or
    within two bf16 ulps; only the bf16 silhouette kernel launched."""
    import importlib

    from repro_torch.factorization.synthetic import rescal_data
    from repro_torch.random import RESCALDraws, seeded_rescal_draws

    rescal_mod = importlib.import_module("repro_torch.factorization.rescal")
    n, nr, p, bf16 = 96, 3, 3, torch.bfloat16
    x, _, _ = rescal_data(n_entities=n, n_relations=nr, k_true=4, noise=0.01, seed=0, device="cpu", dtype=bf16)
    source = seeded_rescal_draws(0, n, nr, p, RESCAL_EPS, "cpu", bf16)
    ks = range(2, 7)
    align = AlignLog()
    undo = align.patch(torch, rescal_mod, "record")
    ops.reset_launch_counts()
    try:
        card = {k: rescal_mod.rescalk_score(x.to(dev), k, RESCALDraws(*(t.to(dev) for t in source(k))), iters=150)
                for k in ks}
    finally:
        undo()
    launches = ops.launch_counts()
    undo = align.patch(torch, rescal_mod, "replay")
    try:
        cpu16 = {k: rescal_mod.rescalk_score(x, k, source(k), iters=150) for k in ks}
    finally:
        undo()
    cpu32 = {k: rescal_mod.rescalk_score(x.float(), k, RESCALDraws(*(t.float() for t in source(k))), iters=150)
             for k in ks}
    per_k, failed = {}, []
    for k in ks:
        (sil, err), (sil16, err16), (sil32, err32) = ((float(a), float(b)) for a, b in (card[k], cpu16[k], cpu32[k]))
        sil_bound = max(BF16_GAP_RATIO * abs(sil16 - sil32), BF16_SIL_FLOOR)
        err_bound = max(BF16_GAP_RATIO * abs(err16 - err32), 2 * bf16_ulp(err16))
        if not abs(sil - sil16) <= sil_bound:
            failed.append(f"k {k} silhouette: card {sil:.5f} vs CPU bf16 {sil16:.5f} > {sil_bound:.3e}")
        if not abs(err - err16) <= err_bound:
            failed.append(f"k {k} rel_error: card {err:.5f} vs CPU bf16 {err16:.5f} > {err_bound:.3e}")
        per_k[k] = {"silhouette": [sil, sil16, sil32, sil_bound], "rel_error": [err, err16, err32, err_bound]}
    failed += [f"k {f['k']}: the CPU's own alignment left the card's at a margin of {f['margin_ulps']:.2f} bf16 "
               f"ulps, beyond {AlignLog.ALIGN_TIE_ULPS}" for f in align.flips if not f["near_tie"]]
    if launches["silhouette_dist_sums[bf16]"] < len(ks) or launches["silhouette_dist_sums"]:
        failed.append(f"launches {launches}")
    if any(card[k][0].dtype != torch.float32 or card[k][1].dtype != bf16 for k in ks):
        failed.append("the card's silhouettes are not float32 or its errors not bf16")
    log(json.dumps({"check": "rescalk_score bf16 card vs CPU", "entities": n, "relations": nr,
                    "per_k_card_cpu16_cpu32_bound": per_k, "align_flips_cpu_bf16": align.flips,
                    "launches": launches}))
    if failed:
        raise AssertionError("rescalk_score bf16: " + "; ".join(failed))


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
    """rescalk_1000 and rescalk_1000_bf16 (the same X at bf16) on the serial
    and the threads executor: launch counts by path."""
    from repro_torch.factorization.synthetic import rescal_data

    out = {}
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        x = rescal_data(**RESCAL_DATA, device="cpu", dtype=dtype)[0].to(dev)
        out.update({f"rescalk_1000{tag}_{ex}": run_rescalk_search(torch, ops, x, ex, log) for ex in ("serial", "threads")})
    return out


def run_rescalk_search(torch, ops, x, executor: str, log) -> dict[str, int]:
    """rescalk_1000 on one executor at x's dtype; counts reset just before,
    read just after. At bf16 the main path launches the bf16 silhouette
    kernel alone; k_optimal 4 is its gate, and where bf16 chooses otherwise,
    the CPU's bf16 search of the same X and draws is (logged as such)."""
    from repro_torch.core import binary_bleed_search
    from repro_torch.factorization.rescal import make_rescalk_evaluator
    from repro_torch.random import RESCALDraws, seeded_rescal_draws

    bf16 = x.dtype == torch.bfloat16
    label = f"rescalk_1000{'_bf16' if bf16 else ''} {executor}"
    nr, n, _ = x.shape
    source = seeded_rescal_draws(0, n, nr, RESCAL_P, RESCAL_EPS, x.device, x.dtype)  # the evaluator's default
    kw = dict(n_perturbs=RESCAL_P, iters=RESCAL_ITERS, epsilon=RESCAL_EPS)
    resources = 1 if executor == "serial" else RESCAL_THREADS
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = sync_wall(torch)
    res = binary_bleed_search(make_rescalk_evaluator(x, seed=0, **kw), **RESCAL_SEARCH, num_resources=resources)
    wall = sync_wall(torch) - t0
    counts = ops.launch_counts()
    entry = {"search": label, "k_optimal": res.k_optimal, "resources": resources,
             "visited": {v.k: v.score for v in sorted(res.visits, key=lambda v: v.k)}, "wall_s": wall,
             "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": counts}
    want, gate = RESCAL_DATA["k_true"], "k_true"
    if bf16 and res.k_optimal != want:
        cpu = binary_bleed_search(make_rescalk_evaluator(
            x.cpu(), **kw, draws=lambda k: RESCALDraws(*(t.cpu() for t in source(k)))), **RESCAL_SEARCH)
        want, gate = cpu.k_optimal, "the CPU's bf16 search"
        entry["cpu_visited"] = {v.k: v.score for v in sorted(cpu.visits, key=lambda v: v.k)}
    log(json.dumps({**entry, "gate": gate}))
    if res.k_optimal != want:
        raise AssertionError(f"{label}: k_optimal {res.k_optimal} != {want} ({gate})")
    sil = ops.bf16_name(ops.silhouette_dist_sums) if bf16 else "silhouette_dist_sums"
    stray = {name: c for name, c in counts.items() if name.endswith("[bf16]") != bf16 and c}
    if counts[sil] < 1 or stray:
        raise AssertionError(f"{label}: the main path's launches {counts}")
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
    no_bf16_launch(counts, "nmfk_distributed_fit")
    return counts


# nmfk_paper_bf16: nmfk_paper's search (V 1000 x 1100, k_true 8, k 2..16, 4
# perturbations, 120 sweeps, threshold 0.9, the launcher's executor
# settings) through the API on nmf_data(dtype=torch.bfloat16), no flag (the
# reference's launcher has no dtype either). Each visited k's min and mean
# silhouette on the card within BF16_GAP_RATIO times the CPU port's own
# bf16-vs-fp32 gap at that k, at least BF16_SIL_FLOOR, of the CPU's bf16
# run of the same draws: 120 sweeps compound a one-ulp bf16 flip, so the
# fp32 tolerances do not apply.
NMFK_PAPER = dict(n=1000, m=1100, k_true=8, k_range=(2, 16), n_perturbs=4, nmf_iters=120, epsilon=0.015,
                  threshold=0.9, workers=4)
BF16_SIL_FLOOR = 2e-2
NMFK_BF16_EXECUTORS = ("threads", "batched", "elastic")


def nmfk_api_search(v, executor: str, draws=None, gate=None):
    """nmfk_paper's search on V through the API, with the launcher's settings
    (4 workers; k_pad 16; elastic: tol 1e-3, chunks of 25, warm starts), at
    V's dtype; returns (result, plane or None). ``gate`` (elastic) wraps the
    plane's tol gate (``RetireLog``)."""
    from repro_torch.core import binary_bleed_search
    from repro_torch.factorization.nmfk import make_nmfk_evaluator
    from repro_torch.factorization.planes import NMFkBatchPlane, NMFkElasticPlane

    c = NMFK_PAPER
    kw = dict(n_perturbs=c["n_perturbs"], nmf_iters=c["nmf_iters"], epsilon=c["epsilon"], draws=draws)
    search = dict(k_range=c["k_range"], select_threshold=c["threshold"])
    if executor == "threads":
        return binary_bleed_search(make_nmfk_evaluator(v, 0, **kw), num_resources=c["workers"], **search), None
    k_pad = c["k_range"][1]
    plane = (NMFkBatchPlane if executor == "batched" else NMFkElasticPlane)(v, 0, k_pad=k_pad, **kw)
    if gate is not None:
        plane._converged = gate(plane._converged)
    return binary_bleed_search(plane, executor=executor, **search), plane


def keep_scores(nmfk, scores: dict):
    """Wrap ``nmfk.nmfk_score`` (the threads executor's scorer) and
    ``nmfk._pooled_w_score`` (the batched and elastic planes') so that each
    scored k's whole NMFkScore lands in ``scores``; returns the undo. A
    padded wave repeats its first k: a k's first lane is kept."""
    saved = nmfk.nmfk_score, nmfk._pooled_w_score

    def one(v, k, draws, nmf_iters=150):
        scores[int(k)] = sc = saved[0](v, k, draws, nmf_iters)
        return sc

    def pooled(w_all, errs, k_eff, k_pad):
        sc, lanes = saved[1](w_all, errs, k_eff, k_pad), {}
        for i, k in enumerate(k_eff.tolist()):
            lanes.setdefault(k, type(sc)(*(field[i] for field in sc)))
        scores.update(lanes)
        return sc

    nmfk.nmfk_score, nmfk._pooled_w_score = one, pooled

    def undo():
        nmfk.nmfk_score, nmfk._pooled_w_score = saved
    return undo


def scored_search(v, executor: str, draws=None, gate=None) -> tuple:
    """``nmfk_api_search`` with every scored k's NMFkScore kept; returns
    (result, {k: NMFkScore}, plane or None)."""
    from repro_torch.factorization import nmfk

    scores = {}
    undo = keep_scores(nmfk, scores)
    try:
        res, plane = nmfk_api_search(v, executor, draws, gate)
    finally:
        undo()
    return res, scores, plane


class AlignLog:
    """NMFk's greedy column alignment (``nmfk._align_columns`` and
    ``_align_columns_masked``), recorded on the card and replayed on the
    CPU, per k. The greedy takes the largest cosine similarity of bf16
    columns, rounded to bf16 (the reference's arithmetic): where two
    pairings are within an ulp of each other, the card's and the CPU's
    products pick differently, later picks follow the first, and the
    silhouette of an overfit k moves by up to 0.2. So the CPU runs take the
    card's labels, as the bf16 LM checks take the card's MoE routes, and
    where the CPU's own labels differ, the CPU's greedy must have left the
    card's assignment at a near-tie: at its first pick outside it (the
    split), the CPU's similarity of that pick exceeds the best pairing of
    the card's still open by at most ``ALIGN_TIE_ULPS`` bf16 ulps. The
    picks after the split choose among other open rows and columns on the
    two devices, so their margins (the cascade, logged, not gated) measure
    the split's consequences, not a tie."""

    ALIGN_TIE_ULPS = 4

    def __init__(self):
        self.labels: dict[int, object] = {}
        self.flips: list[dict] = []

    def patch(self, torch, module, mode: str):
        """Wrap the alignments ``module`` holds (``nmfk``: both; ``rescal``:
        ``_align_columns``) for ``mode`` record or replay; returns the undo."""
        names = [name for name in ("_align_columns", "_align_columns_masked") if hasattr(module, name)]
        saved = {name: getattr(module, name) for name in names}
        for name in names:
            setattr(module, name, self._wrap(torch, saved[name], mode, masked=name.endswith("_masked")))

        def undo():
            for name, fn in saved.items():
                setattr(module, name, fn)
        return undo

    @staticmethod
    def split_margin(sim, card: list[int]) -> tuple[float, float] | None:
        """Run the greedy on one (k, k) similarity matrix (a list of rows).
        A pick (i, j) with card[j] != i has the margin sim[i][j] minus the
        best card pairing still open, in bf16 ulps at sim[i][j]. Returns
        (the first such margin, the largest |margin| of the picks after it,
        0 if none); None where the greedy gives the card's assignment."""
        k = len(card)
        rows, cols = set(range(k)), set(range(k))
        split, cascade = None, 0.0
        for _ in range(k):
            open_pairs = [(r, c) for r in sorted(rows) for c in sorted(cols)]
            i, j = max(open_pairs, key=lambda rc: (sim[rc[0]][rc[1]], -rc[0] * k - rc[1]))  # ties: first flat index
            best = [sim[card[c]][c] for c in cols if card[c] in rows]
            if card[j] != i and best:  # at the split every card pairing is still open
                ulps = (sim[i][j] - max(best)) / bf16_ulp(sim[i][j])
                split, cascade = (ulps, cascade) if split is None else (split, max(cascade, abs(ulps)))
            rows.discard(i)
            cols.discard(j)
        return None if split is None else (split, cascade)

    def _wrap(self, torch, align, mode: str, masked: bool):
        def wrapped(w_all, k_eff=None):
            own = align(w_all, k_eff) if masked else align(w_all)
            lanes = w_all if masked else w_all[None]  # (B, p, n, k_pad)
            ks = k_eff.tolist() if masked else [w_all.shape[-1]]
            rows = own if masked else own[None]  # (B, p * k_pad)
            if mode == "record":
                self.labels.update((k, row.cpu()) for k, row in zip(ks, rows))
                return own
            # a k the card never aligned (the threads executor's visits race) keeps the CPU's labels
            card = torch.stack([self.labels.get(k, row.cpu()) for k, row in zip(ks, rows)]).to(rows.device)
            if not torch.equal(card, rows):
                p, k_pad = lanes.shape[1], lanes.shape[-1]
                sim = (lanes[:, :1].transpose(-1, -2) @ lanes).float()  # (B, p, k_ref, k_cols): the greedy's input
                for i, k in enumerate(ks):
                    if torch.equal(card[i], rows[i]):
                        continue
                    splits = [self.split_margin(sim[i, q, :k, :k].tolist(), card[i].view(p, k_pad)[q, :k].tolist())
                              for q in range(p)]
                    splits = [sp for sp in splits if sp is not None] or [(0.0, 0.0)]
                    ulps = max(sp[0] for sp in splits)
                    self.flips.append({"k": k, "labels_differ": int((card[i] != rows[i]).sum()), "margin_ulps": ulps,
                                       "cascade_ulps": max(sp[1] for sp in splits),
                                       "near_tie": ulps <= self.ALIGN_TIE_ULPS})
            return card if masked else card[0]
        return wrapped


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0**-133


class RetireLog:
    """The elastic plane's tol gate, recorded on the card and replayed on the
    CPU. A lane retires when its bf16 rel_error improved by less than tol
    over a chunk; a one-ulp difference of that error between the card and
    the CPU can flip the decision, and a flipped retirement changes the
    sweeps, the warm-start sources and the scores of the ks after it. So the
    CPU runs take the card's decisions (``replay``), as the bf16 LM checks
    take the card's MoE routes, and a decision the CPU would have taken
    otherwise is allowed only at a near-tie: the CPU's margin |prev - err -
    tol| within ``RETIRE_TIE_ULPS`` bf16 ulps of err."""

    RETIRE_TIE_ULPS = 4

    def __init__(self, tol: float):
        self.tol = tol
        self.decisions: dict[tuple[int, int, int], bool] = {}
        self.flips: list[dict] = []

    def record(self, converged):
        def gate(lane, err):
            self.decisions[(lane.k, lane.p, lane.done)] = decided = converged(lane, err)
            return decided
        return gate

    def replay(self, converged):
        def gate(lane, err):
            own, key = converged(lane, err), (lane.k, lane.p, lane.done)
            if key not in self.decisions:  # a lane the card's run never reached keeps the CPU's decision
                return own
            if own != self.decisions[key]:
                margin = lane.prev_err - err - self.tol
                self.flips.append({"lane": key, "cpu_margin": margin, "ulp": bf16_ulp(err),
                                   "near_tie": abs(margin) <= self.RETIRE_TIE_ULPS * bf16_ulp(err)})
            return self.decisions[key]
        return gate


def busy_share(torch, fn) -> tuple[float, float]:
    """(device busy share, wall s) of fn() under torch.profiler: the device
    events' own time (kernels, copies, fills) over the host-clock wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU:
            busy_us += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
    return busy_us / 1e6 / wall, wall


def cpu_nmfk_bf16(torch, executor: str, visited: list[int], v_cpu: dict, cpu_draws, retire, align) -> tuple:
    """The CPU side of ``nmfk_paper_bf16`` on ``executor``: the bf16 search
    on the card's draws with the card's column alignments (``align``), and
    {k: NMFkScore} at bf16 and at float32 (V and the draws widened; its own
    alignments, so the gap is the dtype's) for every k the card
    ``visited``; elastic takes the card's retirements (``retire``) at both
    dtypes. Returns (the bf16 result, the bf16 scores, the float32 scores,
    the retirement flips at bf16)."""
    from repro_torch.factorization import nmfk

    c = NMFK_PAPER
    bf16, fp32 = torch.bfloat16, torch.float32
    kw = dict(k_pad=c["k_range"][1], n_perturbs=c["n_perturbs"], nmf_iters=c["nmf_iters"])

    def lanes(dt, ks):
        sc = nmfk.nmfk_score_batched(v_cpu[dt], ks, draws=cpu_draws(dt), **kw)
        return {k: type(sc)(*(f[i] for f in sc)) for i, k in enumerate(ks)}

    undo = align.patch(torch, nmfk, "replay")
    try:
        res, cpu16, _ = scored_search(v_cpu[bf16], executor, cpu_draws(bf16), retire and retire.replay)
        missing = [k for k in visited if k not in cpu16]
        if executor == "elastic" and missing:
            raise AssertionError(f"the card's elastic run visited ks {missing} the CPU's did not")
        if executor == "threads":
            cpu16.update({k: nmfk.nmfk_score(v_cpu[bf16], k, cpu_draws(bf16)(k, k), c["nmf_iters"]) for k in missing})
        elif missing:
            cpu16.update(lanes(bf16, missing))
    finally:
        undo()
    flips = list(retire.flips) if retire else []
    if executor == "elastic":
        cpu32 = scored_search(v_cpu[fp32], executor, cpu_draws(fp32), retire.replay)[1]
    elif executor == "threads":
        cpu32 = {k: nmfk.nmfk_score(v_cpu[fp32], k, cpu_draws(fp32)(k, k), c["nmf_iters"]) for k in visited}
    else:
        cpu32 = lanes(fp32, visited)
    return res, cpu16, cpu32, flips


def run_nmfk_bf16(torch, dev, ops, log) -> dict[str, dict[str, int]]:
    """``nmfk_paper_bf16`` on threads, batched and elastic: the main path's
    launches (counts reset just before, read just after: the bf16 MU and
    silhouette kernels, no float32 one), k_optimal 8 on the card and on the
    CPU (plain versions, the card's draws copied), each visited k's min and
    mean silhouette against the CPU's bf16 run, elastic's sweep identity;
    wall, device busy share and peak memory beside nmfk_paper's through the
    same API, with the card's name and power limit. The timed runs of both
    dtypes are not instrumented; the card's scores, alignments and
    retirements come from a third, untimed bf16 run."""
    from repro_torch.factorization import nmfk
    from repro_torch.factorization.synthetic import nmf_data
    from repro_torch.random import Draws, seeded_draws

    c = NMFK_PAPER
    n, m = c["n"], c["m"]
    bf16, fp32 = torch.bfloat16, torch.float32
    v = {dt: nmf_data(n, m, c["k_true"], seed=0, device=dev, dtype=dt)[0] for dt in (bf16, fp32)}
    card_draws = seeded_draws(0, n, m, c["n_perturbs"], c["epsilon"], dev, bf16)  # the bf16 search's own draws
    v_cpu = {bf16: v[bf16].cpu(), fp32: v[bf16].cpu().float()}  # the same values, at either dtype

    def cpu_draws(dtype):
        return lambda k, k_draw: Draws(*(t.cpu().to(dtype) for t in card_draws(k, k_draw)))

    def sweeps_identity(plane, run: str) -> None:
        if plane.sweeps_run + plane.sweeps_saved != plane.sweeps_fixed_total:
            raise AssertionError(f"{label} ({run}): sweeps run {plane.sweeps_run} + saved {plane.sweeps_saved} != "
                                 f"fixed total {plane.sweeps_fixed_total}")

    out, smi = {}, smi_line()
    for executor in NMFK_BF16_EXECUTORS:
        label = f"nmfk_paper_bf16_{executor}"
        walls, peaks, results = {}, {}, {}
        for dt in (bf16, fp32):  # bf16 first: its run is the main path
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = sync_wall(torch)
            results[dt] = nmfk_api_search(v[dt], executor)
            walls[dt] = sync_wall(torch) - t0
            peaks[dt] = torch.cuda.max_memory_allocated()
            if dt == bf16:
                counts = ops.launch_counts()
        for dt in (bf16, fp32):
            if results[dt][0].k_optimal != c["k_true"]:
                raise AssertionError(f"{label}: {dt} k_optimal {results[dt][0].k_optimal} != {c['k_true']}")
        sums = "silhouette_dist_sums" if executor == "threads" else "silhouette_dist_sums_batched"
        on = {name: counts[ops.bf16_name(getattr(ops, name))] for name in ("mu_update_h", "mu_update_w", sums)}
        fp32_kernels = ("mu_update_h", "mu_update_w", "silhouette_dist_sums", "silhouette_dist_sums_batched")
        if min(on.values()) < 1 or any(counts[name] for name in fp32_kernels):
            raise AssertionError(f"{label}: the main path's launches {counts}")
        main_plane = results[bf16][1]
        if executor == "elastic":
            sweeps_identity(main_plane, "main path")
        busy = {dt: busy_share(torch, lambda dt=dt: nmfk_api_search(v[dt], executor))[0] for dt in (bf16, fp32)}

        # the card's scores and decisions, for the CPU to replay
        retire = RetireLog(1e-3) if executor == "elastic" else None  # the launcher's tol
        align = AlignLog()
        undo = align.patch(torch, nmfk, "record")
        try:
            res, scores, plane = scored_search(v[bf16], executor, gate=retire and retire.record)
        finally:
            undo()
        if res.k_optimal != c["k_true"]:
            raise AssertionError(f"{label} (recorded run): k_optimal {res.k_optimal} != {c['k_true']}")
        if executor == "elastic":
            sweeps_identity(plane, "recorded run")

        visited = sorted(res.visited_ks)
        t0 = time.perf_counter()
        cpu_res, cpu16, cpu32, bf16_flips = cpu_nmfk_bf16(torch, executor, visited, v_cpu, cpu_draws, retire, align)
        cpu_s = time.perf_counter() - t0
        if cpu_res.k_optimal != c["k_true"]:
            raise AssertionError(f"{label}: the CPU's bf16 k_optimal {cpu_res.k_optimal} != {c['k_true']}")
        per_k, failed = {}, []
        for k in visited:
            row = {}
            for field in ("min_silhouette", "mean_silhouette"):
                card, cpu, cpu_fp32 = (float(getattr(sc[k], field)) for sc in (scores, cpu16, cpu32))
                bound = max(BF16_GAP_RATIO * abs(cpu - cpu_fp32), BF16_SIL_FLOOR)
                if not abs(card - cpu) <= bound:
                    failed.append(f"k {k} {field}: card {card:.5f} vs CPU bf16 {cpu:.5f}, gap {abs(card - cpu):.3e} "
                                  f"> {bound:.3e} (CPU fp32 {cpu_fp32:.5f})")
                row[field] = [card, cpu, cpu_fp32, bound]
            row["rel_error"] = [float(sc[k].rel_error) for sc in (scores, cpu16, cpu32)]
            per_k[k] = row
        entry = {"search": label, "k_optimal": results[bf16][0].k_optimal, "recorded_k_optimal": res.k_optimal,
                 "cpu_k_optimal": cpu_res.k_optimal, "main_visited": sorted(results[bf16][0].visited_ks),
                 "visited": visited, "cpu_visited": sorted(cpu_res.visited_ks),
                 "per_k_card_cpu16_cpu32_bound": per_k, "wall_s": walls[bf16], "fp32_wall_s": walls[fp32],
                 "busy_share": busy[bf16], "fp32_busy_share": busy[fp32], "max_memory_allocated": peaks[bf16],
                 "fp32_max_memory_allocated": peaks[fp32], "cpu_s": cpu_s, "launches": counts,
                 "align_flips_cpu_bf16": align.flips, "card": smi}
        failed += [f"k {f['k']}: the CPU's own alignment left the card's at a margin of {f['margin_ulps']:.2f} bf16 "
                   f"ulps, beyond {AlignLog.ALIGN_TIE_ULPS}" for f in align.flips if not f["near_tie"]]
        if executor == "elastic":
            entry.update(sweeps_run=main_plane.sweeps_run, sweeps_saved=main_plane.sweeps_saved,
                         sweeps_fixed_total=main_plane.sweeps_fixed_total, warm_start_hits=main_plane.warm_cache.hits,
                         recorded_sweeps_run=plane.sweeps_run,
                         retire_decisions=len(retire.decisions), retire_flips_cpu_bf16=bf16_flips,
                         retire_flips_cpu_fp32=retire.flips[len(bf16_flips):])
            failed += [f"retirement {f['lane']} flipped on the CPU at a margin {f['cpu_margin']:.3e} beyond "
                       f"{RetireLog.RETIRE_TIE_ULPS} bf16 ulps" for f in bf16_flips if not f["near_tie"]]
        log(json.dumps(entry))
        if failed:
            raise AssertionError(f"{label}: " + "; ".join(failed))
        out[label] = counts
    return out


def _live_pairs(lq: int, lk: int, causal: bool, window: int | None, q_offset: int = 0) -> int:
    """(query, key) pairs the masks leave live, query row i at position
    ``q_offset + i``: the work this run's data needs."""
    if not causal and window is None:
        return lq * lk
    w = window if window is not None else lk
    return sum(min(q_offset + i + 1, w) for i in range(lq))


def _plain_fp64_err(ref, q, k, v, got, plain32, causal, window, q_offset=0) -> tuple[float, float]:
    """Max abs error of the kernel and of the fp32 plain version against the
    plain version in float64, taken one kv head at a time (bounded memory)."""
    group = q.shape[1] // k.shape[1]
    err_kernel = err_plain = 0.0
    for kh in range(k.shape[1]):
        hs = slice(kh * group, (kh + 1) * group)
        want = ref.attention(q[:, hs].double(), k[:, kh:kh + 1].double(), v[:, kh:kh + 1].double(),
                             causal=causal, window=window, q_offset=q_offset)
        err_kernel = max(err_kernel, float((got[:, hs].double() - want).abs().max()))
        err_plain = max(err_plain, float((plain32[:, hs].double() - want).abs().max()))
        del want
    return err_kernel, err_plain


def check_flash(torch, dev, ops, ref, records: dict, log) -> None:
    """The flash kernel at the serve paths' prefill shapes (qwen2-0.5b: B 4,
    Hq 14, Hk 2, L 1000, D 64, causal; granite-moe-1b-a400m: B 4, Hq 16,
    Hk 8, L 1000, D 64, causal; jamba-v0.1-52b: B 4, Hq 32, Hk 8, L 1024,
    D 128, causal, the kernel's D-128 instantiation: 16 kv rows a tile, Q's
    split fragments read from shared memory; and jamba's heads on one rank
    of ``jamba_serve_tp4``'s model axis of 4: Hq 8, Hk 2. Granite's and
    jamba's cases are drawn last, in that order, so that the other cases
    keep their inputs), at h2o-danube-1.8b's heads with its
    window (B 1, Hq 32, Hk 8, L 6000, D 80, window 4096: ragged, and the
    window skip bites), on a small ragged non-causal case with D 17 and
    an offset base (element-by-element loads and stores), and, drawn after
    all of those, at each rank's query block of ``qwen2_serve_seq14``'s
    sequence-parallel prefill (B 4, Hq 14, Hk 2, Lq 250 of Lk 1000, D 64,
    causal, at q_offset 0, 250, 500 and 750: the last rank has 7 times the
    first's live pairs). Held against the
    fp32 plain version at the reference's tolerance; the errors of both
    against a float64 plain version are reported beside. Each case must give
    the same bits on a second call. The timed cases log both bounds: fp32 on
    CUDA cores, and the split-TF32 products on the tensor cores (the
    kernel's). The library's yardstick is SDPA, which takes a window or a
    query offset only as an explicit boolean mask (its ``is_causal``
    aligns the mask top-left)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    for label, (b, hq, hk, lq, lk, d), causal, window, timed, q_offset in flash_cases():
        q, k, v = (torch.randn((b, h, n, d), device=dev, generator=gen) for h, n in ((hq, lq), (hk, lk), (hk, lk)))
        if not timed:  # one float past a 16-byte boundary
            q, k, v = (torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape).copy_(t) for t in (q, k, v))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        got = ops.flash_attention(q, k, v, **kw)
        plain = ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = compare(torch, got, plain, FLASH_TOL["rtol"], FLASH_TOL["atol"], f"flash_attention [{label}]")
        if not torch.equal(got, ops.flash_attention(q, k, v, **kw)):
            raise AssertionError(f"flash_attention [{label}]: two calls differ")
        err64, plain_err64 = _plain_fp64_err(ref, q, k, v, got, plain, causal, window, q_offset)
        entry = {"case": label, "max_abs_err": err, "max_abs_err_vs_fp64": err64,
                 "plain_fp32_max_abs_err_vs_fp64": plain_err64, "repeat_bitwise": True}
        del got, plain
        if timed:
            pairs = _live_pairs(lq, lk, causal, window, q_offset)
            flops = 4 * b * hq * d * pairs  # q.k and p.v multiply-adds on the live pairs
            n_bytes = 4 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v read; out written
            b32_ms, b32_by = bound_ms(n_bytes, flops)
            # the kernel's own work: three TF32 products for each fp32 one
            btc_ms, btc_by = bound_ms(n_bytes, 3 * flops, TF32_FLOPS_PER_S)
            lib_kw = sdpa_kw(torch, dev, lq, lk, causal, window, q_offset)
            entry.update(
                flops=flops, q_offset=q_offset, live_pairs=pairs,
                ms=time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw)),
                plain_ms=time_ms(torch, lambda: ref.attention(q, k, v, **kw), reps=10),
                bound_ms=btc_ms, bound_by=btc_by, bound_fp32_ms=b32_ms, bound_fp32_by=b32_by,
                library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **lib_kw)),
                library="F.scaled_dot_product_attention(fp32, enable_gqa=True): the same function, one call",
            )
        del q, k, v
        log(json.dumps({"check": "flash_attention", **entry}))
        records.setdefault("flash_attention", []).append(entry)


def flash_cases():
    """(label, (B, Hq, Hk, Lq, Lk, D), causal, window, timed, q_offset) of
    ``check_flash``, in its drawing order."""
    cases = (
        ("qwen2-0.5b prefill: B 4, Hq 14, Hk 2, L 1000, D 64, causal", (4, 14, 2, 1000, 1000, 64), True, None,
         True),
        ("h2o-danube-1.8b heads: B 1, Hq 32, Hk 8, L 6000, D 80, causal, window 4096",
         (1, 32, 8, 6000, 6000, 80), True, 4096, True),
        ("ragged non-causal, offset base: B 2, Hq 6, Hk 3, Lq 70, Lk 45, D 17", (2, 6, 3, 70, 45, 17), False,
         None, False),
        ("granite-moe-1b-a400m prefill: B 4, Hq 16, Hk 8, L 1000, D 64, causal", (4, 16, 8, 1000, 1000, 64), True,
         None, True),
        ("jamba-v0.1-52b prefill: B 4, Hq 32, Hk 8, L 1024, D 128, causal", (4, 32, 8, 1024, 1024, 128), True,
         None, True),
        ("jamba-v0.1-52b prefill, one rank of jamba_serve_tp4: B 4, Hq 8, Hk 2, L 1024, D 128, causal",
         (4, 8, 2, 1024, 1024, 128), True, None, True),
    )
    return tuple((*case, 0) for case in cases) + tuple(
        (f"qwen2-0.5b prefill, rank {r} of qwen2_serve_seq14: B 4, Hq 14, Hk 2, Lq 250, Lk 1000, D 64, causal, "
         f"q_offset {250 * r}", (4, 14, 2, 250, 1000, 64), True, None, True, 250 * r) for r in range(4))


def sdpa_kw(torch, dev, lq: int, lk: int, causal: bool, window: int | None, q_offset: int) -> dict:
    """SDPA's arguments for the same masks: ``is_causal`` where it aligns
    (its mask is top-left), else an explicit boolean mask."""
    if window is None and q_offset == 0:
        return dict(is_causal=causal)
    i, j = q_offset + torch.arange(lq, device=dev)[:, None], torch.arange(lk, device=dev)[None, :]
    return dict(attn_mask=(j <= i) & (j > i - (window or lk + lq)))


def check_flash_bf16(torch, dev, ops, ref, records: dict, log) -> None:
    """The bf16 flash kernel (``flash_attention_bf16``) at every shape of
    ``check_flash``, on bf16 inputs drawn there: held against the plain
    version (fp32 scores, softmax and sums, bf16 out) at the reference's
    bf16 tolerance, its max error from the float64 plain version at most
    ``BF16_FP64_RATIO`` times the plain version's, the same bits on a
    second call, and no launch of the fp32 kernel. Timed against the bf16
    bound (bf16 bytes at the HBM rate against the live pairs' FLOPs at the
    dense bf16 rate) and SDPA at bf16. Then, untimed, the same gates at
    ``FLASH_BF16_MORE``: every head-dim slab layout (D 1..128), the masks,
    Lq != Lk at an offset, and strided views on both of the producer's
    routes (tensor boxes, plain loads)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    name = ops.FLASH_BF16
    for label, (b, hq, hk, lq, lk, d), causal, window, timed, q_offset in flash_cases():
        q, k, v = (torch.randn((b, h, n, d), device=dev, generator=gen).bfloat16()
                   for h, n in ((hq, lq), (hk, lk), (hk, lk)))
        if not timed:  # one element past a 16-byte boundary
            q, k, v = (torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)[1:].view(t.shape).copy_(t)
                       for t in (q, k, v))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        entry = _flash_bf16_gate(torch, ops, ref, q, k, v, kw, label)
        if timed:
            pairs = _live_pairs(lq, lk, causal, window, q_offset)
            flops = 4 * b * hq * d * pairs  # q.k and p.v multiply-adds on the live pairs
            n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v read; out written
            bms, bby = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
            lib_kw = sdpa_kw(torch, dev, lq, lk, causal, window, q_offset)
            entry.update(
                flops=flops, q_offset=q_offset, live_pairs=pairs,
                ms=time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw)),
                plain_ms=time_ms(torch, lambda: ref.attention(q, k, v, **kw), reps=10),
                bound_ms=bms, bound_by=bby,
                library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **lib_kw)),
                library="F.scaled_dot_product_attention(bf16, enable_gqa=True): the same function, one call",
            )
        del q, k, v
        log(json.dumps({"check": name, **entry}))
        records.setdefault(name, []).append(entry)
    # the rest of the kernel's layouts and routes, untimed
    for label, (b, hq, hk, lq, lk, d), causal, window, q_offset, view in FLASH_BF16_MORE:
        q, k, v = (torch.randn((b, h, n, d), device=dev, generator=gen).bfloat16()
                   for h, n in ((hq, lq), (hk, lk), (hk, lk)))
        if view == "rows":  # rows of D + 9 elements, one past a 16-byte boundary: the producer's plain loads
            q, k, v = (torch.zeros((*t.shape[:-1], d + 9), device=dev, dtype=t.dtype)[..., 1:1 + d].copy_(t)
                       for t in (q, k, v))
        elif view == "model":  # (B, L, H, D) projections seen as (B, H, L, D): tensor boxes on a permuted view
            q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
        entry = _flash_bf16_gate(torch, ops, ref, q, k, v, dict(causal=causal, window=window, q_offset=q_offset),
                                 label)
        log(json.dumps({"check": name, **entry}))
        records.setdefault(name, []).append(entry)
        del q, k, v


# (label, (B, Hq, Hk, Lq, Lk, D), causal, window, q_offset, view) of check_flash_bf16 beyond flash_cases():
# every slab layout D 1..128, the masks, Lq != Lk at an offset, and strided views on both routes
FLASH_BF16_MORE = (
    ("D 1", (1, 2, 1, 100, 100, 1), True, None, 0, None),
    ("D 16, GQA 2, ragged", (2, 4, 2, 129, 129, 16), True, None, 0, None),
    ("D 32, MQA, window 24", (1, 4, 1, 64, 64, 32), True, 24, 0, None),
    ("D 96, two slabs", (1, 4, 2, 300, 300, 96), True, None, 0, None),
    ("D 112, window 77", (1, 3, 3, 517, 517, 112), True, 77, 0, None),
    ("D 64, non-causal window 100", (1, 4, 2, 256, 256, 64), False, 100, 0, None),
    ("D 128, Lq 33 of Lk 97 at q_offset 64, window 16", (2, 4, 2, 33, 97, 128), True, 16, 64, None),
    ("D 80, Lq 100 of Lk 300 at q_offset 200, window 50", (1, 4, 1, 100, 300, 80), True, 50, 200, None),
    ("D 64, rows of 73, offset base", (2, 6, 3, 150, 150, 64), True, 40, 0, "rows"),
    ("D 128, rows of 137, offset base", (2, 6, 3, 150, 150, 128), True, None, 0, "rows"),
    ("D 64, the model's (B, L, H, D) views", (2, 14, 2, 300, 300, 64), True, None, 0, "model"),
    ("D 128, the model's (B, L, H, D) views", (2, 8, 2, 200, 200, 128), True, None, 0, "model"),
)


def _flash_bf16_gate(torch, ops, ref, q, k, v, kw: dict, label: str) -> dict:
    """One bf16 flash call held to its gates: the bf16 kernel launched once
    and the fp32 one not, bf16 out within BF16_FLASH_TOL of the plain
    version, the same bits on a second call, the float64 error at most
    BF16_FP64_RATIO times the plain version's. Returns its record."""
    name = ops.FLASH_BF16
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    counts = ops.launch_counts()
    if counts[name] != 1 or counts["flash_attention"] != 0 or got.dtype != torch.bfloat16:
        raise AssertionError(f"{name} [{label}]: launches {counts}, output {got.dtype}")
    plain = ref.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err = compare(torch, got, plain, BF16_FLASH_TOL["rtol"], BF16_FLASH_TOL["atol"], f"{name} [{label}]")
    if not torch.equal(got, ops.flash_attention(q, k, v, **kw)):
        raise AssertionError(f"{name} [{label}]: two calls differ")
    err64, plain_err64 = _plain_fp64_err(ref, q, k, v, got, plain, kw["causal"], kw["window"], kw["q_offset"])
    if err64 > BF16_FP64_RATIO * plain_err64:
        raise AssertionError(f"{name} [{label}]: {err64:.3e} from float64, over {BF16_FP64_RATIO} x the plain "
                             f"version's {plain_err64:.3e}")
    return {"case": label, "max_abs_err": err, "max_abs_err_vs_fp64": err64,
            "plain_max_abs_err_vs_fp64": plain_err64, "repeat_bitwise": True}


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

        def spy(params, xt, cfg, capacity, sh=None):
            r = self.real(params, xt, cfg, capacity, sh)
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


def flash_layers(cfg) -> int:
    """Flash launches in one prefill: one a GQA attention layer; none for
    MLA (its qk and v heads differ), Mamba or RWKV."""
    return 0 if cfg.attention == "mla" else cfg.pattern().count("a")


def prefill_label(cfg) -> str:
    return "flash prefill" if flash_layers(cfg) else "prefill"


class RouteReplay:
    """Teacher-forced MoE routes for the bf16 checks. ``record`` keeps every
    ``models.moe.route`` call of one run (the card's bf16 run); ``replay``
    makes another run (the CPU's bf16 copy, the fp32 run) take the recorded
    calls' experts in order, with its own router's logits, probabilities
    and gates at those experts, so the runs compute the same experts'
    outputs and their logits differ by arithmetic alone. Without it a
    token whose k-th and (k+1)-th router probabilities lie within bf16's
    noise takes other experts on either side, and one token's flip moves
    the logits by ~10x bf16's own gap (granite at full width, 32 experts,
    top 8). Each replaying run keeps its own probabilities and the tokens
    whose own top-k differs from the recorded one (``check``)."""

    def __init__(self, torch):
        from repro_torch.models import moe

        self.torch, self.moe, self.routes = torch, moe, []

    @contextlib.contextmanager
    def record(self):
        real = self.moe.route

        def spy(params, xt, cfg, capacity, sh=None):
            r = real(params, xt, cfg, capacity, sh)
            self.routes.append(r)
            return r

        self.moe.route = spy
        try:
            yield self
        finally:
            self.moe.route = real

    @contextlib.contextmanager
    def replay(self, run: dict):
        """``run`` gains ``probs`` (each call's own probabilities, on the
        CPU) and ``differ`` (each call's tokens whose own top-k is not the
        recorded one, with their own top-k margins)."""
        torch, moe, real, calls = self.torch, self.moe, self.moe.route, iter(self.routes)
        run.update(probs=[], differ=[])

        def take(params, xt, cfg, capacity, sh=None):
            own, rec, k = real(params, xt, cfg, capacity, sh), next(calls), cfg.moe.top_k
            ids = rec.expert_ids.to(own.expert_ids.device)
            differ = (own.expert_ids.view(-1, k).sort(1).values != ids.view(-1, k).sort(1).values).any(1)
            run["probs"].append(own.probs.cpu())
            run["differ"].append((differ.nonzero()[:, 0].cpu(), own.margin[differ].cpu()))
            gates = own.probs.gather(1, ids.view(-1, k))
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
            buf_idx, keep = moe._dispatch_indices(ids, cfg.moe.num_experts, capacity)
            return own._replace(expert_ids=ids, gates=gates, buf_idx=buf_idx, keep=keep)

        moe.route = take
        try:
            yield run
        finally:
            moe.route = real
        if len(run["probs"]) != len(self.routes):
            raise AssertionError(f"the replaying run made {len(run['probs'])} route calls, the recorded one "
                                 f"{len(self.routes)}")

    def check(self, cpu: dict, fp32: dict, label: str) -> dict:
        """The card's router probabilities within BF16_GAP_RATIO times the
        gap between the CPU's bf16 ones and the fp32 run's (the logits'
        gate, on the router), and every token the CPU's bf16 router would
        send elsewhere explained by that noise: its own top-k margin at most
        twice its largest probability gap to the card (no smaller change
        can swap two experts)."""
        if not self.routes:
            return {}
        gaps = [(r.probs.cpu() - p).abs() for r, p in zip(self.routes, cpu["probs"])]
        card_gap = max(float(g.max()) for g in gaps)
        bound = BF16_GAP_RATIO * max(float((p - q).abs().max()) for p, q in zip(cpu["probs"], fp32["probs"]))
        if card_gap > bound:
            raise AssertionError(f"{label}: card router probabilities {card_gap:.3g} from the CPU's, over "
                                 f"{BF16_GAP_RATIO} x the CPU's bf16-vs-fp32 gap ({bound:.3g})")
        flips = []
        for call, (g, (tokens, margins)) in enumerate(zip(gaps, cpu["differ"])):
            for t, m in zip(tokens.tolist(), margins.tolist()):
                noise = float(g[t].max())
                if m > 2 * noise:
                    raise AssertionError(f"{label}: route {call}: token {t} takes other experts on the CPU at a "
                                         f"top-k margin {m:.3g} over twice its probability gap {noise:.3g}")
                flips.append(m)
        return {"routes_replayed": len(self.routes), "router_prob_gap": card_gap, "router_prob_bound": bound,
                "cpu_route_flips": len(flips), "max_flip_margin": max(flips, default=0.0)}


def cast_model(torch, model, dtype):
    """``model``'s weights cast in place, leaf by leaf, as a ``Model`` of
    ``dtype``: at bfloat16 each leaf takes the dtype the port's own bf16
    init gives it (bf16; float32 for the norms and the MoE router, read
    from ``init_meta``), at float32 every leaf is float32."""
    from repro_torch.models.transformer import Model

    out = Model(model.cfg, dtype=dtype)
    dtypes = {n: p.dtype for n, p in out.init_meta().named_parameters()}
    for n, p in model.params.named_parameters():
        p.data = p.data.to(dtypes[n])
    out.params = model.params
    return out


def model_copy(torch, model, device, dtype=None):
    """A copy of ``model`` on ``device``, leaf by leaf (float32 casts every leaf)."""
    from repro_torch.models.transformer import Model

    memo = {id(p): torch.nn.Parameter(p.detach().to(device, dtype or p.dtype), requires_grad=False)
            for p in model.params.parameters()}
    out = Model(model.cfg, dtype=dtype or model.dtype)
    out.params = copy.deepcopy(model.params, memo)
    return out


def forced(torch, model, prompt, steps: int, tokens=None):
    """(logits of a prefill of ``prompt`` and of ``steps`` decode steps,
    float32 on the CPU; the tokens fed): each step is fed ``tokens[:, i]``,
    or without ``tokens`` the greedy token of the step before."""
    dev, plen = model.device, prompt.shape[1]
    lg, caches = model.prefill({"tokens": prompt.to(dev)}, cache_len=plen + steps)
    out, fed = [lg.float().cpu()], []
    for i in range(steps):
        tok = torch.argmax(out[-1][:, -1], dim=-1)[:, None] if tokens is None else tokens[:, i:i + 1].cpu()
        fed.append(tok)
        lg, caches = model.decode_step(caches, tok.to(dev), plen + i)
        out.append(lg.float().cpu())
    del caches
    return out, torch.cat(fed, dim=1)


def hold_bf16(torch, card: list, cpu: list, fp32: list, label: str) -> dict:
    """The bf16 gates of ``forced`` runs, step by step: the card's logits
    within BF16_GAP_RATIO times the gap between the CPU's bf16 logits and
    the fp32 run's, and the card's greedy token the CPU's wherever the
    CPU's top-2 margin exceeds twice that bound."""
    gaps, bounds, decided = [], [], 0
    for i, (a, b, c) in enumerate(zip(card, cpu, fp32)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label}: step {i}: non-finite card logits")
        gap, bound = float((a - b).abs().max()), BF16_GAP_RATIO * float((b - c).abs().max())
        if gap > bound:
            raise AssertionError(f"{label}: step {i}: card bf16 logits {gap:.4g} from the CPU's, over "
                                 f"{BF16_GAP_RATIO} x the CPU's bf16-vs-fp32 gap ({bound:.4g})")
        top2 = torch.topk(b[:, -1], 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * bound
        if bool((sure & (torch.argmax(a[:, -1], -1) != torch.argmax(b[:, -1], -1))).any()):
            raise AssertionError(f"{label}: step {i}: greedy tokens differ at a decided margin")
        gaps.append(gap)
        bounds.append(bound)
        decided += int(sure.sum())
    return {"bf16_logit_gaps": gaps, "bf16_bounds": bounds, "decided_tokens": decided,
            "logits_max_abs": max(float(b.abs().max()) for b in cpu)}


def check_lm_bf16(torch, dev, ops, log, label: str, cpu_model, prompt) -> None:
    """``cpu_model``'s weights at bf16 (``cast_model``, in place) on the card
    (the bf16 flash kernel) against the same bf16 model on the CPU (plain
    path), a prefill of ``prompt`` and BF16_STEPS decode steps fed the
    card's greedy tokens, held by ``hold_bf16`` against an fp32 run of the
    same weights on the CPU; the card's prefill launches the bf16 flash
    kernel once an attention layer and the fp32 kernel never; the CPU runs
    take the card's MoE routes (``RouteReplay``)."""
    cpu16 = cast_model(torch, cpu_model, torch.bfloat16)
    cpu32 = model_copy(torch, cpu16, "cpu", torch.float32)
    card = model_copy(torch, cpu16, dev)
    routes, on_cpu, on_32 = RouteReplay(torch), {}, {}
    ops.reset_launch_counts()
    with routes.record():
        lg_card, tokens = forced(torch, card, prompt, BF16_STEPS)
    counts = ops.launch_counts()
    del card
    want = flash_layers(cpu16.cfg)
    if counts[ops.FLASH_BF16] != want or counts["flash_attention"] != 0:
        raise AssertionError(f"{label} bf16: launches {counts}, not {want} of {ops.FLASH_BF16} and none of the "
                             "fp32 kernel")
    with routes.replay(on_cpu):
        lg_cpu, _ = forced(torch, cpu16, prompt, BF16_STEPS, tokens)
    with routes.replay(on_32):
        lg_32, _ = forced(torch, cpu32, prompt, BF16_STEPS, tokens)
    held = hold_bf16(torch, lg_card, lg_cpu, lg_32, f"{label} bf16")
    log(json.dumps({"check": f"lm bf16 card vs plain bf16: {label}", "steps": BF16_STEPS, **held,
                    "tokens": tokens.tolist(), "launches": {k: counts[k] for k in (ops.FLASH_BF16, "flash_attention")},
                    **routes.check(on_cpu, on_32, f"{label} bf16")}))


def check_lm_small(torch, dev, ops, log) -> None:
    """The LM's prefill logits and 8 greedy tokens on the card (flash kernel
    for GQA) against the CPU (plain path), same weights, teacher-forced with
    the card's tokens: qwen2-0.5b at full width (vocab 151,936) cut to 2
    layers, B 1, prompt 200; reduced h2o-danube-1.8b (window 16), B 2,
    prompt 40; granite-moe-1b-a400m at full width cut to 2 layers, B 1,
    prompt 200; deepseek-v2 at full widths cut to 2 layers (the dense first
    layer and one MoE layer) and 16 of its 160 routed experts, B 1, prompt
    64 (MLA: no flash launch); jamba-v0.1-52b at full widths cut to one
    8-layer period with 4 of its 16 experts, B 1, prompt 64 (one flash
    launch; both scans take their chunked branch); rwkv6-1.6b at full width
    cut to 2 layers, B 2, prompts 40 (the token recurrence) and 64 (the
    chunked WKV), no flash launch. Every MoE route is held to the CPU's
    (``RouteWatch``). qwen2, h2o-danube, granite and jamba then run at bf16
    on the same weights (``check_lm_bf16``)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import setup
    from repro_torch.serve.decode import generate

    cpu = torch.device("cpu")
    deepseek = get_config("deepseek-v2-236b")
    jamba = get_config("jamba-v0.1-52b")
    rwkv6_2l = dataclasses.replace(get_config("rwkv6-1.6b"), num_layers=2)
    cases = (  # (label, config, batch, prompt, also at bf16)
        ("qwen2-0.5b, full width, 2 layers", dataclasses.replace(get_config("qwen2-0.5b"), num_layers=2), 1, 200,
         True),
        ("h2o-danube-1.8b reduced, window 16", reduced_config(get_config("h2o-danube-1.8b")), 2, 40, True),
        ("granite-moe-1b-a400m, full width, 2 layers",
         dataclasses.replace(get_config("granite-moe-1b-a400m"), num_layers=2), 1, 200, True),
        (f"deepseek-v2, full widths, 2 layers (dense + MoE), {DEEPSEEK_SMALL_EXPERTS} routed experts",
         dataclasses.replace(deepseek, num_layers=2,
                             moe=dataclasses.replace(deepseek.moe, num_experts=DEEPSEEK_SMALL_EXPERTS)), 1, 64,
         False),
        (f"jamba-v0.1-52b, full widths, {JAMBA_LAYERS} layers, {JAMBA_SMALL_EXPERTS} experts (both scans chunked)",
         dataclasses.replace(jamba, num_layers=JAMBA_LAYERS,
                             moe=dataclasses.replace(jamba.moe, num_experts=JAMBA_SMALL_EXPERTS)), 1, 64, True),
        ("rwkv6-1.6b, full width, 2 layers (the token recurrence)", rwkv6_2l, 2, 40, False),
        ("rwkv6-1.6b, full width, 2 layers (the chunked WKV)", rwkv6_2l, 2, 64, False),
    )
    steps = 8
    for label, cfg, batch, plen, bf16 in cases:
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
        want_flash = flash_layers(cfg)
        if flash != want_flash:
            raise AssertionError(f"{label}: {flash} flash launches in one prefill of {cfg.num_layers} layers, "
                                 f"not {want_flash}")
        if cfg.moe is not None and not routes.calls:
            raise AssertionError(f"{label}: no MoE route was compared")
        log(json.dumps({"check": f"lm card vs plain: {label}", "batch": batch, "prompt": plen,
                        "logits_max_abs_gap": max(gaps), "tokens": tokens.tolist(),
                        "flash_launches_per_prefill": flash,
                        **(routes.summary() if cfg.moe is not None else {})}))
        del card_model, c_card, c_cpu
        if bf16:
            check_lm_bf16(torch, dev, ops, log, label, cpu_model, prompt)
        del cpu_model


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
    (``_train_vs_cpu``): qwen2-0.5b, granite-moe-1b-a400m and rwkv6-1.6b,
    each at full width (vocab 151,936 / 49,155 / 65,536) cut to 2 layers,
    and jamba-v0.1-52b at full widths cut to 2 layers (Mamba with the dense
    FFN, Mamba with MoE) and 4 of its 16 experts, B 2, L 32 (both scans
    take their chunked branch). Then, on
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
    _train_vs_cpu(torch, dev, log, "rwkv6-1.6b, full width, 2 layers",
                  dataclasses.replace(get_config("rwkv6-1.6b"), num_layers=2))
    jamba = get_config("jamba-v0.1-52b")
    _train_vs_cpu(torch, dev, log, f"jamba-v0.1-52b, full widths, 2 layers (Mamba + dense, Mamba + MoE), "
                  f"{JAMBA_SMALL_EXPERTS} experts",
                  dataclasses.replace(jamba, num_layers=2,
                                      moe=dataclasses.replace(jamba.moe, num_experts=JAMBA_SMALL_EXPERTS)))
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

        def spy(params, xt, cfg, capacity, sh=None):
            r = self.real(params, xt, cfg, capacity, sh)
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
    plen = prompt.shape[1]
    with DropCount(SERVE_BATCH) as drops:
        lg, caches = model.prefill({"tokens": prompt}, cache_len=plen + 2)
    row_drops = drops.by_row()
    dropped = [sum(row_drops)]
    gaps, dropped_row_gaps = [], []
    for i in range(2):
        lg_dec, caches = model.decode_step(caches, tokens[:, i:i + 1], plen + i)
        seq = torch.cat([prompt, tokens[:, :i + 1].long()], dim=1)
        with DropCount(SERVE_BATCH) as drops:
            lg_full, _ = model.prefill({"tokens": seq})
        dropped.append(sum(drops.by_row()))
        row_drops = [a + b for a, b in zip(row_drops, drops.by_row())]
        rows = [b for b in range(SERVE_BATCH) if row_drops[b] == 0]
        if rows:
            what = (f"serve {arch}: decode step {i} vs {prefill_label(model.cfg)} of {seq.shape[1]} tokens, "
                    f"prompts {[order[b] for b in rows]} in rows {rows}")
            gaps.append(compare(torch, lg_dec[rows], lg_full[rows], LOGIT_TOL["rtol"], LOGIT_TOL["atol"], what))
            _decided(torch, lg_dec[rows, -1], tokens[rows, i + 1])
        if len(rows) < SERVE_BATCH:
            dropped_row_gaps.append(float((lg_dec - lg_full).abs().amax(dim=(1, 2)).max()))
    del caches
    return {"order": order, "prompts_compared": [order[b] for b in rows], "logits_max_abs_gap": max(gaps, default=0.0),
            "logits_max_abs": float(lg_full.abs().max()), "dropped_slots_by_prefill": dropped,
            "dropped_slots_by_row": row_drops, "max_abs_gap_with_dropped_rows": max(dropped_row_gaps, default=0.0)}


def run_serve(torch, dev, ops, serve, log, arch: str, prompt_len: int = SERVE_PROMPT) -> dict[str, int]:
    """The serve path at full width, ``SERVE_BATCH`` prompts of ``prompt_len``
    tokens; counts reset just before, read just after: one flash launch an
    attention layer (none for rwkv6). Then a teacher-forced check with the
    same weights: decode-step logits (plain attention over the cache; the
    recurrent states of Mamba or RWKV) against the last row of a prefill of
    the extended sequence, with each prefill's dropped MoE slots
    (capacity factor 2.0, as decode). With MoE it runs twice, the second
    time with the two halves of the batch swapped, and every prompt must be
    compared in one of the two passes: granite's capacity at factor 2.0
    (t · 8 · 2 / 32) is half the tokens and a token takes one slot of an
    expert at most, so the first half of the batch never drops."""
    from repro_torch.configs import get_config

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve.main(serve_args(arch, prompt_len))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = out["tokens"]
    new = SERVE_BATCH * (SERVE_TOKENS - 1)
    SERVE_RECORDS[arch] = {"wall_s": out["seconds"], "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
                           "max_memory_allocated": peak}
    log(json.dumps({"serve": f"{arch} full width", "batch": SERVE_BATCH, "prompt": prompt_len,
                    "tokens": SERVE_TOKENS, "wall_s": out["seconds"], "prefill_s": out["prefill_s"],
                    "decode_s": out["decode_s"], "decode_tokens_per_s": new / out["decode_s"],
                    "tokens_per_s": SERVE_BATCH * SERVE_TOKENS / out["seconds"],
                    "max_memory_allocated": peak, "launches": counts,
                    "sample": tokens[0].tolist()}))
    cfg = get_config(arch)
    if tuple(tokens.shape) != (SERVE_BATCH, SERVE_TOKENS):
        raise AssertionError(f"serve {arch}: tokens of shape {tuple(tokens.shape)}")
    if counts["flash_attention"] != flash_layers(cfg):
        raise AssertionError(f"serve {arch}: {counts['flash_attention']} flash launches for one prefill of "
                             f"{cfg.pattern().count('a')} attention layers")

    model, prompt, _, _ = serve.setup(cfg, SERVE_BATCH, prompt_len, dev, seed=0)
    orders = [list(range(SERVE_BATCH))]
    if cfg.moe is not None:
        half = SERVE_BATCH // 2
        orders.append(orders[0][half:] + orders[0][:half])
    passes = [_teacher_forced(torch, model, prompt, tokens, arch, order) for order in orders]
    compared = sorted(set().union(*(p["prompts_compared"] for p in passes)))
    if compared != orders[0]:
        raise AssertionError(f"serve {arch}: prompts {sorted(set(orders[0]) - set(compared))} dropped MoE slots "
                             f"in every pass; not compared ({passes})")
    log(json.dumps({"check": f"serve {arch} decode vs {prefill_label(cfg)}, teacher-forced", "steps": 2,
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
    aligned = Model(aligned_cfg(cfg))
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


def aligned_cfg(cfg):
    """``cfg`` at an MoE capacity factor of E / top_k + 1, where every expert
    has a slot for every token and none can drop."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.num_experts
                                                            / cfg.moe.top_k + 1))


def aligned_decode_gaps(torch, model, row, served, label: str) -> list[float]:
    """Prompt ``row``'s decode (1, L), teacher-forced with the ``served``
    tokens over JAMBA_CHECK_STEPS steps from its own prefill, each step's
    logits against the last row of the full forward of the extended
    sequence; ``model`` routes at an aligned capacity (``aligned_cfg``), where
    no slot may drop. Returns each step's gap."""
    plen = row.shape[1]
    with DropCount(1) as drops:
        lg, caches = model.prefill({"tokens": row}, cache_len=plen + JAMBA_CHECK_STEPS)
    gaps = []
    for i in range(JAMBA_CHECK_STEPS):
        lg_dec, caches = model.decode_step(caches, served[:, i:i + 1], plen + i)
        seq = torch.cat([row, served[:, :i + 1].long()], dim=1)
        with DropCount(1) as full_drops:
            h, _ = model.backbone(model.embed_input({"tokens": seq}))
        if any(full_drops.by_row()):
            raise AssertionError(f"{label}: the aligned forward dropped {full_drops.by_row()} slots")
        gaps.append(compare(torch, lg_dec, model.logits(h[:, -1:]), LOGIT_TOL["rtol"], LOGIT_TOL["atol"],
                            f"{label}: decode step {i} vs the full forward of {seq.shape[1]}"))
        _decided(torch, lg_dec[:, -1], served[:, i + 1])
    if any(drops.by_row()):
        raise AssertionError(f"{label}: the aligned prefill dropped {drops.by_row()} slots")
    return gaps


def run_jamba_serve(torch, dev, ops, log) -> dict[str, int]:
    """jamba-v0.1-52b at its published widths cut to one 8-layer period (7
    Mamba layers, 1 attention layer, MoE on layers 1, 3, 5, 7), on the card
    only, one copy of the weights: ``generate`` for SERVE_BATCH prompts of
    SCAN_SERVE_PROMPT tokens with counts reset just before, read just after
    (one flash launch, at Hq 32, Hk 8, D 128); then prompt 0's decode,
    teacher-forced over JAMBA_CHECK_STEPS steps from its own prefill,
    against the last row of the full forward of the extended sequence, all
    at a capacity factor of E / top_k + 1 = 9, where every expert has a slot
    for every token and none drops (``run_deepseek_serve``'s alignment). At
    B 4 that factor would need ≈ 13 GB of expert buffers beside the 53 GB of
    weights; B 1 needs a quarter."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import setup
    from repro_torch.models.transformer import Model
    from repro_torch.serve.decode import generate

    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, num_layers=JAMBA_LAYERS)
    torch.cuda.empty_cache()  # the earlier phases' cached blocks: 53 GB of weights follow
    torch.cuda.reset_peak_memory_stats()
    model, prompt, _, _ = setup(cfg, SERVE_BATCH, SCAN_SERVE_PROMPT, dev, seed=0)
    n_params = sum(p.numel() for p in model.params.parameters())
    timings: dict = {}
    ops.reset_launch_counts()
    t0 = sync_wall(torch)
    tokens = generate(model, prompt, steps=SERVE_TOKENS, timings=timings)
    wall = sync_wall(torch) - t0
    counts = ops.launch_counts()
    serve_peak = torch.cuda.max_memory_allocated()
    if tuple(tokens.shape) != (SERVE_BATCH, SERVE_TOKENS):
        raise AssertionError(f"jamba serve: tokens of shape {tuple(tokens.shape)}")
    if counts["flash_attention"] != flash_layers(cfg) or flash_layers(cfg) != 1:
        raise AssertionError(f"jamba serve: {counts['flash_attention']} flash launches for one prefill of "
                             f"{cfg.pattern().count('a')} attention layer")
    check = Model(aligned_cfg(cfg))
    check.params = model.params
    del model
    gaps = aligned_decode_gaps(torch, check, prompt[:1], tokens[:1], "jamba serve")
    peak = torch.cuda.max_memory_allocated()
    SERVE_RECORDS["jamba-v0.1-52b"] = {"wall_s": wall, "prefill_s": timings["prefill_s"],
                                       "decode_s": timings["decode_s"], "max_memory_allocated": serve_peak}
    log(json.dumps({"serve": f"jamba-v0.1-52b full widths, {JAMBA_LAYERS} layers", "params": n_params,
                    "batch": SERVE_BATCH, "prompt": SCAN_SERVE_PROMPT, "tokens": SERVE_TOKENS, "wall_s": wall,
                    "prefill_s": timings["prefill_s"], "decode_s": timings["decode_s"],
                    "decode_tokens_per_s": SERVE_BATCH * (SERVE_TOKENS - 1) / timings["decode_s"],
                    "sample": tokens[0].tolist(), "launches": counts,
                    "decode_vs_full_forward_max_abs_gap": max(gaps), "checked_steps": JAMBA_CHECK_STEPS,
                    "max_memory_allocated_serve": serve_peak, "max_memory_allocated": peak, "card": smi_line()}))
    del check
    return counts


def run_serve_bf16(torch, dev, ops, log, arch: str, layers: int | None = None,
                   prompt_len: int = SERVE_PROMPT) -> dict[str, int]:
    """The reference Model's own dtype served on the card: ``arch`` at its
    published widths (cut to ``layers``), weights from seed 0 (``setup``'s
    fp32 draw, then ``cast_model`` to bf16 in place), ``generate`` for
    SERVE_BATCH prompts of ``prompt_len`` tokens and SERVE_TOKENS new ones,
    counts reset just before, read just after: one launch of the bf16 flash
    kernel an attention layer, none of any other kernel. Then prompt 0
    teacher-forced with the served tokens over BF16_STEPS decode steps, on
    the card and on the CPU's plain bf16 copy of the same weights, held by
    ``hold_bf16``. The fp32 side of the bound is the same weights' fp32
    path on the card (cast in place after the bf16 runs): the CPU's within
    LOGIT_TOL, where a bf16 gap is ~10x that, and an fp32 copy on the host
    would take jamba's 53 GB beside its bf16 one. Walls and peak memory are
    logged beside the fp32 serve path's of this run (``SERVE_RECORDS``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import setup
    from repro_torch.serve.decode import generate

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    label = f"{arch} bf16 full width" + (f", {layers} layers" if layers is not None else "")
    torch.cuda.empty_cache()
    model, prompt, _, _ = setup(cfg, SERVE_BATCH, prompt_len, dev, seed=0)
    model = cast_model(torch, model, torch.bfloat16)
    n_params = sum(p.numel() for p in model.params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.params.parameters())
    torch.cuda.empty_cache()  # the fp32 draw's blocks
    torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    ops.reset_launch_counts()
    t0 = sync_wall(torch)
    tokens = generate(model, prompt, steps=SERVE_TOKENS, timings=timings)
    wall = sync_wall(torch) - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if tuple(tokens.shape) != (SERVE_BATCH, SERVE_TOKENS):
        raise AssertionError(f"{label}: tokens of shape {tuple(tokens.shape)}")
    want = {name: 0 for name in counts}
    want[ops.FLASH_BF16] = flash_layers(cfg)
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, not {want}")
    row, served = prompt[:1], tokens[:1]
    routes, on_cpu, on_32 = RouteReplay(torch), {}, {}
    with routes.record():
        lg_card, _ = forced(torch, model, row, BF16_STEPS, served)
    cpu16 = model_copy(torch, model, "cpu")
    t_cpu = time.perf_counter()
    with routes.replay(on_cpu):
        lg_cpu, _ = forced(torch, cpu16, row, BF16_STEPS, served)
    cpu_s = time.perf_counter() - t_cpu
    del cpu16
    with routes.replay(on_32):
        lg_32, _ = forced(torch, cast_model(torch, model, torch.float32), row, BF16_STEPS, served)
    del model
    torch.cuda.empty_cache()
    held = {**hold_bf16(torch, lg_card, lg_cpu, lg_32, label), **routes.check(on_cpu, on_32, label)}
    mine = {"wall_s": wall, "prefill_s": timings["prefill_s"], "decode_s": timings["decode_s"],
            "max_memory_allocated": peak}
    fp32 = SERVE_RECORDS.get(arch, {})
    log(json.dumps({"serve": label, "params": n_params, "weight_bytes": weight_bytes, "batch": SERVE_BATCH,
                    "prompt": prompt_len, "tokens": SERVE_TOKENS, **mine,
                    "decode_tokens_per_s": SERVE_BATCH * (SERVE_TOKENS - 1) / timings["decode_s"],
                    "launches": counts, "sample": tokens[0].tolist(), "fp32_serve": fp32,
                    "bf16_over_fp32": {k: mine[k] / fp32[k] for k in fp32 if fp32[k]},
                    "teacher_forced_prompt": 0, "steps": BF16_STEPS, **held, "cpu_bf16_s": cpu_s,
                    "card": smi_line()}))
    return counts


# the serve path on a (data, model) mesh of 4 ranks, one process a card, each
# label (arch, data, model, layers; None: all): jamba-v0.1-52b whole (32
# layers, 51.57 B parameters, 206 GB in fp32) at (1, 4) through the serve
# launcher; the others against the one-card run of the same weights
# (``record_one_card``): jamba's 8-layer cut at (2, 2); qwen2-0.5b whole at
# (1, 4), whose 14 heads do not divide 4 (the sequence-parallel prefill,
# each rank's 250 query rows at q_offset r·250; the decode's attention whole
# on every rank); deepseek-v2 cut to 2 layers with 16 routed experts at
# (1, 4) (MLA on a rank's 32 heads, the latent cache cut on its width, 144
# a rank); rwkv6-1.6b whole at (1, 4) (8 of its 32 heads a rank), at prompts
# of 1024 (the chunked WKV) and 1000 (the token loop)
MULTI_RANK_SERVES = {
    "jamba_serve_tp4": ("jamba-v0.1-52b", 1, 4, None),
    "jamba_serve_8l_mesh22": ("jamba-v0.1-52b", 2, 2, JAMBA_LAYERS),
    "qwen2_serve_seq14": ("qwen2-0.5b", 1, 4, None),
    "deepseek_serve_2l_tp4": ("deepseek-v2-236b", 1, 4, DEEPSEEK_LAYERS),
    "rwkv6_serve_tp4": ("rwkv6-1.6b", 1, 4, None),
}
MESH_SERVE_PROMPTS = {"qwen2-0.5b": (SERVE_PROMPT,), "deepseek-v2-236b": (DEEPSEEK_PROMPT,),
                      "rwkv6-1.6b": (SCAN_SERVE_PROMPT, SERVE_PROMPT), "jamba-v0.1-52b": (SCAN_SERVE_PROMPT,)}
MULTI_RANK_SERVE_TIMEOUT_S = 900


def mesh_serve_cfg(arch: str, layers: int | None):
    """A mesh serve's config: the arch at its published widths, cut to
    ``layers``; deepseek-v2 to ``DEEPSEEK_SMALL_EXPERTS`` routed experts."""
    from repro_torch.configs import cut_config, get_config

    experts = DEEPSEEK_SMALL_EXPERTS if arch == "deepseek-v2-236b" else None
    return cut_config(get_config(arch), layers, experts)


def record_one_card(torch, dev, cfg, prompt_len: int, path: Path) -> None:
    """The one-card greedy run of a mesh serve's model and prompts (seed 0):
    the prompt, the SERVE_TOKENS tokens and each step's logits, saved to
    ``path`` for ``vs_one_card``. Frees the card after."""
    import gc

    from repro_torch.launch.serve import setup

    torch.cuda.empty_cache()
    model, prompt, _, _ = setup(cfg, SERVE_BATCH, prompt_len, dev, seed=0)
    lg, caches = model.prefill({"tokens": prompt}, cache_len=prompt_len + SERVE_TOKENS)
    logits, tokens = [lg], [torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]]
    for i in range(SERVE_TOKENS - 1):
        lg, caches = model.decode_step(caches, tokens[-1], prompt_len + i)
        logits.append(lg)
        tokens.append(torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None])
    torch.save({"prompt": prompt.cpu(), "tokens": torch.cat(tokens, dim=1).cpu(),
                "logits": torch.cat(logits, dim=1).cpu()}, path)
    del model, caches, lg, logits
    gc.collect()
    torch.cuda.empty_cache()


def run_multi_rank_serves(torch, dev, log) -> dict[str, dict[str, int]]:
    """The serve path on 4 ranks, one process a card (``torchrun``,
    rendezvous on localhost), each mesh of ``MULTI_RANK_SERVES`` in one
    launch (``rank_serve``), after its one-card records (card 0, freed
    before the launch): each rank serves SERVE_BATCH prompts of each length
    of ``MESH_SERVE_PROMPTS`` and SERVE_TOKENS new tokens with counts reset
    just before, read just after, and writes its tokens, launches, times,
    peak memory and checks. Gates: one flash launch an attention layer and
    prefill on every rank (none for MLA and RWKV), the same tokens on every
    rank of a model group, and each rank's own checks (``rank_serve``).
    Launch counts are summed over the ranks. Needs 4 cards."""
    import os
    import signal
    import tempfile

    cards = torch.cuda.device_count()
    if cards < 4:
        log(f"multi-rank serves: not made ({cards} card(s) visible; {', '.join(MULTI_RANK_SERVES)} need 4)")
        return {}
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        for label, (arch, data, model, layers) in MULTI_RANK_SERVES.items():
            outdir = Path(tmp) / label
            outdir.mkdir()
            cfg = mesh_serve_cfg(arch, layers)
            prompts = MESH_SERVE_PROMPTS[arch]
            records = []
            if label != "jamba_serve_tp4":
                for plen in prompts:
                    records.append(str(outdir / f"one_card_{plen}.pt"))
                    record_one_card(torch, dev, cfg, plen, Path(records[-1]))
            (outdir / "spec.json").write_text(json.dumps({"label": label, "arch": arch, "data": data, "model": model,
                                                          "layers": layers, "prompts": prompts,
                                                          "records": records}))
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
                   str(ROOT / "chip_smoke.py"), "--rank-serve", str(outdir)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                    start_new_session=True)
            try:
                text, _ = proc.communicate(timeout=MULTI_RANK_SERVE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
                raise AssertionError(f"{label}: no result within {MULTI_RANK_SERVE_TIMEOUT_S} s")
            for line in text.splitlines():
                if "near-tie" in line:
                    log(line)
            if proc.returncode != 0:
                raise AssertionError(f"{label}: torchrun exited {proc.returncode}:\n{text[-4000:]}")
            ranks = [json.loads((outdir / f"rank{r}.json").read_text()) for r in range(4)]
            attn = flash_layers(cfg) * len(prompts)
            for r, rank in enumerate(ranks):
                group = ranks[r - r % model]
                if rank["tokens"] != group["tokens"] or rank["launches"]["flash_attention"] != attn:
                    raise AssertionError(f"{label}: rank {r} tokens {rank['tokens']} and "
                                         f"{rank['launches']['flash_attention']} flash launches; rank "
                                         f"{r - r % model}: {group['tokens']}, want {attn} launches")
            log(json.dumps({"serve": label, "arch": arch, "mesh": {"data": data, "model": model},
                            "layers": layers or cfg.num_layers, "batch": SERVE_BATCH, "prompts": prompts,
                            "tokens": SERVE_TOKENS,
                            "prefill_s": [rank["prefill_s"] for rank in ranks],
                            "decode_s": [rank["decode_s"] for rank in ranks],
                            "max_memory_allocated": [rank["max_memory_allocated"] for rank in ranks],
                            "max_memory_allocated_check": [rank["max_memory_allocated_check"] for rank in ranks],
                            "params_per_rank": [rank["params"] for rank in ranks],
                            "sample": ranks[0]["tokens"][0][0], "check": ranks[0]["check"],
                            "launches_by_rank": [rank["launches"] for rank in ranks], "card": smi_line()}))
            by_path[label] = {name: sum(rank["launches"][name] for rank in ranks) for name in ranks[0]["launches"]}
    return by_path


def rank_serve(outdir: Path) -> int:
    """One rank of ``run_multi_rank_serves`` (under ``torchrun``), the mesh in
    ``outdir/spec.json``. ``jamba_serve_tp4``: the serve launcher
    (``launch.serve.main``) with jamba-v0.1-52b whole at ``--data-shards 1
    --model-shards 4``, then prompt 0's decode against the full forward at
    an aligned capacity (``aligned_decode_gaps``). The others: for each
    prompt length, ``setup`` and ``generate`` on the mesh (counted and
    timed), then this rank's rows teacher-forced with the one-card run's
    tokens, each step's logits within LOGIT_TOL of the one-card run's, and
    the served tokens the one-card run's up to a near-tie of its top two
    logits (printed; ``vs_one_card``). Writes ``outdir/rank<RANK>.json``."""
    import os

    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.serve.decode import generate

    spec = json.loads((outdir / "spec.json").read_text())
    label, data, model_size = spec["label"], spec["data"], spec["model"]
    dev = resolve("cuda")
    cfg = mesh_serve_cfg(spec["arch"], spec["layers"])
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    torch.cuda.reset_peak_memory_stats()
    if label == "jamba_serve_tp4":
        ops.reset_launch_counts()
        out = serve.main([*serve_args("jamba-v0.1-52b", SCAN_SERVE_PROMPT), "--data-shards", str(data),
                          "--model-shards", str(model_size)])
        counts = ops.launch_counts()
        result = {"tokens": [out["tokens"].tolist()], "launches": counts, "prefill_s": [out["prefill_s"]],
                  "decode_s": [out["decode_s"]], "max_memory_allocated": torch.cuda.max_memory_allocated()}
        torch.cuda.reset_peak_memory_stats()
        with make_lm_mesh(data, model_size, dev) as mesh:
            check, prompt, _, _ = serve.setup(aligned_cfg(cfg), SERVE_BATCH, SCAN_SERVE_PROMPT, mesh.device, 0, mesh)
            result["params"] = sum(p.numel() for p in check.params.parameters())
            gaps = aligned_decode_gaps(torch, check, prompt[:1], out["tokens"][:1].to(mesh.device), label)
            result["check"] = {"decode_vs_full_forward_max_abs_gap": max(gaps), "checked_steps": len(gaps)}
            del check
    else:
        result = {"tokens": [], "prefill_s": [], "decode_s": [], "check": []}
        counts = {name: 0 for name in ops.launch_counts()}
        peaks = []
        with make_lm_mesh(data, model_size, dev) as mesh:
            for plen, record in zip(spec["prompts"], spec["records"]):
                model, prompt, _, _ = serve.setup(cfg, SERVE_BATCH, plen, mesh.device, 0, mesh)
                result["params"] = sum(p.numel() for p in model.params.parameters())
                timings: dict = {}
                ops.reset_launch_counts()
                tokens = generate(model, prompt, steps=SERVE_TOKENS, timings=timings)
                counts = {name: counts[name] + n for name, n in ops.launch_counts().items()}
                peaks.append(torch.cuda.max_memory_allocated())
                result["tokens"].append(tokens.tolist())
                result["prefill_s"].append(timings["prefill_s"])
                result["decode_s"].append(timings["decode_s"])
                torch.cuda.reset_peak_memory_stats()
                result["check"].append({"prompt": plen, **vs_one_card(torch, model, prompt, tokens,
                                                                      torch.load(record), mesh, f"{label} {plen}")})
                del model
        result.update(launches=counts, max_memory_allocated=max(peaks))
    result["max_memory_allocated_check"] = torch.cuda.max_memory_allocated()
    (outdir / f"rank{os.environ['RANK']}.json").write_text(json.dumps(result))
    return 0


def vs_one_card(torch, model, prompt, served, record: dict, mesh, label: str) -> dict:
    """This data rank's rows on the mesh ``model`` against the one-card
    ``record`` of the same weights (``record_one_card``): the same prompt;
    teacher-forced with the recorded tokens, the prefill's and each decode
    step's logits within LOGIT_TOL, and the argmax the recorded token
    wherever the logits decide it; the ``served`` (free-running) tokens the
    recorded ones, each row up to its first step where the one-card run's
    top two logits lie within the tolerance (a near-tie, printed)."""
    dev = prompt.device
    rows = slice(mesh.data_index * prompt.shape[0], (mesh.data_index + 1) * prompt.shape[0])
    want_tokens, want_logits = record["tokens"][rows].to(dev), record["logits"][rows].to(dev)
    if not torch.equal(prompt.cpu(), record["prompt"][rows]):
        raise AssertionError(f"{label}: the mesh drew another prompt than the one-card run")
    plen = prompt.shape[1]
    lg, caches = model.prefill({"tokens": prompt}, cache_len=plen + SERVE_TOKENS)
    gaps = [compare(torch, lg, want_logits[:, :1], LOGIT_TOL["rtol"], LOGIT_TOL["atol"], f"{label}: prefill logits")]
    _decided(torch, lg[:, -1], want_tokens[:, 0])
    for i in range(SERVE_TOKENS - 1):
        lg, caches = model.decode_step(caches, want_tokens[:, i:i + 1], plen + i)
        gaps.append(compare(torch, lg, want_logits[:, i + 1:i + 2], LOGIT_TOL["rtol"], LOGIT_TOL["atol"],
                            f"{label}: decode step {i} logits"))
        _decided(torch, lg[:, -1], want_tokens[:, i + 1])
    near_ties = []
    for b, (got, want) in enumerate(zip(served.tolist(), want_tokens.tolist())):
        step = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w), None)
        if step is None:
            continue
        top2 = torch.topk(want_logits[b, step], 2).values
        margin = float(top2[0] - top2[1])
        if margin > 2 * (LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * abs(float(top2[0]))):
            raise AssertionError(f"{label}: row {rows.start + b} served token {got[step]} at step {step}, the "
                                 f"one-card run {want[step]} at a top-2 margin of {margin:.3e}")
        near_ties.append({"row": rows.start + b, "step": step, "margin": margin})
        print(f"{label}: near-tie {near_ties[-1]}", flush=True)
    return {"logits_max_abs_gap_vs_one_card": max(gaps), "steps": len(gaps), "near_ties": near_ties}


# LM training on a mesh of 4 ranks, one process a card, each label
# (arch, pod, data, model), weights and the synthetic stream from seed 0,
# fp32 with TF32 off, B 8, L 64 in 2 microbatches, remat full, AdamW lr
# 1e-3, 3 steps. ``jamba_train_8l_mesh``: jamba-v0.1-52b at its published
# widths cut to one 8-layer period (13.30 B parameters, 53.2 GB in fp32;
# with its gradients and AdamW's two moments ≈ 213 GB, more than a card
# holds) at three (data, model) meshes, held to its first;
# ``qwen2_train_seq14``: qwen2-0.5b
# whole at (1, 1, 4), the sequence-parallel residual (14 heads over 4; L
# 64, 16 rows a rank); ``rwkv6_train_2l_mesh22`` and
# ``deepseek_train_2l_mesh22`` (16 routed experts), each cut to 2 layers, at
# (1, 2, 2); each held to the one-card run of the same arch, args and seed
# (``one_card_train``, card 0, before its launch); ``granite_train_pod``:
# granite-moe-1b-a400m at its published widths on the pod axis, (pod 2,
# data 2, model 1: FSDP over data 2, the batch over 4 ranks) against (pod
# 1, data 4, model 1), the group held to its first mesh. Either way step
# 0's loss at 1e-5, the gradient norms and the 3 steps' losses at 1e-4,
# every rank the same numbers. Each run's dry-run cell
# (``launch.dryrun.measure`` on a fake group of 4 ranks, the same step on
# ``meta``) must give each rank's measured parameter count and
# optimizer-state bytes exactly; its peak is logged beside each rank's
# ``max_memory_allocated``
MULTI_RANK_TRAINS = {"jamba_train_8l_mesh14": ("jamba-v0.1-52b", 1, 1, 4),
                     "jamba_train_8l_mesh22": ("jamba-v0.1-52b", 1, 2, 2),
                     "jamba_train_8l_mesh41": ("jamba-v0.1-52b", 1, 4, 1),
                     "qwen2_train_seq14": ("qwen2-0.5b", 1, 1, 4),
                     "rwkv6_train_2l_mesh22": ("rwkv6-1.6b", 1, 2, 2),
                     "deepseek_train_2l_mesh22": ("deepseek-v2-236b", 1, 2, 2)}
# the cut of each mesh training arch: (layers, routed experts); None: whole.
# rwkv6-1.6b at its published widths has a first gradient that grows with
# depth at its random init, and one card's own sums in another order (1
# microbatch against 2) spread it as far: the norm 3618.7 and 5.8 % apart
# at 24 layers; with its constants moved off their init values 7.59, 17.56,
# 173.0, 17673 and 3.1e-7, 1.0e-4, 4.8e-3, 7.9e-2 apart at 2, 6, 12, 24
# layers (``tools/grad_spread.py``). No mesh run of it past 2 layers can
# meet the 1e-4 gates, so the mesh training run is the 2-layer cut (as
# ``check_train_small`` holds it, card against CPU)
MESH_TRAIN_CUTS = {"jamba-v0.1-52b": (JAMBA_LAYERS, None), "deepseek-v2-236b": (DEEPSEEK_LAYERS,
                                                                                 DEEPSEEK_SMALL_EXPERTS),
                   "rwkv6-1.6b": (2, None)}
POD_TRAINS = {"granite_train_pod1": ("granite-moe-1b-a400m", 1, 4, 1),
              "granite_train_pod2": ("granite-moe-1b-a400m", 2, 2, 1)}
MESH_TRAIN_STEPS = 3
MESH_TRAIN_LOSS0_RTOL, MESH_TRAIN_RTOL = 1e-5, 1e-4
MULTI_RANK_TRAIN_TIMEOUT_S = 600
# reduced jamba and granite at (2, 2) against a one-card step on the card,
# at tests/test_torch_lm_train_mesh.py's sizes and tolerances (FSDP cuts
# every leaf of 2^10 elements or more): loss 1e-5; each gradient, joined to
# whole, relative norm 1e-4 and elementwise rtol 1e-4, atol 1e-5 × its scale
SMALL_MESH_TRAIN = dict(batch=8, seq=32, microbatches=2, fsdp_min_elems=1 << 10)
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-5


def mesh_train_args(arch: str, pod: int, data: int, model: int) -> list[str]:
    layers, experts = MESH_TRAIN_CUTS.get(arch, (None, None))
    cut = [*(["--layers", str(layers)] if layers else []), *(["--experts", str(experts)] if experts else [])]
    return ["--arch", arch, "--no-reduced", *cut, "--steps", str(MESH_TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--microbatches", str(TRAIN_MICRO), "--remat", "full", "--lr", "1e-3",
            "--device", "cuda", "--seed", "0", "--quiet", "--pod-shards", str(pod), "--data-shards", str(data),
            "--model-shards", str(model)]


def mesh_train_cell(arch: str, pod: int, data: int, model: int) -> dict:
    """The dry-run cell of a mesh training run (``dry_run``'s spec)."""
    layers, experts = MESH_TRAIN_CUTS.get(arch, (None, None))
    return {"arch": arch, "layers": layers, "experts": experts, "seq": TRAIN_SEQ,
            "batch": TRAIN_BATCH, "microbatches": TRAIN_MICRO, "steps": MESH_TRAIN_STEPS, "pod": pod,
            "data": data, "model": model}


def run_dry_run(cells: list[dict], outdir: Path) -> subprocess.Popen:
    """Start ``dry_run`` over ``cells`` in a process of its own, with no card
    visible (the dry run needs none); ``dry_run_records`` reads it."""
    import os

    (outdir / "spec.json").write_text(json.dumps(cells))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dry-run", str(outdir)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    return proc


def stop_process(proc: subprocess.Popen, scratch: Path) -> None:
    """Kill ``proc``'s process group if it still runs, and remove ``scratch``."""
    import os
    import shutil
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
    shutil.rmtree(scratch, ignore_errors=True)


def dry_run_records(proc: subprocess.Popen, outdir: Path, deadline: float) -> tuple[list[dict], float]:
    """(the records of a ``run_dry_run`` process, its wall); it must exit 0
    before ``deadline`` (``time.perf_counter``; else it is killed and this
    raises)."""
    import os
    import signal

    try:
        text, _ = proc.communicate(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        raise AssertionError(f"the dry run found no end in time:\n{text[-4000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"the dry run exited {proc.returncode}:\n{text[-4000:]}")
    out = json.loads((outdir / "records.json").read_text())
    return out["records"], out["seconds"]


def dry_run(outdir: Path) -> int:
    """``--dry-run OUTDIR``: the cells of ``OUTDIR/spec.json``: the
    production cells (``arch``, ``shape``, ``multi``) through
    ``dryrun.run_cells``, then the mesh training runs (``mesh_train_cell``:
    ``dryrun.measure`` at fp32 with ``launch.train``'s AdamW, on a fake
    group of its ranks); writes ``OUTDIR/records.json``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ShapeConfig, cut_config, get_config
    from repro_torch.launch import dryrun
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainConfig

    t0 = time.perf_counter()
    cells = json.loads((outdir / "spec.json").read_text())
    production = [(cell["arch"], cell["shape"], cell["multi"]) for cell in cells if "shape" in cell]
    records = dryrun.run_cells(production, str(outdir / "cells"), force=True)[0] if production else []
    for cell in cells:
        if "shape" in cell:
            continue
        cfg = cut_config(get_config(cell["arch"]), cell["layers"], cell["experts"])
        tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=max(cell["steps"], 10)),
                           microbatches=cell["microbatches"])
        shape = ShapeConfig("mesh_train", cell["seq"], cell["batch"], "train")
        with dryrun.fake_mesh(cell["data"], cell["model"], cell["pod"]) as mesh:
            rec = dryrun.measure(dryrun.cell_model(cfg, shape, mesh, torch.float32), shape, mesh, tcfg)
        records.append(rec)
        print(json.dumps({k: rec.get(k) for k in ("arch", "remat", "run_s")}), flush=True)
    (outdir / "records.json").write_text(json.dumps({"records": records, "seconds": time.perf_counter() - t0}))
    return 0


def dry_run_summary(rec: dict) -> dict:
    """A record's numbers for the log: bytes a rank, the peak, FLOPs, census bytes."""
    mem = rec["memory"]
    arguments = {k: v for k, v in mem.items() if k not in ("output_bytes", "peak_bytes")}
    return {"params_per_rank": rec["params_per_rank"], "argument_bytes": arguments, "peak_bytes": mem["peak_bytes"],
            "output_bytes": mem["output_bytes"], "flops": rec["flops"],
            "census_bytes": rec["collectives"]["total_bytes"], "collectives": rec["collectives"]["by_op"],
            "build_s": rec["build_s"], "run_s": rec["run_s"]}


# the dry run (``launch.dryrun``) on the host, in two processes (one a
# mesh) started after the build and read at the end, no card visible:
# every arch's decode_32k and long_500k, train_4k of ``DRYRUN_TRAINS`` and
# prefill_32k of ``DRYRUN_PREFILLS``, on the production meshes (16, 16)
# and (2, 16, 16). Gates: ``ok`` where ``check_mesh`` admits the arch at
# model 16 (every arch of the registry), ``error`` with exactly
# its ``NotImplementedError`` where it refuses, ``skip`` exactly where
# ``shape_applicable`` says
DRYRUN_TRAINS = ("llama3-405b", "granite-moe-1b-a400m", "qwen2-0.5b")
DRYRUN_PREFILLS = ("granite-moe-1b-a400m", "deepseek-v2-236b")
DRYRUN_TIMEOUT_S = 900
# qwen2-0.5b's train_4k must fit an 80 GB card a rank: its training loss
# keeps the logits cut over the vocabulary (151,936 over 16), where joined
# rows of the whole vocabulary peaked at 100.2 GB a rank
DRYRUN_PEAK_LIMITS = {("qwen2-0.5b", "train_4k"): 80e9}


def dry_run_cells(multi: bool) -> list[dict]:
    """The cells of one production mesh (``multi``: the 2-pod one)."""
    from repro_torch.configs import registry

    cells = [{"arch": a, "shape": s, "multi": multi} for a in sorted(registry()) for s in ("decode_32k", "long_500k")]
    cells += [{"arch": a, "shape": "train_4k", "multi": multi} for a in DRYRUN_TRAINS]
    return cells + [{"arch": a, "shape": "prefill_32k", "multi": multi} for a in DRYRUN_PREFILLS]


def check_dry_run(runs: list[tuple[list[dict], float]], log) -> None:
    """The gates of the production cells' records (``dry_run_cells``), each
    run's (records, wall); one line a cell: an ``ok`` cell's bytes a rank,
    peak, FLOPs and census."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.models.layers import Axes
    from repro_torch.models.transformer import check_mesh

    counts = {"ok": 0, "error": 0, "skip": 0}
    records = [rec for recs, _ in runs for rec in recs]
    for rec in records:
        cfg, shape = get_config(rec["arch"]), SHAPES[rec["shape"]]
        refusal = None
        try:
            check_mesh(cfg, Axes(model_size=16))
        except NotImplementedError as err:
            refusal = f"NotImplementedError: {err}"
        want = "skip" if not shape_applicable(cfg, shape)[0] else "error" if refusal else "ok"
        if rec["status"] != want or (want == "error" and rec["error"] != refusal):
            raise AssertionError(f"dry run {rec['cell']}: {rec['status']} ({rec.get('error') or rec.get('reason')}), "
                                 f"want {want} ({refusal})\n{rec.get('traceback', '')}")
        counts[want] += 1
        if want != "ok":
            log(json.dumps({"dryrun": rec["cell"], "status": want, "why": rec.get("error") or rec.get("reason")}))
            continue
        summary = dry_run_summary(rec)
        held = summary["argument_bytes"]["total"] - summary["argument_bytes"]["inputs"]
        if not (summary["params_per_rank"] > 0 and summary["flops"] > 0 and summary["census_bytes"] > 0
                and summary["peak_bytes"] >= held):
            raise AssertionError(f"dry run {rec['cell']}: {summary}")
        limit = DRYRUN_PEAK_LIMITS.get((rec["arch"], rec["shape"]))
        if limit is not None and not summary["peak_bytes"] < limit:
            raise AssertionError(f"dry run {rec['cell']}: peak {summary['peak_bytes']} bytes a rank, not below {limit}")
        log(json.dumps({"dryrun": rec["cell"], "status": "ok", "dtype": rec["dtype"], "remat": rec["remat"],
                        "remat_group": rec["remat_group"], "microbatches": rec.get("microbatches"), **summary}))
    walls = ", ".join(f"{seconds:.1f}" for _, seconds in runs)
    log(f"dry run: {walls} s on the host (a process a mesh) for {len(records)} cells ({json.dumps(counts)})")


def one_card_train(torch, arch: str) -> dict:
    """``launch.train.main`` of a mesh training run's arch, args and seed on
    card 0 with no mesh, TF32 off as on the ranks: its losses and gradient
    norms, the base ``run_multi_rank_trains`` holds the mesh run to. Frees
    the card after."""
    import gc

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import train

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = train.main(mesh_train_args(arch, 1, 1, 1))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    base = {"losses": out["losses"], "grad_norms": out["grad_norms"], "step_seconds": out["step_seconds"]}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return base


def run_multi_rank_trains(torch, log) -> dict[str, dict[str, int]]:
    """The training path on 4 ranks, one process a card (``torchrun``,
    rendezvous on localhost), each mesh of ``MULTI_RANK_TRAINS`` and
    ``POD_TRAINS`` in one launch (``rank_train``), counts reset just before,
    read just after. Gates: every rank the same losses and gradient norms,
    finite, no kernel launch (training takes plain attention); each run of
    ``MULTI_RANK_TRAINS`` agrees with the first mesh of its arch, or, for an
    arch with one mesh, with its one-card run (``one_card_train``), and
    ``POD_TRAINS`` with its first mesh (step 0's loss at
    MESH_TRAIN_LOSS0_RTOL, gradient norms and losses at MESH_TRAIN_RTOL);
    each run's dry-run cell (run first, in a process of its own) gives
    every rank's parameter count and optimizer-state bytes exactly; at
    jamba's (2, 2) ``rank_train``'s reduced checks. Logs each
    rank's peak memory against the dry run's peak, the step seconds and the
    launches. Needs 4 cards."""
    import os
    import signal
    import tempfile

    cards = torch.cuda.device_count()
    if cards < 4:
        log(f"multi-rank trains: not made ({cards} card(s) visible; {', '.join(MULTI_RANK_TRAINS)} and "
            "granite_train_pod need 4)")
        return {}
    trains = {**MULTI_RANK_TRAINS, **POD_TRAINS}
    lead = {}  # the first run of each arch of MULTI_RANK_TRAINS
    for label, (arch, *_) in MULTI_RANK_TRAINS.items():
        lead.setdefault(arch, label)
    counts = {arch: sum(spec[0] == arch for spec in MULTI_RANK_TRAINS.values()) for arch in lead}
    bases = {label: lead[arch] if counts[arch] > 1 else f"{arch} one card"
             for label, (arch, *_) in MULTI_RANK_TRAINS.items()}
    bases.update({label: next(iter(POD_TRAINS)) for label in POD_TRAINS})
    by_path, runs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        proc = run_dry_run([mesh_train_cell(*spec) for spec in trains.values()], Path(tmp))
        records, seconds = dry_run_records(proc, Path(tmp), time.perf_counter() + MULTI_RANK_TRAIN_TIMEOUT_S)
        log(f"mesh train dry runs: {seconds:.1f} s for {len(records)} cells")
        predicted = dict(zip(trains, records))
        for label, (arch, pod, data, model) in trains.items():
            outdir = Path(tmp) / label
            outdir.mkdir()
            if label in MULTI_RANK_TRAINS and bases[label] == f"{arch} one card":  # before the ranks run
                runs[bases[label]] = one_card_train(torch, arch)
            (outdir / "spec.json").write_text(json.dumps({"label": label, "arch": arch, "pod": pod, "data": data,
                                                          "model": model,
                                                          "small": (arch, pod, data, model) == (
                                                              "jamba-v0.1-52b", 1, 2, 2)}))
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
                   str(ROOT / "chip_smoke.py"), "--rank-train", str(outdir)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                    start_new_session=True)
            try:
                text, _ = proc.communicate(timeout=MULTI_RANK_TRAIN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
                raise AssertionError(f"{label}: no result within {MULTI_RANK_TRAIN_TIMEOUT_S} s")
            if proc.returncode != 0:
                raise AssertionError(f"{label}: torchrun exited {proc.returncode}:\n{text[-4000:]}")
            ranks = [json.loads((outdir / f"rank{r}.json").read_text()) for r in range(4)]
            first = ranks[0]
            for r, rank in enumerate(ranks):
                if (rank["losses"], rank["grad_norms"]) != (first["losses"], first["grad_norms"]):
                    raise AssertionError(f"{label}: rank {r} losses {rank['losses']} norms {rank['grad_norms']}, "
                                         f"rank 0 {first['losses']} {first['grad_norms']}")
                if any(rank["launches"].values()):
                    raise AssertionError(f"{label}: rank {r} launched kernels on the training path: {rank['launches']}")
            if len(first["losses"]) != MESH_TRAIN_STEPS or not all(
                    math.isfinite(x) for x in first["losses"] + first["grad_norms"]):
                raise AssertionError(f"{label}: losses {first['losses']}, grad norms {first['grad_norms']}")
            rec = predicted[label]
            for r, rank in enumerate(ranks):
                if rank["params"] != rec["params_per_rank"]:
                    raise AssertionError(f"{label}: rank {r} holds {rank['params']} parameters, the dry run "
                                         f"{rec['params_per_rank']}")
                if rank["opt_state_bytes"] != rec["memory"]["opt_state"]:
                    raise AssertionError(f"{label}: rank {r} holds {rank['opt_state_bytes']} bytes of optimizer "
                                         f"state, the dry run {rec['memory']['opt_state']}")
            peaks = [rank["max_memory_allocated"] for rank in ranks]
            log(json.dumps({"train": label, "arch": arch, "mesh": {"pod": pod, "data": data, "model": model},
                            "layers": MESH_TRAIN_CUTS.get(arch, (None,))[0] or "all",
                            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": first["microbatches"],
                            "remat": "full", "losses": first["losses"], "grad_norms": first["grad_norms"],
                            "step_seconds": [rank["step_seconds"] for rank in ranks],
                            "max_memory_allocated": peaks, "dryrun": dry_run_summary(rec),
                            "dryrun_peak_rel_gap": [(rec["memory"]["peak_bytes"] - p) / p for p in peaks],
                            "params_by_rank": [rank["params"] for rank in ranks],
                            "opt_state_bytes_by_rank": [rank["opt_state_bytes"] for rank in ranks],
                            "small_checks": first.get("small"),
                            "launches_by_rank": [rank["launches"] for rank in ranks], "card": smi_line()}))
            runs[label] = first
            by_path[label] = {name: sum(rank["launches"][name] for rank in ranks) for name in first["launches"]}
    for label, base_label in bases.items():
        base, run = runs[base_label], runs[label]
        loss0 = abs(run["losses"][0] - base["losses"][0]) / abs(base["losses"][0])
        norms = max(abs(a - b) / abs(b) for a, b in zip(run["grad_norms"], base["grad_norms"]))
        losses = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], base["losses"]))
        if loss0 > MESH_TRAIN_LOSS0_RTOL or norms > MESH_TRAIN_RTOL or losses > MESH_TRAIN_RTOL:
            raise AssertionError(f"{label} against {base_label}: step 0 loss {loss0:.3e}, gradient norms "
                                 f"{norms:.3e}, losses {losses:.3e} (relative)")
        log(json.dumps({"train_mesh_agreement": label, "against": base_label, "loss0_rel_gap": loss0,
                        "grad_norm_max_rel_gap": norms, "loss_max_rel_gap": losses}))
    return by_path


def small_mesh_train_checks(torch, data: int, model_size: int) -> dict:
    """Reduced jamba and granite on the ``(data, model)`` mesh of this
    ``torchrun`` against a one-card step on this rank's card, the same
    weights (seed 0) and batch: the loss, and every gradient joined to
    whole (``SMALL_MESH_TRAIN``'s tolerances); FSDP must cut some leaves."""
    from repro_torch.configs import ShapeConfig, get_config, reduced_config
    from repro_torch.data.pipeline import SyntheticTokenSource, device_put_batch
    from repro_torch.launch.mesh import make_axes, make_lm_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.train.train_step import accumulate_grads

    out = {}
    b, n = SMALL_MESH_TRAIN["batch"], SMALL_MESH_TRAIN["microbatches"]
    with make_lm_mesh(data, model_size, "cuda") as mesh:
        dev = mesh.device
        for arch in ("jamba-v0.1-52b", "granite-moe-1b-a400m"):
            cfg = reduced_config(get_config(arch))
            batch = device_put_batch(
                SyntheticTokenSource(cfg, ShapeConfig("smoke", SMALL_MESH_TRAIN["seq"], b, "train")).batch_at(0), dev)
            m = Model(cfg, remat="full", ax=make_axes(mesh, b), mesh=mesh,
                      fsdp_min_elems=SMALL_MESH_TRAIN["fsdp_min_elems"])
            m.init(torch.Generator(device=dev).manual_seed(0))
            one = Model(cfg, remat="full")
            one.init(torch.Generator(device=dev).manual_seed(0))
            loss, grads = accumulate_grads(m, batch, n)
            loss1, grads1 = accumulate_grads(one, batch, n)
            joined = m.gather(grads)
            if not m.fsdp_dims() or set(joined) != set(grads1):
                raise AssertionError(f"{arch} on the mesh: FSDP leaves {len(m.fsdp_dims())}, "
                                     f"gradients {sorted(set(joined) ^ set(grads1))} unmatched")
            loss_gap = abs(float(loss) - float(loss1)) / abs(float(loss1))
            if loss_gap > TRAIN_LOSS_RTOL:
                raise AssertionError(f"{arch} on the mesh: loss {float(loss)} against one card's {float(loss1)}")
            worst = 0.0
            for name, g in joined.items():
                want = grads1[name]
                gap = float(torch.linalg.norm(g - want) / torch.linalg.norm(want))
                worst = max(worst, gap)
                scale = float(want.abs().max())
                if gap > TRAIN_GRAD_NORM_RTOL or not torch.allclose(g, want, rtol=GRAD_RTOL,
                                                                      atol=GRAD_ATOL_SCALE * scale):
                    raise AssertionError(f"{arch} on the mesh: gradient of {name}: relative norm error {gap:.3e} "
                                         "against one card's")
            out[arch] = {"loss": float(loss), "loss_rel_gap": loss_gap, "grad_worst_rel_norm_err": worst,
                         "fsdp_leaves": len(m.fsdp_dims()), "params_with_grad": len(joined)}
            del m, one, grads, grads1, joined
    return out


def rank_train(outdir: Path) -> int:
    """One rank of ``run_multi_rank_trains`` (under ``torchrun``), the run in
    ``outdir/spec.json``: ``launch.train.main`` (``mesh_train_args``), its
    losses, gradient norms, step seconds, peak memory, parameter count,
    optimizer-state bytes and launches; then, if the spec says so,
    ``small_mesh_train_checks``. Writes ``outdir/rank<RANK>.json``."""
    import gc
    import os

    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    spec = json.loads((outdir / "spec.json").read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = train.main(mesh_train_args(spec["arch"], spec["pod"], spec["data"], spec["model"]))
    counts = ops.launch_counts()
    opt = out["opt_state"]
    result = {"losses": out["losses"], "grad_norms": out["grad_norms"], "step_seconds": out["step_seconds"],
              "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": counts,
              "params": sum(p.numel() for p in out["params"].parameters()), "microbatches": out["microbatches"],
              "opt_state_bytes": sum(t.numel() * t.element_size() for t in [opt.step, *opt.m.values(),
                                                                            *opt.v.values()])}
    del out, opt
    gc.collect()
    torch.cuda.empty_cache()
    if spec["small"]:
        result["small"] = small_mesh_train_checks(torch, spec["data"], spec["model"])
    (outdir / f"rank{os.environ['RANK']}.json").write_text(json.dumps(result))
    return 0


# ``granite_train_opts_mesh22``: the training options on a mesh, at the
# published widths of granite-moe-1b-a400m (24 layers), (pod 1, data 2,
# model 2), FSDP off, fp32 with TF32 off, seed 0, B 8, L 64 in 2
# microbatches, remat full, 4 steps, one ``torchrun`` (``rank_train_opts``).
# (a) ZeRO-1 moments against none: losses, gradient norms and joined
# parameters bit for bit, and a rank's moment bytes exactly its blocks of
# ``opt_state_specs(zero1=True)`` in GSPMD's ceil layout; (b) ``int8``:
# step 0's compressed gradients, joined, bit for bit one-card
# ``compress_tree`` of the joined gradients, then 4 steps with finite
# losses; (c) ``launch.train --ckpt --ckpt-every 2``: 2 steps, then
# ``--resume`` to 4, the losses of an uninterrupted 4-step run bit for bit,
# and the checkpoint restored on one card the mesh run's joined parameters
TRAIN_OPTS = dict(label="granite_train_opts_mesh22", arch="granite-moe-1b-a400m", data=2, model=2, steps=4)
TRAIN_OPTS_TIMEOUT_S = 600


def _gspmd_elems(shape, spec, coords: dict[str, tuple[int, int]]) -> int:
    """Elements of a rank's block of a leaf of ``shape`` placed by ``spec`` in
    GSPMD's layout: a dimension cut over n ranks in blocks of ceil(size / n),
    the last short or empty; ``coords``: {axis: (this rank's index, ranks)}."""
    n = 1
    for size, entry in zip(shape, spec):
        if entry is None:
            n *= size
            continue
        index, count = coords[entry]
        per = -(-size // count)
        n *= max(0, min(per, size - index * per))
    return n


def run_train_opts(torch, log) -> dict[str, dict[str, int]]:
    """``TRAIN_OPTS`` on 4 ranks, one process a card (``torchrun``), counts
    reset just before, read just after; gates (a)-(c) and no kernel launch,
    every rank the same numbers. Logs each rank's peak memory and step
    seconds. Needs 4 cards."""
    import os
    import signal

    label = TRAIN_OPTS["label"]
    cards = torch.cuda.device_count()
    if cards < 4:
        log(f"multi-rank training options: not made ({cards} card(s) visible; {label} needs 4)")
        return {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_opts_") as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
               str(ROOT / "chip_smoke.py"), "--rank-train-opts", tmp]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            text, _ = proc.communicate(timeout=TRAIN_OPTS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise AssertionError(f"{label}: no result within {TRAIN_OPTS_TIMEOUT_S} s")
        if proc.returncode != 0:
            raise AssertionError(f"{label}: torchrun exited {proc.returncode}:\n{text[-4000:]}")
        wall = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(4)]
    first = ranks[0]
    runs = ("plain", "zero1", "int8")
    for r, rank in enumerate(ranks):
        for run in runs:
            if (rank[run]["losses"], rank[run]["grad_norms"]) != (first[run]["losses"], first[run]["grad_norms"]):
                raise AssertionError(f"{label} {run}: rank {r} {rank[run]}, rank 0 {first[run]}")
        if any(rank["launches"].values()):
            raise AssertionError(f"{label}: rank {r} launched kernels on the training path: {rank['launches']}")
        if not (rank["zero1"]["params_equal"] and rank["zero1"]["moment_bytes"] == rank["zero1"]["want_moment_bytes"]):
            raise AssertionError(f"{label} (a): rank {r} parameters equal {rank['zero1']['params_equal']}, moment "
                                 f"bytes {rank['zero1']['moment_bytes']}, the zero1 blocks "
                                 f"{rank['zero1']['want_moment_bytes']}")
        if rank["int8"]["mismatched"] or not rank["int8"]["joined"]:
            raise AssertionError(f"{label} (b): rank {r} compressed leaves unlike one card's: "
                                 f"{rank['int8']['mismatched'][:5]}, joined {rank['int8']['joined']}")
        if rank["ckpt"]["losses"] != rank["ckpt"]["uninterrupted"]:
            raise AssertionError(f"{label} (c): rank {r} resumed losses {rank['ckpt']['losses']}, uninterrupted "
                                 f"{rank['ckpt']['uninterrupted']}")
    plain, zero1 = first["plain"], first["zero1"]
    if (zero1["losses"], zero1["grad_norms"]) != (plain["losses"], plain["grad_norms"]):
        raise AssertionError(f"{label} (a): ZeRO-1 {zero1['losses']} {zero1['grad_norms']}, plain {plain['losses']} "
                             f"{plain['grad_norms']}")
    if not all(math.isfinite(x) for run in runs for x in first[run]["losses"] + first[run]["grad_norms"]):
        raise AssertionError(f"{label}: {first}")
    if first["ckpt"]["restored_on_one_card"] is not True:
        raise AssertionError(f"{label} (c): the checkpoint restored on one card: {first['ckpt']['restored_on_one_card']}")
    log(json.dumps({"train": label, "arch": TRAIN_OPTS["arch"], "mesh": {"pod": 1, "data": TRAIN_OPTS["data"],
                                                                        "model": TRAIN_OPTS["model"]},
                    "fsdp": False, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
                    "remat": "full", "steps": TRAIN_OPTS["steps"],
                    **{run: {k: first[run][k] for k in ("losses", "grad_norms")} for run in runs},
                    "step_seconds": {run: [rank[run]["step_seconds"] for rank in ranks] for run in runs},
                    "moment_bytes_by_rank": {run: [rank[run]["moment_bytes"] for rank in ranks]
                                             for run in ("plain", "zero1")},
                    "int8_joined_leaves": first["int8"]["joined"], "int8_local_leaves": first["int8"]["local"],
                    "ckpt_losses": first["ckpt"]["losses"], "ckpt_seconds": [rank["ckpt"]["seconds"] for rank in ranks],
                    "max_memory_allocated": [rank["max_memory_allocated"] for rank in ranks],
                    "wall_s": wall, "launches_by_rank": [rank["launches"] for rank in ranks], "card": smi_line()}))
    return {label: {name: sum(rank["launches"][name] for rank in ranks) for name in first["launches"]}}


def rank_train_opts(outdir: Path) -> int:
    """One rank of ``run_train_opts`` (under ``torchrun``): gates (a) and (b)
    on a ``make_lm_mesh(2, 2)`` through ``make_train_step``, then (c)
    through ``launch.train.main``; writes ``outdir/rank<RANK>.json``."""
    import gc
    import os

    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenSource, device_put_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_axes, make_lm_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.train import train_step as tstep
    from repro_torch.train.compression import compress_tree
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state, opt_state_specs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    arch, data, model_size, steps = (TRAIN_OPTS[k] for k in ("arch", "data", "model", "steps"))
    cfg = get_config(arch)
    no_fsdp = 1 << 62  # --fsdp-min-elems above every leaf: FSDP off
    result: dict = {}

    def tcfg(**kw) -> "tstep.TrainConfig":
        return tstep.TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=max(steps, 10)),
                                 microbatches=TRAIN_MICRO, **kw)

    def nbytes(tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors)

    with make_lm_mesh(data, model_size, "cuda") as mesh:
        dev = mesh.device
        src = SyntheticTokenSource(cfg, ShapeConfig("cli", TRAIN_SEQ, TRAIN_BATCH, "train"), DataConfig(seed=0))
        batches = [device_put_batch(src.batch_at(step), dev) for step in range(steps)]

        def drawn() -> "Model":
            m = Model(cfg, torch.float32, remat="full", ax=make_axes(mesh, TRAIN_BATCH), mesh=mesh, fsdp=1)
            m.init(torch.Generator(device=dev).manual_seed(0))
            return m

        def run(m, t) -> dict:
            step_fn, opt, params = tstep.make_train_step(m, t), tstep.init_state(m, t), m.params
            out = {"losses": [], "grad_norms": [], "step_seconds": [],
                   "moment_bytes": nbytes([*opt.m.values(), *opt.v.values()])}
            for batch in batches:
                t0 = sync_wall(torch)
                params, opt, metrics = step_fn(params, opt, batch)
                out["step_seconds"].append(sync_wall(torch) - t0)
                out["losses"].append(float(metrics["loss"]))
                out["grad_norms"].append(float(metrics["grad_norm"]))
            return out

        # (a) ZeRO-1 against none, and the moments' bytes of the zero1 blocks
        plain = drawn()
        result["plain"] = run(plain, tcfg())
        gc.collect()
        zero1 = drawn()
        result["zero1"] = run(zero1, tcfg(zero1=True))
        coords = {"data": (mesh.data_index, data), "model": (mesh.model_index, model_size)}
        specs = opt_state_specs(zero1.placed_specs(), zero1.ax, zero1=True).m
        shapes = zero1.param_shapes()

        def elems(spec_node, shape_node) -> int:
            if isinstance(spec_node, dict):
                return sum(elems(spec_node[k], shape_node[k]) for k in spec_node)
            return _gspmd_elems(shape_node, spec_node, coords)

        result["zero1"]["want_moment_bytes"] = 2 * elems(specs, shapes) * torch.float32.itemsize
        result["zero1"]["params_equal"] = all(
            torch.equal(plain.join_leaf(name, a.detach()), zero1.join_leaf(name, b.detach()))
            for (name, a), (_, b) in zip(plain.params.named_parameters(), zero1.params.named_parameters()))
        del plain, zero1
        gc.collect()
        torch.cuda.empty_cache()

        # (b) int8: step 0's gradients, joined, against one-card compress_tree of the joined gradients
        m = drawn()
        _, grads = tstep.accumulate_grads(m, batches[0], TRAIN_MICRO)
        joined, real = [], m.join_leaf

        def join_leaf(name, block):
            joined.append(name)
            return real(name, block)

        m.join_leaf = join_leaf
        compressed = tstep.compress_grads(m, grads, "int8")
        del m.join_leaf
        specs = m.leaf_specs()
        mismatched = [name for name, g in grads.items()
                      if not torch.equal(m.join_leaf(name, compressed[name]),
                                         compress_tree({name: m.join_leaf(name, g)}, "int8")[name])]
        local = sorted(name for name in grads if m.sh.cut_axes(specs[name]) and name not in joined)
        del grads, compressed
        result["int8"] = {**run(m, tcfg(compression="int8")), "mismatched": mismatched, "joined": len(joined),
                          "local": len(local)}
        del m
        gc.collect()
        torch.cuda.empty_cache()

    # (c) checkpoints through the launcher: 2 steps, --resume to 4, against 4 uninterrupted
    args = ["--arch", arch, "--no-reduced", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--microbatches",
            str(TRAIN_MICRO), "--remat", "full", "--lr", "1e-3", "--device", "cuda", "--seed", "0", "--quiet",
            "--data-shards", str(data), "--model-shards", str(model_size), "--fsdp-min-elems", str(no_fsdp)]
    ckpt_dir = str(outdir / "ckpt")
    t0 = time.perf_counter()
    first = train.main([*args, "--steps", "2", "--ckpt", ckpt_dir, "--ckpt-every", "2"])
    resumed = train.main([*args, "--steps", str(steps), "--ckpt", ckpt_dir, "--ckpt-every", "2", "--resume"])
    seconds = time.perf_counter() - t0
    result["ckpt"] = {"losses": first["losses"] + resumed["losses"], "seconds": seconds}
    del first
    result["ckpt"]["uninterrupted"] = train.main([*args, "--steps", str(steps)])["losses"]
    with make_lm_mesh(data, model_size, "cuda") as mesh:
        m = Model(cfg, torch.float32, remat="full", ax=make_axes(mesh, TRAIN_BATCH), mesh=mesh,
                  fsdp_min_elems=no_fsdp)
        whole = {name: m.join_leaf(name, p.detach()) for name, p in resumed["params"].named_parameters()}
        del resumed
        restored = None
        if os.environ["RANK"] == "0":
            one = Model(cfg, torch.float32)
            like = one.init(torch.Generator(device=mesh.device).manual_seed(1))
            (like, _), step = ckpt.restore(ckpt_dir, (like, init_opt_state(like, AdamWConfig())))
            got = dict(like.named_parameters())
            restored = step == steps and sorted(got) == sorted(whole) and all(
                torch.equal(got[name], whole[name]) for name in whole)
        result["ckpt"]["restored_on_one_card"] = restored
    result["launches"] = ops.launch_counts()
    result["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    (outdir / f"rank{os.environ['RANK']}.json").write_text(json.dumps(result))
    return 0


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
    "flash_attention[bf16]": (
        "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:102"),
    "mu_update_h[bf16]": ("src/repro_torch/kernels/csrc/nmf_update.cu", "src/repro/kernels/nmf_update.py:98"),
    "mu_update_w[bf16]": ("src/repro_torch/kernels/csrc/nmf_update.cu", "src/repro/kernels/nmf_update.py:129"),
    "silhouette_dist_sums[bf16]": (
        "src/repro_torch/kernels/csrc/silhouette_sums.cu", "src/repro/kernels/silhouette_sums.py:80"),
    "silhouette_dist_sums_batched[bf16]": (
        "src/repro_torch/kernels/csrc/silhouette_sums.cu", "src/repro/kernels/silhouette_sums.py:156"),
    "pairwise_sq_dists[bf16]": ("src/repro_torch/kernels/csrc/pairwise_dist.cu", "src/repro/kernels/pairwise_dist.py:48"),
    "pairwise_sq_dists_batched[bf16]": (
        "src/repro_torch/kernels/csrc/pairwise_dist.cu", "src/repro/kernels/pairwise_dist.py:103"),
}


def multi_rank_only() -> int:
    """``--multi-rank-only``, on a machine with 4 cards: build the kernels,
    run the world-1 searches the 4-rank ones are compared with (batched,
    sharded sync and elastic; twice, in turns), then only the multi-rank
    phase (``run_multi_rank_searches``, ``run_multi_rank_serves``,
    ``run_multi_rank_trains``, ``run_train_opts``)."""
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
    log(f"multi-rank searches: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path.update(run_multi_rank_serves(torch, dev, log))
    log(f"multi-rank serves: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path.update(run_multi_rank_trains(torch, log))
    log(f"multi-rank trains: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path.update(run_train_opts(torch, log))
    log(f"multi-rank training options: {time.perf_counter() - t0:.1f} s")
    log(smi_line())
    log(json.dumps(by_path))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--rank-search"]:  # one rank of run_multi_rank_searches
        return rank_search(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--rank-serve"]:  # one rank of run_multi_rank_serves
        return rank_serve(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--rank-train"]:  # one rank of run_multi_rank_trains
        return rank_train(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--rank-train-opts"]:  # one rank of run_train_opts
        return rank_train_opts(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--dry-run"]:  # the dry run's cells, on the host (run_dry_run)
        return dry_run(Path(sys.argv[2]))
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
    dry_deadline, dry_runs = time.perf_counter() + DRYRUN_TIMEOUT_S, []
    for multi in (False, True):  # one process a production mesh, both at once
        dry_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
        dry_runs.append((run_dry_run(dry_run_cells(multi), dry_dir), dry_dir))
        atexit.register(stop_process, *dry_runs[-1])
    for b in built.values():
        log(f"build {b.name}: {b.path.name} nvcc {b.seconds if b.seconds is None else round(b.seconds, 2)} s")
        for line in b.log.splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"  {line.strip()}")
    mu_lib = build.load("nmf_update")
    log("nmf_update dynamic shared memory (bytes) by rank bucket: " + json.dumps(
        {f"{upd}_kb{kb}{'_bf16' if elem == 2 else ''}": mu_lib.mu_dynamic_smem(i, kb, elem)
         for elem in (4, 2) for i, upd in enumerate("hw") for kb in (16, 32, 64, 128)}))

    records: dict[str, list] = {}
    check_mu(torch, dev, ops, ref, records, log)
    check_mu_bf16(torch, dev, ops, ref, records, log)
    check_sums(torch, dev, ops, ref, records, log)
    check_sums_bf16(torch, dev, ops, ref, records, log)
    check_pairwise(torch, dev, ops, ref, records, log)
    check_pairwise_bf16(torch, dev, ops, ref, records, log)
    check_flash(torch, dev, ops, ref, records, log)
    check_flash_bf16(torch, dev, ops, ref, records, log)
    check_nmfk_small(torch, dev, log)
    check_nmfk_elastic_small(torch, dev, ops, log)
    check_kmeans_small(torch, dev, ops, log)
    check_kmeans_small(torch, dev, ops, log, torch.bfloat16)
    check_lm_small(torch, dev, ops, log)
    check_train_small(torch, dev, ops, log)
    check_rescal_small(torch, dev, ops, log)
    check_rescal_small_bf16(torch, dev, ops, log)
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
    by_path.update(run_nmfk_bf16(torch, dev, ops, log))
    by_path.update(run_multi_rank_searches(torch, log))
    by_path.update(run_rescalk_searches(torch, dev, ops, log))
    by_path.update({f"kmeans_{ex}": run_kmeans_search(torch, dev, ops, ex, log) for ex in ("threads", "batched")})
    by_path.update(run_kmeans_bf16(torch, dev, ops, log))
    by_path["serve"] = run_serve(torch, dev, ops, serve, log, "qwen2-0.5b")
    by_path["qwen2_serve_bf16"] = run_serve_bf16(torch, dev, ops, log, "qwen2-0.5b")
    by_path["granite_serve"] = run_serve(torch, dev, ops, serve, log, "granite-moe-1b-a400m")
    by_path["deepseek_serve_2l"] = run_deepseek_serve(torch, dev, ops, log)
    by_path["rwkv6_serve"] = run_serve(torch, dev, ops, serve, log, "rwkv6-1.6b", SCAN_SERVE_PROMPT)
    by_path["jamba_serve_8l"] = run_jamba_serve(torch, dev, ops, log)
    by_path["jamba_serve_8l_bf16"] = run_serve_bf16(torch, dev, ops, log, "jamba-v0.1-52b", JAMBA_LAYERS,
                                                    SCAN_SERVE_PROMPT)
    by_path.update(run_multi_rank_serves(torch, dev, log))
    by_path.update(run_multi_rank_trains(torch, log))
    by_path.update(run_train_opts(torch, log))
    by_path["qwen2_train"] = run_train(torch, dev, ops, train, log, "qwen2-0.5b")
    by_path["granite_train"] = run_train(torch, dev, ops, train, log, "granite-moe-1b-a400m")
    by_path["rwkv6_train"] = run_train(torch, dev, ops, train, log, "rwkv6-1.6b")

    check_dry_run([dry_run_records(proc, path, dry_deadline) for proc, path in dry_runs], log)
    for label, counts in by_path.items():
        if "bf16" not in label:
            no_bf16_launch(counts, label)

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
