#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. print the card (nvidia-smi name and power limit, torch device name);
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc,
     one process per source, all at once (build time and ``-Xptxas -v``:
     registers, shared memory, spills);
  3. hold each kernel wrapper against its plain PyTorch version on the card
     at the shapes of the main paths, with the tolerance stated, and time
     kernel, plain version, the card's bound and, where one PyTorch call
     computes the same function, that call (CUDA events, warmed up);
  4. hold the batched NMFk score, the K-Means + Davies-Bouldin search of
     ``tests/test_integration.py`` with a small K-Means silhouette wave, and
     the LM's prefill and greedy decode (qwen2-0.5b at full width cut to 2
     layers; reduced h2o-danube, whose window bites) on the card against the
     same computation on the CPU (plain versions, same draws and weights);
  5. run each main path with every launch count set to 0 just before it and
     read just after, asserting the answer and that the run went through
     its kernels: the paper-scale NMFk search (V 1000x1100, k_true 8,
     k 2..16, 4 perturbations, 120 sweeps) through the port's ``ksearch``
     on the ``batched`` and ``threads`` executors (k_optimal 8);
     ``kmeans_db_1m`` — Binary Bleed over K-Means with Davies-Bouldin on
     10^6 blob points (d 6, k_true 7, k 2..24) — on the scalar executor (two
     threads) and the batched one (k_optimal 7); then the port's ``serve``
     with qwen2-0.5b at its published widths (24 layers, random weights from
     seed 0), 4 prompts of 1000 tokens, 32 new tokens: one flash launch per
     layer, finite logits, and decode-step logits (plain attention over the
     cache) matching a flash prefill of the extended sequence.

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

# published H100 SXM peaks (NVIDIA data sheet): HBM3 and fp32 on CUDA cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

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

# the serve path: qwen2-0.5b at its published widths, weights from seed 0
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = "qwen2-0.5b", 4, 1000, 32
SERVE_ARGS = ["--arch", SERVE_ARCH, "--no-reduced", "--batch", str(SERVE_BATCH),
              "--prompt-len", str(SERVE_PROMPT), "--tokens", str(SERVE_TOKENS),
              "--device", "cuda", "--seed", "0", "--quiet"]

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


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def mu_problem(torch, dev, lanes: int, k_pad: int, k_effs):
    """Perturbed V per fit and a masked init, as a wave of NMFk fits has them."""
    from repro_torch.factorization.nmf import _masked_init
    from repro_torch.factorization.synthetic import nmf_data
    from repro_torch.random import make_draws, seeded_generator

    v, _, _ = nmf_data(1000, 1100, 8, seed=1, device=dev)
    d = make_draws(seeded_generator(7, dev), 1000, 1100, k_pad, lanes, 0.015)
    vp = (v * d.noise).contiguous()
    k_eff = torch.tensor(k_effs, device=dev)
    w, h = _masked_init(vp, k_eff, d.w, d.h, k_pad)
    return vp, w.contiguous(), h.contiguous(), k_eff


def check_mu(torch, dev, ops, ref, records: dict, log) -> None:
    lanes, n, m = 32, 1000, 1100
    cases = [
        ("k_pad=16, ks 9..16", 16, [9 + i // 4 for i in range(lanes)]),
        ("k_pad=13, ragged, ks 10..13", 13, [10 + (i // 4) % 4 for i in range(lanes)]),
    ]
    for label, k, k_effs in cases:
        v, w, h, k_eff = mu_problem(torch, dev, lanes, k, k_effs)
        dead = torch.arange(k, device=dev)[None, :] >= k_eff[:, None]  # (L, k) masked comps
        for name, fn, plain, out_of in (
            ("mu_update_h", ops.mu_update_h, ref.mu_update_h, "h"),
            ("mu_update_w", ops.mu_update_w, ref.mu_update_w, "w"),
        ):
            got, want = fn(v, w, h), plain(v, w, h)
            torch.cuda.synchronize()
            err = compare(torch, got, want, MU_TOL["rtol"], MU_TOL["atol"], f"{name} [{label}]")
            masked = got[dead] if out_of == "h" else got.transpose(1, 2)[dead]
            if masked.numel() and float(masked.abs().max()) != 0.0:
                raise AssertionError(f"{name} [{label}]: masked components are not exactly zero")
            entry = {"case": label, "shape": {"L": lanes, "n": n, "m": m, "k": k}, "max_abs_err": err}
            if k == 16:  # the main-path shape: time it
                n_bytes = 4 * lanes * (n * m + n * k + k * m + k * k + (k * m if out_of == "h" else n * k))
                flops = lanes * (2 * n * m * k + (2 * k * k * m + 3 * k * m if out_of == "h" else 2 * n * k * k + 3 * n * k))
                b_ms, b_by = bound_ms(n_bytes, flops)
                entry.update(
                    ms=time_ms(torch, lambda: fn(v, w, h)),
                    plain_ms=time_ms(torch, lambda: plain(v, w, h)),
                    bound_ms=b_ms, bound_by=b_by,
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
    d = 1000
    x, onehot = pooled_columns(torch, dev, 8, 4, 16, [9, 10, 11, 12, 13, 14, 15, 16], d)
    x2, onehot2 = pooled_columns(torch, dev, 1, 4, 13, [13], d)
    x2, onehot2 = x2[0], onehot2[0]
    for name, fn, args in (
        ("silhouette_dist_sums_batched", ops.silhouette_dist_sums_batched, (x, onehot)),
        ("silhouette_dist_sums", ops.silhouette_dist_sums, (x2, onehot2)),
    ):
        # Near-duplicate pooled columns make |x|^2 + |y|^2 - 2 x.y a
        # cancellation: in fp32 at d=1000 its rounding noise (~1e-6) reaches
        # ~1e-3 after sqrt in ANY fp32 evaluation order, the plain version's
        # included. So the kernel is held against the plain version run in
        # float64 on the same inputs, and the fp32 plain version's own gap
        # to it is reported beside.
        got = fn(*args)
        want = ref.silhouette_dist_sums(*(a.double() for a in args))
        plain32 = ref.silhouette_dist_sums(*args)
        torch.cuda.synchronize()
        err = compare(torch, got, want, SUMS_TOL["rtol"], SUMS_TOL["atol"], name)
        plain32_err = float((plain32.double() - want).abs().max())
        xx, oh = args
        b = xx.shape[0] if xx.dim() == 3 else 1
        n, k = xx.shape[-2], oh.shape[-1]
        n_bytes = 4 * b * (n * d + n * k + n * k)  # x (= y) read once, one-hot, out
        flops = b * (2 * n * n * d + 2 * n * d + 5 * n * n + 2 * n * n * k)
        b_ms, b_by = bound_ms(n_bytes, flops)
        entry = {
            "case": f"b={b}, points={n}, d={d}, k={k}", "max_abs_err": err,
            "plain_fp32_max_abs_err": plain32_err,
            "ms": time_ms(torch, lambda: fn(*args)),
            "plain_ms": time_ms(torch, lambda: ref.silhouette_dist_sums(*args)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        log(json.dumps({"check": name, **entry}))
        records.setdefault(name, []).append(entry)


def check_pairwise(torch, dev, ops, ref, records: dict, log) -> None:
    """Both pairwise wrappers at the K-Means main paths' shapes: 10^6 blob
    points (d 6) against 24 centroid slots with x shared by the lanes (lane
    stride 0) of a 1-lane and a 16-lane wave, and in 2-D; plus a ragged
    small case."""
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
    cases = (
        # Binary Bleed prunes one side of most waves, so the batched run's
        # waves mostly carry one lane: that shape first (the kernels line
        # reports the first timed case), then a full 16-lane wave
        ("pairwise_sq_dists_batched", ops.pairwise_sq_dists_batched, (x, y[:1]),
         f"b=1 lane, x shared (n={n}, d={d}), m={m}", True),
        ("pairwise_sq_dists_batched", ops.pairwise_sq_dists_batched, (x, y),
         f"b={b} lanes, x shared (n={n}, d={d}), m={m}", True),
        ("pairwise_sq_dists", ops.pairwise_sq_dists, (x, y[0]), f"n={n}, m={m}, d={d}", True),
        ("pairwise_sq_dists_batched", ops.pairwise_sq_dists_batched, (rng_x, rng_y),
         "ragged b=3, n=70, m=30, d=17", False),
    )
    for name, fn, (xx, yy), label, main in cases:
        got, want = fn(xx, yy), ref.pairwise_sq_dists(xx, yy)
        torch.cuda.synchronize()
        err = compare(torch, got, want, PAIRWISE_TOL["rtol"], PAIRWISE_TOL["atol"], f"{name} [{label}]")
        fp64_err = float((got.double() - ref.pairwise_sq_dists(xx.double(), yy.double())).abs().max())
        entry = {"case": label, "max_abs_err": err, "max_abs_err_vs_fp64": fp64_err}
        del got, want
        if main:
            lanes = yy.shape[0] if yy.dim() == 3 else 1
            n_x, n_y = xx.shape[-2], yy.shape[-2]
            x_bytes = xx.numel()  # a 2-D x is read once for every lane
            n_bytes = 4 * (x_bytes + yy.numel() + lanes * n_x * n_y)
            flops = lanes * n_x * n_y * (2 * d + 3) + 2 * xx.numel() + 2 * yy.numel()
            b_ms, b_by = bound_ms(n_bytes, flops)
            x_lib = xx.expand(lanes, n_x, d) if yy.dim() == 3 else xx
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
    """Batched NMFk on the card (kernels) vs on the CPU (plain), same draws."""
    from repro_torch.factorization.nmfk import nmfk_score_batched
    from repro_torch.factorization.synthetic import nmf_data
    from repro_torch.random import Draws, seeded_draws

    v, _, _ = nmf_data(96, 104, 5, seed=0, device=dev)
    ks = [2, 3, 4, 5, 6, 7, 8]
    card_draws = seeded_draws(0, 96, 104, 4, 0.015, dev)

    def cpu_draws(k, k_draw):
        return Draws(*(t.cpu() for t in card_draws(k, k_draw)))

    on_card = nmfk_score_batched(v, ks, k_pad=8, n_perturbs=4, nmf_iters=120, draws=card_draws)
    on_cpu = nmfk_score_batched(v.cpu(), ks, k_pad=8, n_perturbs=4, nmf_iters=120, draws=cpu_draws)
    for field in ("min_silhouette", "mean_silhouette"):
        gap = float((getattr(on_card, field).cpu() - getattr(on_cpu, field)).abs().max())
        if not gap <= NMFK_SIL_ATOL:
            raise AssertionError(f"NMFk {field}: card vs plain gap {gap:.3e} > {NMFK_SIL_ATOL}")
    rel = float(((on_card.rel_error.cpu() - on_cpu.rel_error) / on_cpu.rel_error).abs().max())
    if not rel <= NMFK_ERR_RTOL:
        raise AssertionError(f"NMFk rel_error: card vs plain relative gap {rel:.3e} > {NMFK_ERR_RTOL}")
    log(json.dumps({"check": "nmfk_score_batched card vs plain", "ks": ks,
                    "min_silhouette_card": on_card.min_silhouette.tolist(),
                    "min_silhouette_plain": on_cpu.min_silhouette.tolist(),
                    "rel_error_max_rel_gap": rel}))


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
    gap = max(abs(card_db[k] - cpu_db[k]) for k in card_db)
    log(json.dumps({"check": "kmeans + davies_bouldin search card vs plain", "k_optimal": card.k_optimal,
                    "visited": sorted(card.visited_ks), "db_card": card_db, "db_max_abs_gap": gap,
                    "launches": launches}))

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


def run_search(torch, ops, ksearch, executor: str, log) -> dict[str, int]:
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = ksearch.main(PAPER_ARGS + ["--executor", executor])
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(json.dumps({"search": executor, "k_optimal": out["k_optimal"], "visited": out["visited"],
                    "waves": out.get("waves"), "wall_s": out["seconds"],
                    "max_memory_allocated": peak, "launches": counts}))
    if out["k_optimal"] != 8:
        raise AssertionError(f"{executor}: k_optimal {out['k_optimal']} != 8")
    sums = "silhouette_dist_sums_batched" if executor == "batched" else "silhouette_dist_sums"
    for name in ("mu_update_h", "mu_update_w", sums):
        if counts[name] < 1:
            raise AssertionError(f"{executor}: kernel {name} was never launched on the main path")
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
    """The flash kernel at the serve path's prefill shape (qwen2-0.5b: B 4,
    Hq 14, Hk 2, L 1000, D 64, causal), at h2o-danube-1.8b's heads with its
    window (B 1, Hq 32, Hk 8, L 6000, D 80, window 4096: ragged, and the
    window skip bites) and on a small ragged non-causal case. Held against
    the fp32 plain version at the reference's tolerance; the errors of both
    against a float64 plain version are reported beside."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    cases = (
        ("qwen2-0.5b prefill: B 4, Hq 14, Hk 2, L 1000, D 64, causal", (4, 14, 2, 1000, 1000, 64), True, None, True),
        ("h2o-danube-1.8b heads: B 1, Hq 32, Hk 8, L 6000, D 80, causal, window 4096",
         (1, 32, 8, 6000, 6000, 80), True, 4096, True),
        ("ragged non-causal: B 2, Hq 6, Hk 3, Lq 70, Lk 45, D 17", (2, 6, 3, 70, 45, 17), False, None, False),
    )
    for label, (b, hq, hk, lq, lk, d), causal, window, timed in cases:
        q = torch.randn((b, hq, lq, d), device=dev, generator=gen)
        k = torch.randn((b, hk, lk, d), device=dev, generator=gen)
        v = torch.randn((b, hk, lk, d), device=dev, generator=gen)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        plain = ref.attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = compare(torch, got, plain, FLASH_TOL["rtol"], FLASH_TOL["atol"], f"flash_attention [{label}]")
        err64, plain_err64 = _plain_fp64_err(ref, q, k, v, got, plain, causal, window)
        entry = {"case": label, "max_abs_err": err, "max_abs_err_vs_fp64": err64,
                 "plain_fp32_max_abs_err_vs_fp64": plain_err64}
        del got, plain
        if timed:
            pairs = _live_pairs(lq, lk, causal, window)
            flops = 4 * b * hq * d * pairs  # q.k and p.v multiply-adds on the live pairs
            n_bytes = 4 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v read; out written
            b_ms, b_by = bound_ms(n_bytes, flops)
            if window is None:
                lib_kw = dict(is_causal=causal)
            else:  # SDPA takes a window only as an explicit mask
                i = torch.arange(lq, device=dev)
                lib_kw = dict(attn_mask=(i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window))
            entry.update(
                flops=flops, ms=time_ms(torch, lambda: ops.flash_attention(q, k, v, causal=causal, window=window)),
                plain_ms=time_ms(torch, lambda: ref.attention(q, k, v, causal=causal, window=window), reps=10),
                bound_ms=b_ms, bound_by=b_by,
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


def check_lm_small(torch, dev, ops, log) -> None:
    """The LM's prefill logits and 8 greedy tokens on the card (flash kernel)
    against the CPU (plain path), same weights, teacher-forced with the
    card's tokens: qwen2-0.5b at full width (vocab 151,936) cut to 2 layers,
    B 1, prompt 200; reduced h2o-danube-1.8b (window 16), B 2, prompt 40."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import setup
    from repro_torch.serve.decode import generate

    cpu = torch.device("cpu")
    cases = (
        ("qwen2-0.5b, full width, 2 layers", dataclasses.replace(get_config("qwen2-0.5b"), num_layers=2), 1, 200),
        ("h2o-danube-1.8b reduced, window 16", reduced_config(get_config("h2o-danube-1.8b")), 2, 40),
    )
    steps = 8
    for label, cfg, batch, plen in cases:
        cpu_model, prompt, _, _ = setup(cfg, batch, plen, cpu, seed=0)
        card_model = copy.deepcopy(cpu_model).to(dev)
        ops.reset_launch_counts()
        lg_card, c_card = card_model.prefill({"tokens": prompt.to(dev)}, cache_len=plen + steps)
        flash = ops.launch_counts()["flash_attention"]
        lg_cpu, c_cpu = cpu_model.prefill({"tokens": prompt}, cache_len=plen + steps)
        gaps = [compare(torch, lg_card.cpu(), lg_cpu, LOGIT_TOL["rtol"], LOGIT_TOL["atol"], f"{label}: prefill logits")]
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
        tokens = torch.cat(tokens, dim=1)
        if not torch.equal(generate(card_model, prompt.to(dev), steps=steps), tokens.to(torch.int32)):
            raise AssertionError(f"{label}: generate's greedy tokens differ from the teacher-forced loop's")
        if flash != cfg.num_layers:
            raise AssertionError(f"{label}: {flash} flash launches in one prefill of {cfg.num_layers} layers")
        log(json.dumps({"check": f"lm card vs plain: {label}", "batch": batch, "prompt": plen,
                        "logits_max_abs_gap": max(gaps), "tokens": tokens.tolist(),
                        "flash_launches_per_prefill": flash}))
        del card_model, c_card


def run_serve(torch, dev, ops, serve, log) -> dict[str, int]:
    """The serve path at full width; counts reset just before, read just
    after. Then a teacher-forced check with the same weights: decode-step
    logits (plain attention over the cache) against the last row of a flash
    prefill of the extended sequence."""
    from repro_torch.configs import get_config

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve.main(SERVE_ARGS)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = out["tokens"]
    new = SERVE_BATCH * (SERVE_TOKENS - 1)
    log(json.dumps({"serve": f"{SERVE_ARCH} full width", "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
                    "tokens": SERVE_TOKENS, "wall_s": out["seconds"], "prefill_s": out["prefill_s"],
                    "decode_s": out["decode_s"], "decode_tokens_per_s": new / out["decode_s"],
                    "tokens_per_s": SERVE_BATCH * SERVE_TOKENS / out["seconds"],
                    "max_memory_allocated": peak, "launches": counts, "sample": tokens[0].tolist()}))
    cfg = get_config(SERVE_ARCH)
    if tuple(tokens.shape) != (SERVE_BATCH, SERVE_TOKENS):
        raise AssertionError(f"serve: tokens of shape {tuple(tokens.shape)}")
    if counts["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"serve: {counts['flash_attention']} flash launches for one prefill of "
                             f"{cfg.num_layers} layers")

    model, prompt, _, _ = serve.setup(cfg, SERVE_BATCH, SERVE_PROMPT, dev, seed=0)
    lg, caches = model.prefill({"tokens": prompt}, cache_len=SERVE_PROMPT + 2)
    _decided(torch, lg[:, -1], tokens[:, 0])
    gaps = []
    for i in range(2):
        lg_dec, caches = model.decode_step(caches, tokens[:, i:i + 1], SERVE_PROMPT + i)
        seq = torch.cat([prompt, tokens[:, :i + 1].long()], dim=1)
        lg_full, _ = model.prefill({"tokens": seq})
        gaps.append(compare(torch, lg_dec, lg_full, LOGIT_TOL["rtol"], LOGIT_TOL["atol"],
                            f"serve: decode step {i} vs flash prefill of {seq.shape[1]} tokens"))
        _decided(torch, lg_dec[:, -1], tokens[:, i + 1])
    log(json.dumps({"check": "serve decode vs flash prefill, teacher-forced", "steps": 2,
                    "logits_max_abs_gap": max(gaps), "logits_max_abs": float(lg_full.abs().max())}))
    del model, caches
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


def main() -> int:
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
    from repro_torch.launch import ksearch, serve

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

    records: dict[str, list] = {}
    check_mu(torch, dev, ops, ref, records, log)
    check_sums(torch, dev, ops, ref, records, log)
    check_pairwise(torch, dev, ops, ref, records, log)
    check_flash(torch, dev, ops, ref, records, log)
    check_nmfk_small(torch, dev, log)
    check_kmeans_small(torch, dev, ops, log)
    check_lm_small(torch, dev, ops, log)

    by_path = {f"nmfk_{ex}": run_search(torch, ops, ksearch, ex, log) for ex in ("batched", "threads")}
    by_path.update({f"kmeans_{ex}": run_kmeans_search(torch, dev, ops, ex, log) for ex in ("threads", "batched")})
    by_path["serve"] = run_serve(torch, dev, ops, serve, log)

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
