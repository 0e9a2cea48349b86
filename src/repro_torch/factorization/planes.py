"""Batched evaluation planes: mask-padded multi-k fits behind ``EvalPlane``.

The back end of the wavefront executor
(``repro_torch.core.evalplane.WavefrontScheduler``): a whole frontier of k
values becomes ONE batched fit at a common padded rank — every (lane,
perturbation) fit on one leading axis, so each MU half-sweep of the wave
is one kernel launch on the card.

Shape discipline, kept from the reference: the rank axis is padded to a
fixed ``k_pad`` (pass the top of the search range) and the batch axis is
bucketed by ``repro_torch.factorization.batching.bucket_batch`` (pow2
rounding, reuse of an already-dispatched bucket). ``WavefrontScheduler(
max_wave=N)`` sets the plane's ``dispatch_cap`` so padding never exceeds an
explicit memory bound. ``shapes_dispatched`` records the distinct
(batch, k_pad) shapes.

Every dispatch observes ``lane_utilization`` (real lanes / dispatched
lanes). Mesh sharding and the elastic plane wait for later slices.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.scoring import davies_bouldin_score_masked, silhouette_score_masked
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.random import DrawSource, KMeansDrawSource, seeded_draws, seeded_kmeans_draws

from .batching import bucket_batch
from .kmeans import _kmeans_masked_assign, _kmeans_masked_chunk, _kmeans_masked_init, kmeans_batched
from .nmf import _masked_init, _masked_sweeps
from .nmfk import _perturb, _pooled_w_score, nmfk_score_batched


class _BatchPlaneBase:
    """Shared padding / bucketing / accounting for the batched planes."""

    def __init__(self, k_pad: int | None):
        self.k_pad = k_pad
        # dispatch cap (number of lanes per batch). WavefrontScheduler sets
        # this to its max_wave so batch padding never exceeds the
        # device-memory bound the cap was chosen for.
        self.dispatch_cap: int | None = None
        self.n_dispatches = 0
        self.n_evals = 0
        self.shapes_dispatched: set[tuple[int, int]] = set()
        self.last_lane_utilization: float | None = None

    def _pad_ks(self, ks: Sequence[int]) -> tuple[list[int], int, int]:
        ks = [int(k) for k in ks]
        if not ks:
            raise ValueError("evaluate_batch needs at least one k")
        k_pad = self.k_pad if self.k_pad is not None else max(ks)
        if k_pad < max(ks):
            raise ValueError(f"plane k_pad={k_pad} smaller than requested k={max(ks)}")
        n_real = len(ks)
        target = bucket_batch(
            n_real,
            cap=self.dispatch_cap,
            compiled=(b for b, kp in self.shapes_dispatched if kp == k_pad),
        )
        ks = ks + [ks[0]] * (target - n_real)
        self.n_dispatches += 1
        self.n_evals += n_real
        util = n_real / len(ks)
        self.last_lane_utilization = util
        get_metrics().observe("lane_utilization", util)
        self.shapes_dispatched.add((len(ks), k_pad))
        return ks, k_pad, n_real

    def _dispatch_track(self) -> str:
        return "device:0"

    # chunk size of the abortable scalar path; per-chunk sweep counts land
    # in ``last_scalar_sweeps``
    abort_chunk = 25
    last_scalar_sweeps: int | None = None

    def evaluate_one(self, k: int, should_abort=None) -> float:
        # Without an abort callback: one batched dispatch. With one, route
        # through the subclass's chunked scalar path so §III-D prunes
        # landing mid-fit actually stop the sweeps.
        if should_abort is not None:
            return self._evaluate_one_chunked(k, should_abort)
        return self.evaluate_batch([k])[0]

    def _evaluate_one_chunked(self, k: int, should_abort) -> float:
        # fallback for planes without a resumable fit: poll once up front
        # (a k pruned before dispatch costs nothing), then run the fused fit
        if should_abort():
            return float("nan")
        return self.evaluate_batch([k])[0]


class NMFkBatchPlane(_BatchPlaneBase):
    """NMFk stability scoring of a whole wave as one padded batched ensemble.

    Lane k draws from ``draws(k, k_pad)`` — by default ``seeded_draws(seed,
    ...)``, the schedule of ``make_nmfk_evaluator`` — so the batched and
    threaded executors agree on the score landscape (exactly at k == k_pad,
    to init-draw noise below it).
    """

    def __init__(
        self,
        v: torch.Tensor,
        seed: int = 0,
        n_perturbs: int = 8,
        nmf_iters: int = 150,
        epsilon: float = 0.015,
        statistic: str = "min",
        k_pad: int | None = None,
        draws: DrawSource | None = None,
    ):
        super().__init__(k_pad)
        if statistic not in ("min", "mean"):
            raise ValueError(f"statistic must be 'min' or 'mean', got {statistic!r}")
        n, m = v.shape
        self.v = v
        self.nmf_iters = nmf_iters
        self.statistic = statistic
        self.draws = draws if draws is not None else seeded_draws(seed, n, m, n_perturbs, epsilon, v.device)

    def _evaluate_one_chunked(self, k: int, should_abort) -> float:
        """Scalar NMFk with §III-D abort polling at chunk boundaries.

        Runs the k's perturbation ensemble ``abort_chunk`` masked sweeps at
        a time (sweep-for-sweep the batched fit when it runs to the end:
        chunks share ``_masked_sweeps``). If the abort fires between chunks,
        the remaining sweeps are never paid and the partial ensemble is
        scored as it is: Binary Bleed pruned this k, so its score only
        matters for accounting, never for ``k_optimal``. Aborts before the
        first chunk return NaN — a void score no threshold test selects.
        """
        k = int(k)
        k_pad = self.k_pad if self.k_pad is not None else k
        d = self.draws(k, k_pad)
        vp = _perturb(self.v, d.noise)  # (p, n, m)
        keff = torch.full((vp.shape[0],), k, device=vp.device)
        w, h = _masked_init(vp, keff, d.w, d.h, k_pad)
        done = 0
        errs = None
        self.last_scalar_sweeps = 0
        while done < self.nmf_iters:
            if should_abort():
                break
            step = min(self.abort_chunk, self.nmf_iters - done)
            w, h, errs = _masked_sweeps(vp, w, h, keff, k_pad, step)
            done += step
            self.last_scalar_sweeps = done * vp.shape[0]
        if errs is None:
            return float("nan")
        sc = _pooled_w_score(w[None], errs[None], keff[:1], k_pad)
        score = sc.min_silhouette if self.statistic == "min" else sc.mean_silhouette
        return float(score[0])

    def evaluate_batch(self, ks: Sequence[int]) -> list[float]:
        tracer = get_tracer()
        padded, k_pad, n_real = self._pad_ks(ks)
        # "fit" brackets the batched fit+score launches; "score" brackets
        # the device->host read of the silhouette statistics.
        with tracer.span("fit", track=self._dispatch_track(), kind="nmfk",
                         ks=[int(k) for k in ks], batch=len(padded), k_pad=k_pad):
            sc = nmfk_score_batched(
                self.v, padded, k_pad=k_pad, nmf_iters=self.nmf_iters, draws=self.draws
            )
            scores = sc.min_silhouette if self.statistic == "min" else sc.mean_silhouette
        with tracer.span("score", track=self._dispatch_track(), kind="nmfk", batch=len(padded)):
            return [float(s) for s in scores[:n_real].tolist()]


class KMeansBatchPlane(_BatchPlaneBase):
    """K-Means Davies-Bouldin (minimize) or silhouette (maximize) per wave.

    Lane k draws ``draws(k, k_pad)`` — by default ``seeded_kmeans_draws(
    seed, ...)``, the schedule of ``kmeans(x, k, seed=seed)`` — and masked
    fits are draw-for-draw the per-k fits, so this plane matches a threaded
    K-Means evaluator score for score. x (n, d) is shared by every lane and
    never copied per lane.
    """

    def __init__(
        self,
        x: torch.Tensor,
        seed: int = 0,
        score: str = "davies_bouldin",
        max_iters: int = 100,
        k_pad: int | None = None,
        draws: KMeansDrawSource | None = None,
    ):
        super().__init__(k_pad)
        if score not in ("davies_bouldin", "silhouette"):
            raise ValueError(f"score must be 'davies_bouldin' or 'silhouette', got {score!r}")
        self.x = x
        self.score = score
        self.max_iters = max_iters
        self.draws = draws if draws is not None else seeded_kmeans_draws(seed, x.shape[0], x.device)

    def _score(self, labels: torch.Tensor, ks: Sequence[int], k_pad: int) -> torch.Tensor:
        """Scores (b,) of labels (b, n) fitted at ks."""
        if self.score == "silhouette":
            return silhouette_score_masked(self.x, labels, k_pad)
        ks_t = torch.tensor([int(k) for k in ks], device=self.x.device)
        cluster_mask = torch.arange(k_pad, device=self.x.device)[None, :] < ks_t[:, None]
        return davies_bouldin_score_masked(self.x, labels, k_pad, cluster_mask=cluster_mask)

    def _evaluate_one_chunked(self, k: int, should_abort) -> float:
        """Scalar K-Means with abort polling between Lloyd chunks.

        Chunking changes nothing: ``_kmeans_masked_chunk`` halts on exactly
        the convergence condition of the whole fit, so an unaborted chunked
        fit reproduces the batch fit's centroids; the host stops early when
        delta clears tol. Aborts before the first chunk return NaN (void
        score).
        """
        k = int(k)
        k_pad = self.k_pad if self.k_pad is not None else k
        k_eff = torch.tensor(k, device=self.x.device)
        centers = _kmeans_masked_init(self.x, k_eff, self.draws(k, k_pad), k_pad)
        it = 0
        ran = False
        self.last_scalar_sweeps = 0
        while it < self.max_iters:
            if should_abort():
                break
            chunk = min(self.abort_chunk, self.max_iters - it)
            centers, delta, did = _kmeans_masked_chunk(self.x, centers, k_eff, k_pad, chunk)
            it += int(did)
            ran = True
            self.last_scalar_sweeps = it
            if float(delta) <= 1e-6:
                break
        if not ran:
            return float("nan")
        labels, _ = _kmeans_masked_assign(self.x, centers, k_eff, k_pad)
        return float(self._score(labels[None], [k], k_pad)[0])

    def evaluate_batch(self, ks: Sequence[int]) -> list[float]:
        tracer = get_tracer()
        padded, k_pad, n_real = self._pad_ks(ks)
        with tracer.span("fit", track=self._dispatch_track(), kind="kmeans",
                         ks=[int(k) for k in ks], batch=len(padded), k_pad=k_pad):
            res = kmeans_batched(self.x, padded, k_pad=k_pad, max_iters=self.max_iters, draws=self.draws)
        # x stays unbatched (n, d): the card's kernels read it once for every
        # lane, and the CPU tiers broadcast it against the batched labels
        with tracer.span("score", track=self._dispatch_track(), kind=self.score, batch=len(padded)):
            scores = self._score(res.labels, padded, k_pad)
            return [float(s) for s in scores[:n_real].tolist()]


__all__ = ["NMFkBatchPlane", "KMeansBatchPlane"]
