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
lanes). ``NMFkElasticPlane`` is the back end of the elastic executor
(``ElasticWavefrontScheduler``): convergence-gated fit-chunks over a pool
of lane slots.

Two dispatch modes, selected by ``mesh=``:

  * **single-device** (``mesh=None``, default): the padded wave runs as one
    batched fit on V's device.
  * **mesh-sharded**: a ``(lane, data)`` mesh from
    ``repro_torch.launch.mesh.make_wave_mesh``; one process per rank, each
    running the same search (SPMD). The wave is padded to a multiple of the
    lane count and split into contiguous lane blocks; each rank fits its own
    block and the scores are all-gathered over the lane group, so every rank
    sees the same floats and takes the same decisions. With ``data > 1``
    (NMFk planes only) each fit is also row-distributed over the data group
    (``factorization.distributed``'s all-reduced Gram sums). Under a mesh
    the dispatch spans go to the ``device:all`` track and each lane group's
    block to a ``lane`` span on ``device:{i}``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Sequence

import torch

from repro_torch.core.scoring import davies_bouldin_score_masked, silhouette_score_masked
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.random import (
    Draws,
    DrawSource,
    KMeansDrawSource,
    check_draws,
    seeded_draws,
    seeded_kmeans_draws,
)

from .batching import WarmStartCache, bucket_batch, next_pow2, round_up_multiple
from .distributed import check_comm, check_rows, overlap_model, ring_all_gather
from .kmeans import _kmeans_masked_assign, _kmeans_masked_chunk, _kmeans_masked_init, kmeans_batched
from .nmf import _masked_init, _masked_sweeps
from .nmfk import (
    _perturb,
    _pooled_w_score,
    elastic_chunk_sharded,
    elastic_lane_init,
    elastic_lane_warm_init,
    elastic_pooled_score,
    nmfk_score_sharded,
)


class _BatchPlaneBase:
    """Shared padding / bucketing / accounting for the batched planes."""

    def __init__(self, k_pad: int | None, mesh=None, comm: str = "sync"):
        check_comm(comm)
        self.k_pad = k_pad
        self.mesh = mesh
        self.comm = comm
        self.lane_count = mesh.lane_count if mesh is not None else 1
        self.data_count = mesh.data_count if mesh is not None else 1
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
            lanes=self.lane_count,
            bucket_min=self.lane_count,  # a wave below the lane count: one k a lane group
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

    def _lane_group(self):
        return self.mesh.lane_group if self.mesh is not None else None

    def _dispatch_track(self) -> str:
        return "device:all" if self.mesh is not None else "device:0"

    def _lane_block(self, padded: list[int]) -> list[int]:
        """This rank's contiguous block of the padded wave (all of it without a mesh)."""
        if self.mesh is None:
            return padded
        per = len(padded) // self.lane_count
        return padded[self.mesh.lane_index * per:(self.mesh.lane_index + 1) * per]

    def _emit_lane_spans(self, tracer, t0_us: float, padded: list[int], n_real: int, kind: str) -> None:
        """Retroactive per-lane-group spans: lane group i carried the
        contiguous block padded[i*per:(i+1)*per] for the whole dispatch."""
        if self.mesh is None or self.lane_count <= 1 or not tracer.enabled:
            return
        dur = max(tracer.now_us() - t0_us, 0.0)
        per = len(padded) // self.lane_count
        for i in range(self.lane_count):
            tracer.add_span("lane", t0_us, dur, track=f"device:{i}", kind=kind, ks=padded[i * per:(i + 1) * per],
                            n_real=max(0, min(n_real - i * per, per)), data_shards=self.data_count)

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
    ...)`` at V's dtype, the schedule of ``make_nmfk_evaluator`` — so the
    batched and threaded executors agree on the score landscape (exactly at
    k == k_pad, to init-draw noise below it).

    With ``mesh=`` each rank scores its lane block (``nmfk_score_sharded``):
    lane-only, the batched plane's bits; with a data axis each fit is also
    row-distributed (V's rows must divide by the data count), and
    ``comm="pipelined"`` overlaps its Gram reductions with the local
    W-update. Such dispatches publish the ``overlap_fraction`` gauge of
    ``overlap_model`` and, when tracing, modeled per-sweep spans.
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
        mesh=None,
        comm: str = "sync",
    ):
        super().__init__(k_pad, mesh, comm)
        if statistic not in ("min", "mean"):
            raise ValueError(f"statistic must be 'min' or 'mean', got {statistic!r}")
        check_rows(v, self.data_count)
        n, m = v.shape
        self.v = v
        self.nmf_iters = nmf_iters
        self.statistic = statistic
        self.draws = draws if draws is not None else seeded_draws(seed, n, m, n_perturbs, epsilon, v.device, v.dtype)

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

    _MAX_TRACE_SWEEPS = 16  # per-sweep modeled spans emitted per dispatch

    def _emit_overlap_telemetry(self, tracer, t0_us: float, k_pad: int) -> None:
        """Publish the pipelined schedule's comm/compute overlap.

        The sweeps' collectives are not timed one by one, so the spans are
        *modeled* (and marked so): the measured dispatch wall apportioned
        uniformly over the sweeps, the comm spans' lengths from
        ``overlap_model``. The ``overlap_fraction`` gauge (share of a
        sweep's comm hidden behind the local W-update) is always published;
        the spans only when tracing is on.
        """
        if self.comm != "pipelined" or self.data_count <= 1:
            return
        model = overlap_model(self.v.shape[0], self.v.shape[1], k_pad, self.data_count)
        get_metrics().set_gauge("overlap_fraction", model["overlap_fraction"])
        get_metrics().observe("overlap_fraction_hist", model["overlap_fraction"])
        if not tracer.enabled:
            return
        per = max(tracer.now_us() - t0_us, 0.0) / max(self.nmf_iters, 1)
        for i in range(min(self.nmf_iters, self._MAX_TRACE_SWEEPS)):
            t = t0_us + i * per
            tracer.add_span("sweep_compute", t, per, track="data:compute", sweep=i, modeled=True,
                            data_shards=self.data_count)
            tracer.add_span("gram_ring", t, per * model["comm_fraction"], track="data:comm", sweep=i,
                            modeled=True, overlap_fraction=model["overlap_fraction"])

    def evaluate_batch(self, ks: Sequence[int]) -> list[float]:
        tracer = get_tracer()
        padded, k_pad, n_real = self._pad_ks(ks)
        t0_us = tracer.now_us()
        # "fit" brackets the batched fit+score launches (and, under a mesh,
        # the scores' all-gather); "score" brackets the device->host read of
        # the silhouette statistics.
        with tracer.span("fit", track=self._dispatch_track(), kind="nmfk",
                         ks=[int(k) for k in ks], batch=len(padded), k_pad=k_pad, comm=self.comm):
            sc = nmfk_score_sharded(self.v, padded, mesh=self.mesh, k_pad=k_pad, nmf_iters=self.nmf_iters,
                                    comm=self.comm, draws=self.draws)
            scores = sc.min_silhouette if self.statistic == "min" else sc.mean_silhouette
        with tracer.span("score", track=self._dispatch_track(), kind="nmfk", batch=len(padded)):
            out = [float(s) for s in scores[:n_real].tolist()]
        self._emit_lane_spans(tracer, t0_us, padded, n_real, kind="nmfk")
        self._emit_overlap_telemetry(tracer, t0_us, k_pad)
        return out


class KMeansBatchPlane(_BatchPlaneBase):
    """K-Means Davies-Bouldin (minimize) or silhouette (maximize) per wave.

    Lane k draws ``draws(k, k_pad)`` — by default ``seeded_kmeans_draws(
    seed, ...)``, the schedule of ``kmeans(x, k, seed=seed)`` — and masked
    fits are draw-for-draw the per-k fits, so this plane matches a threaded
    K-Means evaluator score for score. x (n, d) is shared by every lane and
    never copied per lane. ``last_labels`` keeps the labels (b, n) of the
    last dispatch's lanes (under a mesh: this rank's block).

    ``mesh=`` splits the wave over the mesh's lane axis; x stays whole on
    every rank (K-Means has no Gram sums to reduce over row blocks, so a
    data axis above 1 is refused). The draws are per k, so every lane's
    labels and score are the unsharded plane's bits.
    """

    def __init__(
        self,
        x: torch.Tensor,
        seed: int = 0,
        score: str = "davies_bouldin",
        max_iters: int = 100,
        k_pad: int | None = None,
        draws: KMeansDrawSource | None = None,
        mesh=None,
    ):
        super().__init__(k_pad, mesh)
        if self.data_count > 1:
            raise ValueError("KMeansBatchPlane supports lane-only meshes (data axis must be 1)")
        if score not in ("davies_bouldin", "silhouette"):
            raise ValueError(f"score must be 'davies_bouldin' or 'silhouette', got {score!r}")
        self.x = x
        self.score = score
        self.max_iters = max_iters
        self.draws = draws if draws is not None else seeded_kmeans_draws(seed, x.shape[0], x.device)
        self.last_labels: torch.Tensor | None = None

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
        block = self._lane_block(padded)
        t0_us = tracer.now_us()
        with tracer.span("fit", track=self._dispatch_track(), kind="kmeans",
                         ks=[int(k) for k in ks], batch=len(padded), k_pad=k_pad):
            res = kmeans_batched(self.x, block, k_pad=k_pad, max_iters=self.max_iters, draws=self.draws)
        self.last_labels = res.labels
        # x stays unbatched (n, d): the card's kernels read it once for every
        # lane, and the CPU tiers broadcast it against the batched labels
        with tracer.span("score", track=self._dispatch_track(), kind=self.score, batch=len(padded)):
            scores = ring_all_gather(self._score(res.labels, block, k_pad), self._lane_group())
            out = [float(s) for s in scores[:n_real].tolist()]
        self._emit_lane_spans(tracer, t0_us, padded, n_real, kind="kmeans")
        return out


# ---------------------------------------------------------------------------
# elastic plane: continuous batching of (k, perturbation) fit-chunks
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Lane:
    """One occupied slot: a single perturbation fit of a single k."""

    k: int
    p: int
    done: int = 0  # MU sweeps applied so far
    prev_err: float = float("inf")  # rel_error at the previous chunk boundary


@dataclasses.dataclass
class _KTask:
    """Host-side lifecycle of one submitted k (its P perturbation lanes)."""

    draws: Draws | None  # the k's noise and init draws, until its last lane is slotted
    slotted: int = 0  # lanes slotted so far
    w_parts: dict = dataclasses.field(default_factory=dict)  # p -> (n, k_pad) W
    errs: dict = dataclasses.field(default_factory=dict)  # p -> final rel_error (0-d tensor)
    cancelled: bool = False
    scored: bool = False


class NMFkElasticPlane:
    """Convergence-gated chunked NMFk fits over a fixed pool of lane slots.

    The unit of dispatch is a *chunk* — up to ``chunk`` masked MU sweeps of
    every occupied lane, one batched fit at a fixed padded shape (each MU
    half-sweep is one kernel launch on the card) — instead of a whole wave
    of fixed-iteration fits. One lane is one (k, perturbation) fit. Between
    chunks, host-side:

      * **convergence gate** — a lane retires when its rel_error improved
        by less than ``tol`` over the last chunk (or its sweep budget
        ``nmf_iters`` is exhausted); the sweeps it didn't run are counted
        as ``sweeps_saved``;
      * **lane refill** — freed slots immediately drain queued
        (k, perturbation) lanes submitted by the scheduler, so the batch
        stays full while ks enter and leave at their own pace;
      * **warm starts** — a refilled lane seeds its W from the nearest
        completed k's factors via ``elastic_lane_warm_init`` (cold draw when
        the ``WarmStartCache`` has nothing within its window of 8 ks);
      * **eviction** — ``cancel(k)`` (the scheduler's reaction to a Binary
        Bleed prune) removes queued lanes and evicts in-flight ones
        mid-fit, crediting their remaining sweeps to ``sweeps_saved``.

    Lane (k, p) draws from ``draws(k, k_pad)`` (default: ``seeded_draws(
    seed, ...)`` at V's dtype, the batched plane's schedule; draws of
    another dtype raise ``TypeError`` at ``submit``). ``tol <= 0`` disables
    the gate: every lane runs exactly ``nmf_iters`` sweeps and (with
    ``warm_start=False``) reproduces the batched plane draw-for-draw.
    Accounting invariant: ``sweeps_run + sweeps_saved ==
    sweeps_fixed_total`` over any completed search, where
    ``sweeps_fixed_total`` counts ``n_perturbs * nmf_iters`` for every
    submitted k.

    The slots form ``lane_count`` equal blocks (one without a mesh).
    Occupied slots are kept compacted in a prefix of their block
    (retirement moves the block's last occupied lane into the freed slot),
    a refilled lane goes to the least occupied block (the first on ties),
    and each dispatch runs the same bucketed prefix (``bucket_batch`` pow2
    policy) of every block, so dispatch shapes stay O(log slots). Each slot
    keeps its lane's perturbed V, W, H and k on the device; slots never
    written are zeros, which the MU update keeps zero. A tick copies the
    per-lane sweep budgets to the device once and reads the lanes' errors
    back once.

    With ``mesh=`` (SPMD: one plane per rank, the same calls on every rank)
    the host side — queue, refill, retirement, warm cache, accounting — is
    replicated, and each rank keeps on its device only the slots of its
    lane block (with ``data > 1``, its rows of their V and W, H whole).
    Each tick advances the rank's block (``elastic_chunk_sharded``:
    row-distributed fits over the data group when ``data > 1``) and makes
    exactly one all-gather over the lane group, of the lanes' (rel_error,
    sweeps applied), so every rank takes the same decisions. A retiring
    lane's W is gathered over the data group, then over the lane group, so
    every rank scores the same ensembles and caches the same W for warm
    starts. The slot count must be a multiple of the lane count.
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
        tol: float = 1e-3,
        chunk: int = 25,
        slots: int | None = None,
        warm_start: bool = True,
        draws: DrawSource | None = None,
        mesh=None,
        comm: str = "sync",
    ):
        if statistic not in ("min", "mean"):
            raise ValueError(f"statistic must be 'min' or 'mean', got {statistic!r}")
        check_comm(comm)
        if k_pad is None:
            raise ValueError("NMFkElasticPlane needs an explicit k_pad (slots persist across ks)")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.mesh = mesh
        self.comm = comm
        self.lane_count = mesh.lane_count if mesh is not None else 1
        self.data_count = mesh.data_count if mesh is not None else 1
        check_rows(v, self.data_count)
        if slots is None:
            slots = round_up_multiple(next_pow2(max(2 * n_perturbs, self.lane_count)), self.lane_count)
        if slots < 1 or slots % self.lane_count:
            raise ValueError(f"slots={slots} must be a positive multiple of lane count {self.lane_count}")
        n, m = v.shape
        self.v = v
        self.n_perturbs = int(n_perturbs)
        self.nmf_iters = int(nmf_iters)
        self.statistic = statistic
        self.k_pad = int(k_pad)
        self.tol = float(tol)
        self.chunk = int(chunk)
        self.slots = int(slots)
        self.warm_start = bool(warm_start)
        self.warm_cache = WarmStartCache()
        self.draws = draws if draws is not None else seeded_draws(seed, n, m, n_perturbs, epsilon, v.device, v.dtype)
        # the tracer track of chunk, evict and warm_start records
        self.track = "device:all" if mesh is not None else "device:0"

        # this rank's block of slots (its rows of them under data > 1)
        self.block = self.slots // self.lane_count
        self._lane = mesh.lane_index if mesh is not None else 0
        n_l = n // self.data_count
        data_index = mesh.data_index if mesh is not None else 0
        self._rows = slice(data_index * n_l, (data_index + 1) * n_l)
        self._vp = torch.zeros((self.block, n_l, m), dtype=v.dtype, device=v.device)
        self._w = torch.zeros((self.block, n_l, self.k_pad), dtype=v.dtype, device=v.device)
        self._h = torch.zeros((self.block, self.k_pad, m), dtype=v.dtype, device=v.device)
        self._keff = torch.zeros((self.block,), dtype=torch.long, device=v.device)
        # every block's occupancy, replicated on every rank
        self._slot: list[list[_Lane | None]] = [[None] * self.block for _ in range(self.lane_count)]
        self._n_occ = [0] * self.lane_count
        self._queue: deque[tuple[int, int]] = deque()
        self._tasks: dict[int, _KTask] = {}
        self._ready: list[tuple[int, float]] = []

        # accounting (the invariant: run + saved == fixed_total)
        self.sweeps_run = 0
        self.sweeps_saved = 0
        self.sweeps_fixed_total = 0
        self.n_ticks = 0
        self.shapes_dispatched: set[tuple[int, int]] = set()
        self.last_lane_occupancy: float | None = None

    # -- scheduler surface -------------------------------------------------------
    @property
    def backlog(self) -> int:
        """Queued lanes not yet slotted (admission signal for the refiller)."""
        return len(self._queue)

    @property
    def idle(self) -> bool:
        return not self._queue and sum(self._n_occ) == 0 and not self._ready

    def inflight_ks(self) -> set[int]:
        """ks submitted but not yet scored or cancelled."""
        return {k for k, t in self._tasks.items() if not t.scored and not t.cancelled}

    def submit(self, k: int) -> None:
        """Enqueue the P perturbation lanes of k (slotted by the next tick)."""
        k = int(k)
        if k > self.k_pad:
            raise ValueError(f"k={k} exceeds plane k_pad={self.k_pad}")
        if k in self._tasks:
            raise ValueError(f"k={k} already submitted")
        draws = self.draws(k, self.k_pad)
        check_draws(self.v, draws)
        self._tasks[k] = _KTask(draws=draws)
        for p in range(self.n_perturbs):
            self._queue.append((k, p))
        self.sweeps_fixed_total += self.n_perturbs * self.nmf_iters
        get_metrics().inc("sweeps_fixed_total", self.n_perturbs * self.nmf_iters)

    def cancel(self, k: int) -> bool:
        """Evict k mid-flight (Binary Bleed pruned it): dequeue its pending
        lanes and free its occupied slots, crediting unspent sweeps."""
        k = int(k)
        task = self._tasks.get(k)
        if task is None or task.scored or task.cancelled:
            return False
        task.cancelled = True
        task.draws = None
        pending = sum(1 for kk, _ in self._queue if kk == k)
        if pending:
            self._queue = deque((kk, p) for kk, p in self._queue if kk != k)
            self._credit_saved(pending * self.nmf_iters)
        evicted = 0
        for b in range(self.lane_count):
            for j in range(self._n_occ[b] - 1, -1, -1):
                lane = self._slot[b][j]
                if lane is not None and lane.k == k:
                    self._credit_saved(self.nmf_iters - lane.done)
                    self._free_slot(b, j)
                    evicted += 1
        get_tracer().event("evict", track=self.track, k=k,
                           pending=pending, evicted=evicted)
        return True

    def tick(self) -> list[tuple[int, float]]:
        """Refill freed slots, advance every occupied lane one chunk, retire
        converged / budget-exhausted lanes; returns newly scored (k, score)."""
        tracer = get_tracer()
        metrics = get_metrics()
        self._refill()
        n_occ = sum(self._n_occ)
        if n_occ == 0:
            out, self._ready = self._ready, []
            return out
        self.n_ticks += 1
        lanes = self.lane_count
        per = bucket_batch(
            max(self._n_occ), cap=self.block,
            compiled=(b // lanes for b, kp in self.shapes_dispatched if kp == self.k_pad),
        )
        batch = per * lanes
        self.shapes_dispatched.add((batch, self.k_pad))
        steps_host = [
            min(self.chunk, self.nmf_iters - self._slot[b][j].done) if j < self._n_occ[b] else 0
            for b in range(lanes) for j in range(per)
        ]
        occupancy = n_occ / batch
        self.last_lane_occupancy = occupancy
        metrics.observe("lane_occupancy", occupancy)
        metrics.set_gauge("lane_occupancy", occupancy)
        with tracer.span(
            "chunk", track=self.track, kind="nmfk_elastic", batch=batch,
            n_occ=n_occ, k_pad=self.k_pad, sweeps=max(steps_host),
            ks=sorted({lane.k for block in self._slot for lane in block if lane is not None}),
        ):
            steps = torch.tensor(steps_host[self._lane * per:(self._lane + 1) * per], device=self.v.device)
            w_new, h_new, errs = elastic_chunk_sharded(
                self._vp[:per], self._w[:per], self._h[:per], self._keff[:per], steps,
                self.k_pad, self.chunk, self._data_group(), self.comm,
            )
            self._w[:per] = w_new
            self._h[:per] = h_new
            # the tick's one collective and one device read: every lane's
            # (rel_error, sweeps applied), in slot order, at float32 or wider
            # (a bf16 error widens exactly; a bf16 sweep count above 256
            # would round)
            wide = torch.promote_types(errs.dtype, torch.float32)
            report = ring_all_gather(torch.stack([errs.to(wide), steps.to(wide)], dim=1), self._lane_group())
            report_host = report.tolist()
        if [int(r[1]) for r in report_host] != steps_host:
            raise RuntimeError("the lane blocks' sweeps differ from the plan every rank shares")
        lane_errs = report[:, 0].to(errs.dtype)  # each lane's error at V's dtype, for the pooled score

        retire: list[tuple[int, int]] = []
        for b in range(lanes):
            for j in range(self._n_occ[b]):
                lane = self._slot[b][j]
                st = steps_host[b * per + j]
                lane.done += st
                self.sweeps_run += st
                metrics.inc("sweeps_run", st)
                err = report_host[b * per + j][0]
                converged = self._converged(lane, err)
                lane.prev_err = err
                if converged or lane.done >= self.nmf_iters:
                    if lane.done < self.nmf_iters:
                        self._credit_saved(self.nmf_iters - lane.done)
                    retire.append((b, j))
        if retire:
            w_retired = self._gather_retired(retire)
            for b, j in sorted(retire, reverse=True):
                self._finish_lane(self._slot[b][j], w_retired[(b, j)], lane_errs[b * per + j])
                self._free_slot(b, j)
        out, self._ready = self._ready, []
        return out

    # -- internals ---------------------------------------------------------------
    def _converged(self, lane: _Lane, err: float) -> bool:
        """The tol gate, after lane.done counts the chunk: the lane's rel_error
        (at V's dtype) improved by less than ``tol`` over it."""
        return self.tol > 0 and (lane.prev_err - err) < self.tol

    def _lane_group(self):
        return self.mesh.lane_group if self.mesh is not None else None

    def _data_group(self):
        return self.mesh.data_group if self.mesh is not None else None

    def _gather_retired(self, retire: list[tuple[int, int]]) -> dict[tuple[int, int], torch.Tensor]:
        """The whole W (n, k_pad) of every retiring lane, on every rank: each
        block's retiring slots (padded to the most any block retires), their
        rows gathered over the data group, then the blocks over the lane
        group. The result is a fresh tensor: compaction and refill may
        overwrite the slots, never the cached W."""
        by_block = [[j for b, j in retire if b == bb] for bb in range(self.lane_count)]
        most = max(len(js) for js in by_block)
        mine = by_block[self._lane]
        w = self._w[torch.tensor(mine + [0] * (most - len(mine)), device=self.v.device)]  # (most, n_l, k_pad)
        w = ring_all_gather(w.transpose(0, 1), self._data_group()).transpose(0, 1)  # (most, n, k_pad)
        w = ring_all_gather(w, self._lane_group())  # (lanes * most, n, k_pad)
        return {(b, j): w[b * most + i] for b, js in enumerate(by_block) for i, j in enumerate(js)}

    def _credit_saved(self, sweeps: int) -> None:
        if sweeps > 0:
            self.sweeps_saved += sweeps
            get_metrics().inc("sweeps_saved", sweeps)

    def _refill(self) -> None:
        metrics = get_metrics()
        while self._queue and sum(self._n_occ) < self.slots:
            k, p = self._queue.popleft()
            task = self._tasks[k]
            if task.cancelled:  # defensive: cancel() already dequeues
                continue
            b = min(range(self.lane_count), key=lambda bb: (self._n_occ[bb], bb))
            j = self._n_occ[b]
            src = self.warm_cache.nearest(k, p) if self.warm_start else None
            if src is not None:
                metrics.inc("warm_start_hits")
                get_tracer().event("warm_start", track=self.track, k=k, p=p, k_src=int(src[0]))
            if b == self._lane:
                self._init_slot(j, k, task.draws, p, src)
            self._slot[b][j] = _Lane(k=k, p=p)
            self._n_occ[b] += 1
            task.slotted += 1
            if task.slotted == self.n_perturbs:
                task.draws = None

    def _init_slot(self, j: int, k: int, d: Draws, p: int, src) -> None:
        """Write lane (k, p)'s perturbed V and (cold or warm) init into this
        rank's slot j: the whole-V init, of which the slot keeps its rows."""
        if self.data_count == 1:
            vp = self._vp[j]
            torch.mul(self.v, d.noise[p], out=vp)  # _perturb, written into the slot
        else:
            vp = _perturb(self.v, d.noise[p])
            self._vp[j] = vp[self._rows]
        if src is not None:
            w0, h0 = elastic_lane_warm_init(vp, k, d.w[p], d.h[p], src[1], src[0], self.k_pad)
        else:
            w0, h0 = elastic_lane_init(vp, k, d.w[p], d.h[p], self.k_pad)
        self._w[j] = w0[self._rows]
        self._h[j] = h0
        self._keff[j] = k

    def _free_slot(self, b: int, j: int) -> None:
        """Compact: move block b's last occupied lane into its freed slot j."""
        last = self._n_occ[b] - 1
        if j != last:
            if b == self._lane:
                self._vp[j] = self._vp[last]
                self._w[j] = self._w[last]
                self._h[j] = self._h[last]
                self._keff[j] = self._keff[last]
            self._slot[b][j] = self._slot[b][last]
        self._slot[b][last] = None
        self._n_occ[b] = last

    def _finish_lane(self, lane: _Lane, w_row: torch.Tensor, err: torch.Tensor) -> None:
        task = self._tasks[lane.k]
        task.w_parts[lane.p] = w_row
        task.errs[lane.p] = err
        self.warm_cache.put(lane.k, lane.p, w_row)
        if len(task.w_parts) < self.n_perturbs or task.cancelled:
            return
        w_all = torch.stack([task.w_parts[p] for p in range(self.n_perturbs)])
        errs = torch.stack([task.errs[p] for p in range(self.n_perturbs)])
        sc = elastic_pooled_score(w_all, errs, lane.k, self.k_pad)
        score = float(sc.min_silhouette if self.statistic == "min" else sc.mean_silhouette)
        task.scored = True
        task.w_parts.clear()  # the warm cache holds what future ks need
        self._ready.append((lane.k, score))


__all__ = ["NMFkBatchPlane", "KMeansBatchPlane", "NMFkElasticPlane"]
