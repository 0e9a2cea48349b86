"""Binary Bleed k-search driver on the port — the paper end to end.

Builds the planted-rank V with ``nmf_data`` and selects the NMF rank with
Binary Bleed over NMFk scores, on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.ksearch --k-max 16 --k-true 5

Three executors:

  * ``threads`` (default): ``ThreadPoolScheduler`` over a scalar
    ``evaluate(k)``; each of ``--resources`` worker threads fits one k at a
    time (its perturbations as one batched fit). Pruning broadcasts flow
    through the coordinator — in-process, or a file journal (``--journal``)
    that makes the search restartable.
  * ``batched``: ``WavefrontScheduler`` over ``NMFkBatchPlane``; each wave
    of independent midpoints is one padded batched fit.
  * ``elastic``: ``ElasticWavefrontScheduler`` over ``NMFkElasticPlane``;
    continuous batching over fit-chunks of ``--fit-chunk`` sweeps. Lanes
    retire as soon as their fit converges (``--tol``; 0 runs every lane the
    full ``--nmf-iters``, the batched executor's fits draw for draw), freed
    slots refill from the worklist mid-stream, refilled ks warm-start from
    completed neighbors (``--warm-start``), and prunes evict in-flight ks
    between chunks:

      PYTHONPATH=src python -m repro_torch.launch.ksearch --executor elastic

``--distributed-fit`` (threads executor) adds the paper's distributed
mode: each worker leases its own one-rank process group ("resource") from
a ``SubmeshPool`` and runs ``distributed_nmf`` over it for every k it
evaluates (its result is not used; the score still comes from
``nmfk_score``). A single-process launch makes a one-rank default group
(NCCL on ``cuda``, gloo on ``cpu``, from a ``file://`` store in a temporary
directory) and ``--resources`` one-rank subgroups of it:

  PYTHONPATH=src python -m repro_torch.launch.ksearch --device cpu --distributed-fit --resources 2

``--device cpu`` runs the plain PyTorch versions of the kernels. The
reference's sharded executor (and ``--lanes``, ``--data-shards``,
``--comm``, ``--compile-cache``) is not ported yet; the parser refuses it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from repro_torch.core import (
    ElasticWavefrontScheduler,
    FileCoordinator,
    InProcessCoordinator,
    LaneRefillPolicy,
    ThreadPoolScheduler,
    WavefrontScheduler,
    make_space,
)
from repro_torch.device import resolve
from repro_torch.factorization.distributed import distributed_nmf, local_groups, shard_rows
from repro_torch.factorization.nmfk import make_nmfk_evaluator
from repro_torch.factorization.planes import NMFkBatchPlane, NMFkElasticPlane
from repro_torch.factorization.synthetic import nmf_data
from repro_torch.launch.mesh import SubmeshPool
from repro_torch.obs import NULL_TRACER, Metrics, Tracer, use_metrics, use_tracer
from repro_torch.random import init_draws, lane_generator


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.ksearch")
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--m", type=int, default=104)
    ap.add_argument("--k-true", type=int, default=5)
    ap.add_argument("--k-min", type=int, default=2)
    ap.add_argument("--k-max", type=int, default=16)
    ap.add_argument("--resources", type=int, default=4)
    ap.add_argument("--threshold", type=float, default=0.9)
    ap.add_argument("--early-stop", action="store_true")
    ap.add_argument("--stop-threshold", type=float, default=0.1)
    ap.add_argument("--order", default="pre", choices=["pre", "in", "post"])
    ap.add_argument("--n-perturbs", type=int, default=4)
    ap.add_argument("--nmf-iters", type=int, default=120)
    ap.add_argument("--journal", default=None, help="dir for FileCoordinator (restartable)")
    ap.add_argument("--distributed-fit", action="store_true",
                    help="threads executor: also run each k's NMF fit with distributed_nmf "
                    "over the worker's leased process group")
    ap.add_argument("--executor", default="threads", choices=["threads", "batched", "elastic"],
                    help="threads: one NMFk fit per k per worker thread; batched: "
                    "wavefront frontiers as one padded batched NMFk fit per wave; "
                    "elastic: continuous batching over fit-chunks — lanes retire "
                    "on per-fit convergence (--tol), freed slots refill from the "
                    "worklist, new ks warm-start from neighbors")
    ap.add_argument("--max-wave", type=int, default=None,
                    help="cap ks per batched dispatch (batched executor)")
    ap.add_argument("--tol", type=float, default=1e-3,
                    help="elastic convergence gate: a lane retires when its "
                    "rel_error improved by less than this over the last chunk "
                    "(chunk-size dependent; <= 0 disables the gate — every "
                    "lane then runs exactly --nmf-iters sweeps, reproducing "
                    "the batched executor draw-for-draw)")
    ap.add_argument("--fit-chunk", type=int, default=25,
                    help="elastic chunk size: MU sweeps per dispatch between "
                    "convergence checks / refills / abort polls")
    ap.add_argument("--warm-start", action=argparse.BooleanOptionalAction, default=True,
                    help="seed refilled elastic lanes from the nearest "
                    "completed k's W (column pad/truncate + re-normalize); "
                    "--no-warm-start cold-starts every lane")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the hand-written kernels; cpu their plain versions")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the data and of every rank's draws")
    ap.add_argument("--trace", default=None, metavar="OUT",
                    help="write a search trace: Chrome-trace/Perfetto JSON "
                    "(open at ui.perfetto.dev), or JSONL if OUT ends in .jsonl")
    ap.add_argument("--metrics", default=None, metavar="OUT",
                    help="write the metrics summary JSON (counters/gauges/"
                    "histograms + pruning-efficiency block)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def main(argv=None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    device = resolve(args.device)
    v, _, _ = nmf_data(n=args.n, m=args.m, k_true=args.k_true, seed=args.seed, device=device)
    space = make_space(
        (args.k_min, args.k_max),
        args.threshold,
        args.stop_threshold if args.early_stop else None,
    )
    # telemetry: a real tracer only when requested (NullTracer otherwise);
    # metrics are always on but scoped to this run
    tracer = Tracer() if args.trace else NULL_TRACER
    metrics = Metrics()
    with use_tracer(tracer), use_metrics(metrics):
        result, dt, extra = _run_search(args, ap, space, v)
    return _emit(args, result, dt, extra, tracer, metrics)


def _wall(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _run_search(args, ap, space, v):
    if args.executor == "elastic":
        if not args.quiet:
            for flag, used in (("--journal", args.journal),
                               ("--distributed-fit", args.distributed_fit),
                               ("--resources", args.resources != ap.get_default("resources")),
                               ("--max-wave", args.max_wave is not None)):
                if used:
                    print(f"note: {flag} is ignored by the elastic executor")
        plane = NMFkElasticPlane(
            v, args.seed, n_perturbs=args.n_perturbs, nmf_iters=args.nmf_iters,
            k_pad=args.k_max, tol=args.tol, chunk=args.fit_chunk, warm_start=args.warm_start,
        )
        sched = ElasticWavefrontScheduler(space, refill=LaneRefillPolicy(order=args.order))
        t0 = _wall(v.device)
        result = sched.run(plane)
        dt = _wall(v.device) - t0
        extra = {
            "ticks": sched.n_ticks,
            "dispatched_shapes": sorted(plane.shapes_dispatched),
            "tol": args.tol,
            "fit_chunk": args.fit_chunk,
            "warm_start": args.warm_start,
            "sweeps_run": plane.sweeps_run,
            "sweeps_saved": plane.sweeps_saved,
            "sweeps_fixed_total": plane.sweeps_fixed_total,
            "warm_start_hits": plane.warm_cache.hits,
            "lane_occupancy": plane.last_lane_occupancy,
        }
        return result, dt, extra
    if args.executor == "batched":
        if not args.quiet:
            ignored = (
                ("--journal", args.journal),
                ("--distributed-fit", args.distributed_fit),
                ("--order", args.order != "pre"),
                ("--resources", args.resources != ap.get_default("resources")),
            )
            for flag, used in ignored:
                if used:
                    print(f"note: {flag} is ignored by the batched executor")
        plane = NMFkBatchPlane(
            v, args.seed, n_perturbs=args.n_perturbs, nmf_iters=args.nmf_iters, k_pad=args.k_max,
        )
        sched = WavefrontScheduler(space, max_wave=args.max_wave)
        t0 = _wall(v.device)
        result = sched.run(plane)
        dt = _wall(v.device) - t0
        extra = {"waves": sched.n_dispatches, "dispatched_shapes": sorted(plane.shapes_dispatched)}
        return result, dt, extra
    visited: set[int] = set()
    if args.journal:
        coord = FileCoordinator(args.journal)
        bounds, visited = coord.replay(space.selects, space.stops)
        if visited and not args.quiet:
            print(f"restart: {len(visited)} k already journaled, bounds {bounds}")
    else:
        coord = InProcessCoordinator()
    evaluate = make_nmfk_evaluator(
        v, args.seed, n_perturbs=args.n_perturbs, nmf_iters=args.nmf_iters,
    )
    sched = ThreadPoolScheduler(space, args.resources, order=args.order, coordinator=coord)
    with contextlib.ExitStack() as stack:
        if args.distributed_fit:
            pool = SubmeshPool(stack.enter_context(local_groups(v.device, args.resources)))
            evaluate = _with_distributed_fit(evaluate, v, args.seed, args.nmf_iters, pool)
        t0 = _wall(v.device)
        result = sched.run(evaluate, skip=visited)
        dt = _wall(v.device) - t0
    return result, dt, {"resources": args.resources, "distributed_fit": args.distributed_fit}


def _with_distributed_fit(score, v, seed: int, iters: int, pool: SubmeshPool):
    """``score`` preceded by the paper's distributed-within-k NMF fit of k.

    The fit runs over the calling *worker's* leased group (a worker-identity
    resource: keying on k would put concurrent workers on one group), from
    the first draws of ``lane_generator(seed, k)``; its result is not used.
    """
    n, m = v.shape

    def evaluate(k: int, should_abort=None) -> float:
        group = pool.acquire()
        w_draw, h_draw = init_draws(lane_generator(seed, int(k), v.device), n, m, int(k))
        distributed_nmf(shard_rows(v, group), int(k), w_draw, h_draw, group, iters=iters)
        return score(k, should_abort)

    return evaluate


def _emit(args, result, dt, extra, tracer, metrics) -> dict:
    out = {
        "k_optimal": result.k_optimal,
        "k_true": args.k_true,
        "visited": sorted(result.visited_ks),
        "n_visited": result.n_visited,
        "n_candidates": result.n_candidates,
        "visit_fraction": round(result.visit_fraction, 3),
        "seconds": dt,
        "executor": args.executor,
        "device": args.device,
        **extra,
    }
    if args.trace:
        if args.trace.endswith(".jsonl"):
            n_ev = tracer.export_jsonl(args.trace)
        else:
            n_ev = tracer.export_perfetto(args.trace)
        out["trace"] = {"path": args.trace, "events": n_ev}
    if args.metrics:
        summary = metrics.summary()
        payload = {
            "summary": summary,
            "result": {
                "k_optimal": result.k_optimal,
                "n_visited": result.n_visited,
                "n_candidates": result.n_candidates,
                "visit_fraction": result.visit_fraction,
            },
            "seconds": dt,
            "executor": args.executor,
            "device": args.device,
        }
        with open(args.metrics, "w") as f:
            json.dump(payload, f, indent=1)
        out["metrics"] = {"path": args.metrics}
        sf = summary["search"]["visit_fraction"]
        if sf is not None and abs(sf - result.visit_fraction) > 1e-9 and not args.quiet:
            print(f"warning: metrics visit_fraction {sf:.3f} != "
                  f"result {result.visit_fraction:.3f}")
    if not args.quiet:
        print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
