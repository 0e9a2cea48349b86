"""Binary Bleed k-search driver on the port — the paper end to end.

Builds the planted-rank V with ``nmf_data`` and selects the NMF rank with
Binary Bleed over NMFk scores, on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.ksearch --k-max 16 --k-true 5

Four executors:

  * ``threads`` (default): ``ThreadPoolScheduler`` over a scalar
    ``evaluate(k)``; each of ``--resources`` worker threads fits one k at a
    time (its perturbations as one batched fit). Pruning broadcasts flow
    through the coordinator — in-process, or a file journal (``--journal``)
    that makes the search restartable.
  * ``batched``: ``WavefrontScheduler`` over ``NMFkBatchPlane``; each wave
    of independent midpoints is one padded batched fit.
  * ``sharded``: the batched plane over a ``(lane, data)`` mesh of ranks
    (``make_wave_mesh``): each wave is split into ``--lanes`` blocks, one
    per lane group, and with ``--data-shards > 1`` every fit is also
    row-distributed over that many ranks (``--comm pipelined`` overlaps its
    Gram reductions with the local W-update). Without ``torchrun`` the mesh
    is one rank (a one-rank group on a ``file://`` store; NCCL on the card).
    On several cards, one process per card:

      torchrun --nproc-per-node 4 -m repro_torch.launch.ksearch --executor sharded --lanes 2 --data-shards 2

    Every rank makes V from ``--seed`` and runs the whole search (SPMD);
    each fits only its own part of a wave, and the scores are all-gathered
    over the lanes, so every rank takes the same decisions and returns the
    same dict (``seconds`` is the slowest rank's). Only rank 0 prints and
    writes ``--trace`` / ``--metrics`` (and reports them in its dict).
  * ``elastic``: ``ElasticWavefrontScheduler`` over ``NMFkElasticPlane``;
    continuous batching over fit-chunks of ``--fit-chunk`` sweeps. Lanes
    retire as soon as their fit converges (``--tol``; 0 runs every lane the
    full ``--nmf-iters``, the batched executor's fits draw for draw), freed
    slots refill from the worklist mid-stream, refilled ks warm-start from
    completed neighbors (``--warm-start``), and prunes evict in-flight ks
    between chunks. With ``--lanes`` or ``--data-shards > 1`` it runs on a
    mesh as ``sharded`` does:

      PYTHONPATH=src python -m repro_torch.launch.ksearch --executor elastic

``--distributed-fit`` (threads executor) adds the paper's distributed
mode: each worker leases its own one-rank process group ("resource") from
a ``SubmeshPool`` and runs ``distributed_nmf`` over it for every k it
evaluates (its result is not used; the score still comes from
``nmfk_score``). A single-process launch makes a one-rank default group
(NCCL on ``cuda``, gloo on ``cpu``, from a ``file://`` store in a temporary
directory) and ``--resources`` one-rank subgroups of it:

  PYTHONPATH=src python -m repro_torch.launch.ksearch --device cpu --distributed-fit --resources 2

``--device cpu`` runs the plain PyTorch versions of the kernels (and gloo
for the mesh). The reference's ``--compile-cache`` has no counterpart: there
is no jit cache to persist.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch
import torch.distributed as dist

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
from repro_torch.launch.mesh import SubmeshPool, make_wave_mesh
from repro_torch.obs import NULL_TRACER, Metrics, Tracer, get_metrics, use_metrics, use_tracer
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
    ap.add_argument("--executor", default="threads", choices=["threads", "batched", "sharded", "elastic"],
                    help="threads: one NMFk fit per k per worker thread; batched: "
                    "wavefront frontiers as one padded batched NMFk fit per wave; "
                    "sharded: those waves split over a (lane, data) mesh of ranks — "
                    "parallel over k across lanes, distributed within k when "
                    "--data-shards > 1; elastic: continuous batching over "
                    "fit-chunks — lanes retire on per-fit convergence (--tol), "
                    "freed slots refill from the worklist, new ks warm-start from "
                    "neighbors (on a mesh like sharded when --lanes or "
                    "--data-shards is given)")
    ap.add_argument("--max-wave", type=int, default=None,
                    help="cap ks per batched dispatch (batched/sharded executors)")
    ap.add_argument("--lanes", type=int, default=None,
                    help="lane-axis size of the mesh (default: the world size / "
                    "--data-shards); lanes x data-shards must be the world size")
    ap.add_argument("--data-shards", type=int, default=1,
                    help="data-axis size of the mesh: each lane's NMF fits "
                    "row-shard V over this many ranks (pyDNMFk mode)")
    ap.add_argument("--comm", default="sync", choices=["sync", "pipelined"],
                    help="collective schedule of the data-sharded fits: sync "
                    "blocks each MU sweep on the Gram all-reduces; pipelined "
                    "reduce-scatters them asynchronously and overlaps the "
                    "in-flight reduction with the local W-update (one-sweep-"
                    "stale H, closing sync sweep). Only meaningful on a mesh "
                    "with --data-shards > 1")
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


def _uses_mesh(args) -> bool:
    return args.executor == "sharded" or (
        args.executor == "elastic" and (args.lanes is not None or args.data_shards > 1))


def main(argv=None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    device = resolve(args.device)
    with contextlib.ExitStack() as stack:
        mesh = None
        if _uses_mesh(args):
            mesh = stack.enter_context(make_wave_mesh(args.lanes, args.data_shards, device))
            device = mesh.device
        # under a mesh every rank makes the same V from the seed
        v, _, _ = nmf_data(n=args.n, m=args.m, k_true=args.k_true, seed=args.seed, device=device)
        space = make_space(
            (args.k_min, args.k_max),
            args.threshold,
            args.stop_threshold if args.early_stop else None,
        )
        lead = (dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", 0))) == 0
        # telemetry: a real tracer only when requested (NullTracer otherwise);
        # metrics are always on but scoped to this run
        tracer = Tracer() if args.trace else NULL_TRACER
        metrics = Metrics()
        with use_tracer(tracer), use_metrics(metrics):
            result, dt, extra = _run_search(args, ap, space, v, mesh, lead)
        if mesh is not None:  # the search's wall is its slowest rank's
            slowest = torch.tensor(dt, dtype=torch.float64, device=device)
            dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
            dt = float(slowest)
    return _emit(args, result, dt, extra, tracer, metrics, lead)


def _wall(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _run_search(args, ap, space, v, mesh, lead: bool):
    quiet = args.quiet or not lead
    if args.executor == "elastic":
        if not quiet:
            for flag, used in (("--journal", args.journal),
                               ("--distributed-fit", args.distributed_fit),
                               ("--resources", args.resources != ap.get_default("resources")),
                               ("--max-wave", args.max_wave is not None)):
                if used:
                    print(f"note: {flag} is ignored by the elastic executor")
        plane = NMFkElasticPlane(
            v, args.seed, n_perturbs=args.n_perturbs, nmf_iters=args.nmf_iters,
            k_pad=args.k_max, tol=args.tol, chunk=args.fit_chunk, warm_start=args.warm_start,
            mesh=mesh, comm=args.comm,
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
        if mesh is not None:
            extra.update(_mesh_extra(plane, args.comm, plane.last_lane_occupancy))
        elif args.comm != "sync" and not quiet:
            print("note: --comm is ignored by the elastic executor without a mesh")
        return result, dt, extra
    if args.executor in ("batched", "sharded"):
        if not quiet:
            ignored = (
                ("--journal", args.journal),
                ("--distributed-fit", args.distributed_fit),
                ("--order", args.order != "pre"),
                ("--resources", args.resources != ap.get_default("resources")),
            )
            for flag, used in ignored:
                if used:
                    print(f"note: {flag} is ignored by the {args.executor} executor")
            if mesh is None and args.comm != "sync":
                print(f"note: --comm is ignored by the {args.executor} executor")
            elif mesh is not None and args.comm == "pipelined" and mesh.data_count <= 1:
                print("note: --comm pipelined is a no-op without --data-shards > 1")
        plane = NMFkBatchPlane(
            v, args.seed, n_perturbs=args.n_perturbs, nmf_iters=args.nmf_iters, k_pad=args.k_max,
            mesh=mesh, comm=args.comm,
        )
        sched = WavefrontScheduler(space, max_wave=args.max_wave)
        t0 = _wall(v.device)
        result = sched.run(plane)
        dt = _wall(v.device) - t0
        extra = {"waves": sched.n_dispatches, "dispatched_shapes": sorted(plane.shapes_dispatched)}
        if mesh is not None:
            extra.update(_mesh_extra(plane, args.comm, plane.last_lane_utilization))
        return result, dt, extra
    visited: set[int] = set()
    if args.journal:
        coord = FileCoordinator(args.journal)
        bounds, visited = coord.replay(space.selects, space.stops)
        if visited and not quiet:
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


def _mesh_extra(plane, comm: str, utilization: float | None) -> dict:
    """The mesh entries of a sharded run's result (``utilization``: the last
    dispatch's share of real lanes)."""
    extra = {"mesh": {"lanes": plane.lane_count, "data": plane.data_count},
             "lane_utilization_last": utilization, "comm": comm}
    if comm == "pipelined" and plane.data_count > 1 and get_metrics().gauge("overlap_fraction") is not None:
        extra["overlap_fraction"] = get_metrics().gauge("overlap_fraction")
    return extra


def _with_distributed_fit(score, v, seed: int, iters: int, pool: SubmeshPool):
    """``score`` preceded by the paper's distributed-within-k NMF fit of k.

    The fit runs over the calling *worker's* leased group (a worker-identity
    resource: keying on k would put concurrent workers on one group), from
    the first draws of ``lane_generator(seed, k)`` at V's dtype; its result
    is not used.
    """
    n, m = v.shape

    def evaluate(k: int, should_abort=None) -> float:
        group = pool.acquire()
        w_draw, h_draw = init_draws(lane_generator(seed, int(k), v.device), n, m, int(k), dtype=v.dtype)
        distributed_nmf(shard_rows(v, group), int(k), w_draw, h_draw, group, iters=iters)
        return score(k, should_abort)

    return evaluate


def _emit(args, result, dt, extra, tracer, metrics, lead: bool = True) -> dict:
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
        "scores": {rec.k: rec.score for rec in sorted(result.visits, key=lambda rec: rec.k)},
        **extra,
    }
    if not lead:  # rank 0 alone writes and prints
        return out
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
