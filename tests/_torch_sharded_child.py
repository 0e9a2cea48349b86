"""Ranks of the port's sharded planes, for tests/test_torch_sharded.py.

    PYTHONPATH=src python tests/_torch_sharded_child.py WORLD INPUTS.npz OUTDIR [DTYPE]

Starts WORLD processes (``spawn``), joined in one gloo group through a
``file://`` store in OUTDIR. Every rank runs every case of its world size
on ``(lane, data)`` meshes of that world (``make_wave_mesh`` over the
default group) and writes its results to ``OUTDIR/rank<r>.npz`` and
``OUTDIR/rank<r>.json``; the test compares them with the port's
unsharded planes, run here on each rank, and with the reference. DTYPE
``bfloat16`` (``float32`` by default) runs the bf16 cases instead
(``_bf16_cases``): V and the reference's draws (bf16 values, handed over
widened to float32) cast to bf16; results widened to float32, their dtypes
in the JSON. Imports only ``repro_torch`` (no JAX, nothing of the
reference package).
"""
from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import sys
from pathlib import Path

JOIN_TIMEOUT_S = 240

# the meshes each world size runs: (lanes, data)
LANE_MESHES = {1: [(1, 1)], 2: [(2, 1)], 4: [(4, 1)]}
DATA_MESHES = {1: [], 2: [(1, 2)], 4: [(2, 2), (1, 4)]}
ELASTIC_DATA_MESHES = [(1, 2), (2, 2)]  # the data-sharded elastic plane runs sync on these
MESH_SHAPES = {1: [(1, 1), (None, 1)], 2: [(2, 1), (1, 2), (None, 2)], 4: [(4, 1), (2, 2), (1, 4), (None, 2)]}
# lanes of one batched data-sharded chunk: their k_eff and sweeps (the second lane is padding)
CHUNK_KEFF, CHUNK_STEPS = [4, 2, 9], [7, 0, 10]
BAD_MESHES = {1: [], 2: [(1, 1), (None, 3)], 4: [(1, 2), (3, 1), (4, 2), (None, 3)]}


def _draw_source(z, device, dtype=None):
    """The reference's draws of each k (at k_pad), handed over as arrays
    (cast to ``dtype`` when given)."""
    from repro_torch.convert import draws_from_reference
    from repro_torch.random import Draws

    index = {int(k): i for i, k in enumerate(z["ref_ks"])}

    def draw(k, k_draw):
        assert k_draw == int(z["k_pad"]), k_draw
        i = index[int(k)]
        d = draws_from_reference(z["ref_noise"][i], z["ref_w"][i], z["ref_h"][i], device=device)
        return d if dtype is None else Draws(*(t.to(dtype) for t in d))

    return draw


def _drain(plane) -> dict[int, float]:
    scores = {}
    while not plane.idle:
        scores.update(plane.tick())
    return scores


def _elastic(v, mesh=None, comm="sync", ks=(), **kw) -> dict:
    """Drain an elastic plane over ``ks``: its scores, sweep counts,
    warm-start hits and dispatch shapes."""
    from repro_torch.factorization.planes import NMFkElasticPlane

    plane = NMFkElasticPlane(v, mesh=mesh, comm=comm, **kw)
    for k in ks:
        plane.submit(k)
    scores = _drain(plane)
    return {"scores": scores, "sweeps": [plane.sweeps_run, plane.sweeps_saved, plane.sweeps_fixed_total],
            "warm_start_hits": plane.warm_cache.hits, "shapes": sorted(plane.shapes_dispatched)}


def _rank_main(rank: int, world: int, inputs: str, outdir: str, dtype_name: str = "float32") -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import binary_bleed_search
    from repro_torch.factorization.distributed import _dnmf_masked_chunk_local, _rows, shard_rows
    from repro_torch.factorization.nmfk import _dist_fits, _nmfk_score_masked_dist, nmfk_score_batched, nmfk_score_sharded
    from repro_torch.factorization.planes import KMeansBatchPlane, NMFkBatchPlane
    from repro_torch.factorization.synthetic import blob_data
    from repro_torch.launch import ksearch
    from repro_torch.launch.mesh import make_wave_mesh
    from repro_torch.random import stack_draws

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=(Path(outdir) / "store").as_uri(), world_size=world, rank=rank)
    try:
        if dtype_name != "float32":
            out, info = _bf16_cases(world, dict(np.load(inputs)), getattr(torch, dtype_name))
            np.savez(Path(outdir) / f"rank{rank}.npz", **{key: val.float().numpy() for key, val in out.items()})
            info["dtypes"] = {key: str(val.dtype) for key, val in out.items()}
            (Path(outdir) / f"rank{rank}.json").write_text(json.dumps(info))
            return
        z = dict(np.load(inputs))
        cfg = {key: int(z[key]) for key in ("k_pad", "iters", "k_true", "k_min", "k_max", "el_k_max", "el_chunk")}
        threshold = float(z["threshold"])
        ks = [int(k) for k in z["ref_ks"]]
        v = torch.from_numpy(z["v"])
        ref_source = _draw_source(z, "cpu")
        p = int(z["ref_noise"].shape[1])
        out: dict = {}
        info: dict = {"meshes": {}, "bad_meshes": {}}

        for lanes, data in MESH_SHAPES[world]:
            with make_wave_mesh(lanes, data, "cpu") as mesh:
                info["meshes"][f"{lanes}x{data}"] = [mesh.lane_count, mesh.data_count, mesh.lane_index,
                                                    mesh.data_index, str(mesh.device)]
        for lanes, data in BAD_MESHES[world]:
            try:
                with make_wave_mesh(lanes, data, "cpu"):
                    info["bad_meshes"][f"{lanes}x{data}"] = "made"
            except ValueError as err:
                info["bad_meshes"][f"{lanes}x{data}"] = str(err)

        # the unsharded port, on every rank: the batched scores and planes
        batched = nmfk_score_batched(v, ks, k_pad=cfg["k_pad"], nmf_iters=cfg["iters"], draws=ref_source)
        out.update({f"batched_{i}": field for i, field in enumerate(batched)})
        plane_kw = dict(n_perturbs=p, nmf_iters=cfg["iters"], k_pad=cfg["k_pad"], draws=ref_source)
        search_kw = dict(k_range=(cfg["k_min"], cfg["k_max"]), select_threshold=threshold, executor="batched")
        ref_search = binary_bleed_search(NMFkBatchPlane(v, **plane_kw), **search_kw)
        info["batched_search"] = [ref_search.k_optimal, sorted(ref_search.visited_ks),
                                  {r.k: r.score for r in ref_search.visits}]
        x, _ = blob_data(n=120, d=3, k_true=4, std=0.3, spread=8.0, seed=2, device="cpu")
        km_ks = [2, 3, 4, 5, 6, 7, 8, 8]
        km_plane = KMeansBatchPlane(x, seed=1, max_iters=20, k_pad=8)
        out["km_scores"] = torch.tensor(km_plane.evaluate_batch(km_ks))
        out["km_labels"] = km_plane.last_labels
        el_ks = list(range(cfg["k_min"], cfg["el_k_max"] + 1))
        el_kw = dict(n_perturbs=p, nmf_iters=cfg["iters"], k_pad=cfg["k_pad"], tol=0.0, chunk=cfg["el_chunk"],
                     draws=ref_source)

        def elastic(mesh=None, comm="sync"):
            return _elastic(v, mesh, comm, el_ks, **el_kw)

        info["elastic"] = elastic()

        for lanes, data in LANE_MESHES[world] + DATA_MESHES[world]:
            tag = f"{lanes}x{data}"
            with make_wave_mesh(lanes, data, "cpu") as mesh:
                for comm in ("sync", "pipelined") if data > 1 else ("sync",):
                    sc = nmfk_score_sharded(v, ks, mesh=mesh, k_pad=cfg["k_pad"], nmf_iters=cfg["iters"], comm=comm,
                                            draws=ref_source)
                    out.update({f"sharded_{tag}_{comm}_{i}": field for i, field in enumerate(sc)})
                    res = binary_bleed_search(NMFkBatchPlane(v, mesh=mesh, comm=comm, **plane_kw), **search_kw)
                    info[f"search_{tag}_{comm}"] = [res.k_optimal, sorted(res.visited_ks),
                                                    {r.k: r.score for r in res.visits}]
                if data == 1 or (lanes, data) in ELASTIC_DATA_MESHES:
                    info[f"elastic_{tag}_sync"] = elastic(mesh, "sync")
                if data == 1:
                    plane = KMeansBatchPlane(x, seed=1, max_iters=20, k_pad=8, mesh=mesh)
                    out[f"km_scores_{tag}"] = torch.tensor(plane.evaluate_batch(km_ks))
                    out[f"km_labels_{tag}"] = plane.last_labels
                else:
                    try:
                        KMeansBatchPlane(x, k_pad=8, mesh=mesh)
                        info[f"km_data_{tag}"] = "made"
                    except ValueError as err:
                        info[f"km_data_{tag}"] = str(err)
                    # the data-sharded body at this mesh's data count, one lane
                    v_l = shard_rows(v, mesh.data_group)
                    k, draws = cfg["k_true"], ref_source(cfg["k_true"], cfg["k_pad"])
                    for comm in ("sync", "pipelined"):
                        w_all, errs = _dist_fits(v_l, torch.tensor([k]), stack_draws([draws]), cfg["k_pad"],
                                                 mesh.data_group, comm, cfg["iters"])
                        out.update({f"dist{data}_{comm}_w": w_all[0], f"dist{data}_{comm}_errs": errs[0],
                                    f"dist{data}_{comm}_contiguous": torch.tensor(w_all.is_contiguous())})
                        sc = _nmfk_score_masked_dist(v_l, k, draws, cfg["k_pad"], mesh.data_group, comm, cfg["iters"])
                        out.update({f"dist{data}_{comm}_{i}": field for i, field in enumerate(sc)})
                        # a chunk of three lanes at once against each lane alone
                        lanes = (v_l * _rows(draws.noise, v_l.shape[0], mesh.data_group),
                                 _rows(draws.w, v_l.shape[0], mesh.data_group), draws.h,
                                 torch.tensor(CHUNK_KEFF), torch.tensor(CHUNK_STEPS))
                        together = _dnmf_masked_chunk_local(*lanes[:4], cfg["k_pad"], cfg["el_chunk"],
                                                            mesh.data_group, comm, lanes[4])
                        alone = [_dnmf_masked_chunk_local(*(part[i] for part in lanes[:4]), cfg["k_pad"],
                                                          cfg["el_chunk"], mesh.data_group, comm, lanes[4][i])
                                 for i in range(len(CHUNK_STEPS))]
                        for name, got, want in zip(("w", "h", "err"), together, zip(*alone)):
                            out[f"chunk{data}_{comm}_together_{name}"] = got
                            out[f"chunk{data}_{comm}_alone_{name}"] = torch.stack(want)
                        out[f"chunk{data}_{comm}_w0"] = lanes[1]

        # the k-search CLI: every rank runs it, rank 0 alone prints
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = ksearch.main(["--device", "cpu", "--executor", "sharded", "--n", str(z["v"].shape[0]),
                                "--m", str(z["v"].shape[1]), "--k-true", str(cfg["k_true"]),
                                "--k-max", str(cfg["k_max"]), "--n-perturbs", str(p),
                                "--nmf-iters", str(cfg["iters"])])
        info["ksearch"] = {key: res[key] for key in ("k_optimal", "visited", "scores", "mesh", "waves", "seconds")}
        info["ksearch_printed"] = printed.getvalue()

        np.savez(Path(outdir) / f"rank{rank}.npz", **{key: val.numpy() for key, val in out.items()})
        (Path(outdir) / f"rank{rank}.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()


# the bf16 cases' meshes by world size: lane-only, data-sharded, and those
# the data-sharded elastic plane and the 257-sweep plane run on
BF16_LANE_MESHES = {1: [(1, 1)], 2: [(2, 1)], 4: [(4, 1)]}
BF16_DATA_MESHES = {1: [], 2: [(1, 2)], 4: [(2, 2), (1, 4)]}
BF16_ELASTIC_MESHES = [(1, 2), (2, 2)]
BF16_LONG_MESHES = [(1, 2)]
LONG_CHUNKS = (257, 300)  # one chunk of 257 sweeps each: 257 rounds in bf16, 300 does not


def _bf16_cases(world: int, z: dict, dtype) -> tuple[dict, dict]:
    """The sharded planes at bf16 on this world's meshes, with the unsharded
    port at bf16 and at float32 (the same values widened) on every rank."""
    import torch

    from repro_torch.core import binary_bleed_search
    from repro_torch.factorization import planes
    from repro_torch.factorization.distributed import shard_rows
    from repro_torch.factorization.nmfk import _dist_fits, _nmfk_score_masked_dist, nmfk_score_batched, nmfk_score_sharded
    from repro_torch.factorization.planes import NMFkBatchPlane
    from repro_torch.launch.mesh import make_wave_mesh
    from repro_torch.random import stack_draws

    cfg = {key: int(z[key]) for key in ("k_pad", "iters", "k_true", "k_min", "k_max", "el_k_max", "el_chunk",
                                        "long_n", "long_m", "long_k_pad", "long_iters", "long_p")}
    ks = [int(k) for k in z["ref_ks"]]
    p = int(z["ref_noise"].shape[1])
    v = torch.from_numpy(z["v"]).to(dtype)
    sources = {"16": _draw_source(z, "cpu", dtype), "32": _draw_source(z, "cpu", torch.float32)}
    values = {"16": v, "32": v.float()}
    score_kw = dict(k_pad=cfg["k_pad"], nmf_iters=cfg["iters"], draws=sources["16"])
    plane_kw = dict(n_perturbs=p, **score_kw)
    search_kw = dict(k_range=(cfg["k_min"], cfg["k_max"]), select_threshold=float(z["threshold"]), executor="batched")
    el_ks = list(range(cfg["k_min"], cfg["el_k_max"] + 1))
    el_kw = dict(ks=el_ks, n_perturbs=p, nmf_iters=cfg["iters"], k_pad=cfg["k_pad"], tol=0.0, chunk=cfg["el_chunk"])
    out: dict = {}
    info: dict = {}

    def search(plane):
        res = binary_bleed_search(plane, **search_kw)
        return [res.k_optimal, sorted(res.visited_ks), {r.k: r.score for r in res.visits}]

    def long_plane(mesh, chunk):
        """The bf16 elastic plane at 257 sweeps in one chunk: scores, sweep
        counts and the pooled scores' errors with their dtype."""
        errs = []
        pooled = planes.elastic_pooled_score

        def keep(w_all, e, k_eff, k_pad):
            errs.append(e)
            return pooled(w_all, e, k_eff, k_pad)

        planes.elastic_pooled_score = keep
        try:
            got = _elastic(v_long, mesh, ks=range(2, cfg["long_k_pad"] + 1), n_perturbs=cfg["long_p"],
                           nmf_iters=cfg["long_iters"], k_pad=cfg["long_k_pad"], tol=0.0, chunk=chunk)
        finally:
            planes.elastic_pooled_score = pooled
        got["err_dtypes"] = sorted({str(e.dtype) for e in errs})
        return got, torch.stack(errs)

    # the unsharded port, on every rank: bf16, and float32 on the same values
    for tag in ("16", "32"):
        sc = nmfk_score_batched(values[tag], ks, k_pad=cfg["k_pad"], nmf_iters=cfg["iters"], draws=sources[tag])
        out.update({f"batched{tag}_{i}": field for i, field in enumerate(sc)})
        info[f"elastic{tag}"] = _elastic(values[tag], **{**el_kw, "draws": sources[tag]})
    info["batched_search"] = search(NMFkBatchPlane(v, **plane_kw))
    v_long = torch.from_numpy(z["v_long"]).to(dtype)

    for lanes, data in BF16_LANE_MESHES[world] + BF16_DATA_MESHES[world]:
        tag = f"{lanes}x{data}"
        with make_wave_mesh(lanes, data, "cpu") as mesh:
            for comm in ("sync", "pipelined") if data > 1 else ("sync",):
                sc = nmfk_score_sharded(v, ks, mesh=mesh, comm=comm, **score_kw)
                out.update({f"sharded_{tag}_{comm}_{i}": field for i, field in enumerate(sc)})
                if data > 1:
                    info[f"search_{tag}_{comm}"] = search(NMFkBatchPlane(v, mesh=mesh, comm=comm, **plane_kw))
            if (lanes, data) in BF16_ELASTIC_MESHES:
                info[f"elastic_{tag}_sync"] = _elastic(v, mesh, **{**el_kw, "draws": sources["16"]})
            if (lanes, data) in BF16_LONG_MESHES:
                for chunk in LONG_CHUNKS:
                    info[f"long_{tag}_{chunk}"], out[f"long_{tag}_{chunk}_errs"] = long_plane(mesh, chunk)
            if lanes == 1 and data > 1:  # the data-sharded body at this data count, one lane at k_true
                v_l = shard_rows(v, mesh.data_group)
                k, draws = cfg["k_true"], sources["16"](cfg["k_true"], cfg["k_pad"])
                for comm in ("sync", "pipelined"):
                    w_all, errs = _dist_fits(v_l, torch.tensor([k]), stack_draws([draws]), cfg["k_pad"],
                                             mesh.data_group, comm, cfg["iters"])
                    out.update({f"dist{data}_{comm}_w": w_all[0], f"dist{data}_{comm}_errs": errs[0]})
                    sc = _nmfk_score_masked_dist(v_l, k, draws, cfg["k_pad"], mesh.data_group, comm, cfg["iters"])
                    out.update({f"dist{data}_{comm}_{i}": field for i, field in enumerate(sc)})
    return out, info


def main(argv: list[str]) -> int:
    world, inputs, outdir = int(argv[0]), argv[1], argv[2]
    dtype_name = argv[3] if len(argv) > 3 else "float32"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(rank, world, inputs, outdir, dtype_name)) for rank in range(world)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(JOIN_TIMEOUT_S)
    codes = [proc.exitcode for proc in procs]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    if codes != [0] * world:
        print(f"sharded child FAILED world={world} exit codes {codes}")
        return 1
    print(f"sharded child OK world={world}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
