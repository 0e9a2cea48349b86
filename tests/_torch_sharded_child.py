"""Ranks of the port's sharded planes, for tests/test_torch_sharded.py.

    PYTHONPATH=src python tests/_torch_sharded_child.py WORLD INPUTS.npz OUTDIR

Starts WORLD processes (``spawn``), joined in one gloo group through a
``file://`` store in OUTDIR. Every rank runs every case of its world size
on ``(lane, data)`` meshes of that world (``make_wave_mesh`` over the
default group) and writes its results to ``OUTDIR/rank<r>.npz`` and
``OUTDIR/rank<r>.json``; the test compares them with the port's
unsharded planes, run here on each rank, and with the reference. Imports
only ``repro_torch`` (no JAX, nothing of the reference package).
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


def _draw_source(z, device):
    """The reference's draws of each k (at k_pad), handed over as arrays."""
    from repro_torch.convert import draws_from_reference

    index = {int(k): i for i, k in enumerate(z["ref_ks"])}

    def draw(k, k_draw):
        assert k_draw == int(z["k_pad"]), k_draw
        i = index[int(k)]
        return draws_from_reference(z["ref_noise"][i], z["ref_w"][i], z["ref_h"][i], device=device)

    return draw


def _drain(plane) -> dict[int, float]:
    scores = {}
    while not plane.idle:
        scores.update(plane.tick())
    return scores


def _rank_main(rank: int, world: int, inputs: str, outdir: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import binary_bleed_search
    from repro_torch.factorization.distributed import _dnmf_masked_chunk_local, _rows, shard_rows
    from repro_torch.factorization.nmfk import _dist_fits, _nmfk_score_masked_dist, nmfk_score_batched, nmfk_score_sharded
    from repro_torch.factorization.planes import KMeansBatchPlane, NMFkBatchPlane, NMFkElasticPlane
    from repro_torch.factorization.synthetic import blob_data
    from repro_torch.launch import ksearch
    from repro_torch.launch.mesh import make_wave_mesh
    from repro_torch.random import stack_draws

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=(Path(outdir) / "store").as_uri(), world_size=world, rank=rank)
    try:
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
            plane = NMFkElasticPlane(v, mesh=mesh, comm=comm, **el_kw)
            for k in el_ks:
                plane.submit(k)
            scores = _drain(plane)
            return {"scores": scores, "sweeps": [plane.sweeps_run, plane.sweeps_saved, plane.sweeps_fixed_total],
                    "warm_start_hits": plane.warm_cache.hits, "shapes": sorted(plane.shapes_dispatched)}

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


def main(argv: list[str]) -> int:
    world, inputs, outdir = int(argv[0]), argv[1], argv[2]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(rank, world, inputs, outdir)) for rank in range(world)]
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
