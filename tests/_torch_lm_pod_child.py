"""Ranks of the port's LM on a ``(pod, data, model)`` mesh, and the dry run's
census on real ranks, for tests/test_torch_dryrun.py.

    PYTHONPATH=src python tests/_torch_lm_pod_child.py INPUTS.npz OUTDIR PODxDATAxMODEL [PODxDATAxMODEL ...]

For each mesh shape in turn, starts ``POD * DATA * MODEL`` processes
(``spawn``), joined in one gloo group through a ``file://`` store in
OUTDIR, and runs that shape's cases (``MESH_CASES``) inside them: at pod 2,
reduced jamba and granite with the reference's weights and batches from
INPUTS (``convert.model_params_from_reference``, placed as the mesh model
places them) give their loss and every gradient joined to whole in the
reference's tree (``accumulate_grads``, 2 microbatches, remat ``full``,
FSDP down to ``FSDP_MIN_ELEMS`` elements), and granite two steps of
``launch.train.main --pod-shards 2``; at ``2x1x2`` reduced jamba with the
reference's weights serves INPUTS' prompt greedily (``serve.decode.generate``),
and ``launch.serve.main --pod-shards 2`` serves its own. At ``1x2x2`` the
dry run's cell function (``launch.dryrun.measure``) runs ``CENSUS_CELLS``
on real CPU tensors, and each rank records the census. Each rank writes
``OUTDIR/<tag>/rank<r>.npz`` and ``rank<r>.json``. Imports only
``repro_torch`` (no JAX, nothing of the reference package).
"""
from __future__ import annotations

import json
import multiprocessing
import sys
from pathlib import Path

from _torch_lm_mesh_child import _flat, tree
from _torch_lm_train_mesh_child import case_config

JOIN_TIMEOUT_S = 240
B, L, MICRO = 8, 8, 2
FSDP_MIN_ELEMS = 1 << 10  # small enough that FSDP cuts the reduced models' larger leaves
CASES = {"jamba": "jamba-v0.1-52b", "granite": "granite-moe-1b-a400m"}  # granite's router aux weights raised
MESH_CASES = {(2, 2, 1): ["jamba", "granite"], (2, 1, 2): ["jamba", "granite"], (1, 2, 2): []}
LAUNCHED = ("granite",)  # the cases also trained through launch.train --pod-shards
TRAIN_STEPS = 2
TRAIN_ARGS = ["--device", "cpu", "--steps", str(TRAIN_STEPS), "--batch", str(B), "--seq", str(L),
              "--microbatches", str(MICRO), "--lr", "3e-3", "--remat", "full",
              "--fsdp-min-elems", str(FSDP_MIN_ELEMS), "--quiet"]
SERVE_B, SERVE_L, SERVE_STEPS = 4, 24, 6  # reduced jamba served at (2, 1, 2)
SERVE_ARGS = ["--device", "cpu", "--arch", "jamba-v0.1-52b", "--batch", str(SERVE_B), "--prompt-len", str(SERVE_L),
              "--tokens", str(SERVE_STEPS), "--quiet"]
# (arch, kind, seq, global batch) of the census, reduced, fp32, at (data 2, model 2)
CENSUS_CELLS = [("musicgen-large", "decode", 16, 4), ("musicgen-large", "train", 8, 4)]


def census_cell(arch: str, kind: str, seq: int, batch: int, mesh) -> dict:
    """``measure``'s record of a reduced census cell, fp32, at this rank of
    ``mesh``; on a fake group the step runs on ``meta``, on real ranks on
    the CPU."""
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    shape = ShapeConfig("census", seq, batch, kind)
    return dryrun.measure(dryrun.cell_model(reduced_config(get_config(arch)), shape, mesh, torch.float32), shape, mesh)


def _rank_main(rank: int, world: int, shape: tuple[int, int, int], inputs: str, outdir: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.convert import grads_to_reference, model_params_from_reference
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_axes, make_lm_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.serve.decode import decode_input_specs, generate
    from repro_torch.train.train_step import accumulate_grads

    torch.set_num_threads(1)
    pod, data, model_size = shape
    tag = "x".join(map(str, shape))
    out_dir = Path(outdir) / tag
    dist.init_process_group("gloo", init_method=(out_dir / "store").as_uri(), world_size=world, rank=rank)
    try:
        z = dict(np.load(inputs))
        out: dict = {}
        info: dict = {}
        with make_lm_mesh(data, model_size, "cpu", pod=pod) as mesh:
            info["coords"] = [mesh.pod_index, mesh.data_index, mesh.model_index]
            info["shape"] = mesh.shape
            for case in MESH_CASES[shape]:
                cfg = case_config(case, get_config, reduced_config)
                m = Model(cfg, remat="full", ax=make_axes(mesh, B), mesh=mesh, fsdp_min_elems=FSDP_MIN_ELEMS)
                m.params = model_params_from_reference(tree(z, f"params/{case}/"), cfg, "cpu", mesh, model=m)
                batch = {k: torch.from_numpy(z[f"batch/{case}/{k}"]).long() for k in ("tokens", "labels")}
                loss, grads = accumulate_grads(m, batch, MICRO)
                out[f"{case}/loss"] = loss
                out.update({f"{case}/grad/{k}": torch.from_numpy(v)
                            for k, v in _flat(grads_to_reference(grads, m)).items()})
                info[f"{case}/fsdp_leaves"] = len(m.fsdp_dims())
                if case in LAUNCHED:
                    res = train.main(["--arch", CASES[case], *TRAIN_ARGS, "--pod-shards", str(pod),
                                      "--data-shards", str(data), "--model-shards", str(model_size)])
                    info[f"{case}/train"] = {"losses": res["losses"], "grad_norms": res["grad_norms"],
                                             "microbatches": res["microbatches"], "mesh": res["mesh"]}
            if shape == (1, 2, 2):
                info["census"] = {f"{a}/{k}": census_cell(a, k, s, b, mesh)["collectives"]
                                  for a, k, s, b in CENSUS_CELLS}
            if shape == (2, 1, 2):  # greedy serving of the reference's jamba: each (pod, data) rank its rows
                cfg = reduced_config(get_config(CASES["jamba"]))
                m = Model(cfg, ax=make_axes(mesh, SERVE_B), mesh=mesh, fsdp=1)
                m.params = model_params_from_reference(tree(z, "params/jamba/"), cfg, "cpu", mesh)
                prompt = m.sh.cut(torch.from_numpy(z["serve/prompt"]).long(), decode_input_specs(m)["tokens"])
                out["serve/reference_weights"] = generate(m, prompt, SERVE_STEPS)
        if shape == (2, 1, 2):  # the launcher; each (pod, data) rank returns its rows
            res = serve.main([*SERVE_ARGS, "--pod-shards", str(pod), "--data-shards", str(data),
                              "--model-shards", str(model_size)])
            out["serve/tokens"] = res["tokens"]
            info["serve/mesh"] = res["mesh"]
        np.savez(out_dir / f"rank{rank}.npz", **{key: val.detach().numpy() for key, val in out.items()})
        (out_dir / f"rank{rank}.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()


def main(argv: list[str]) -> int:
    inputs, outdir, tags = argv[0], argv[1], argv[2:]
    ctx = multiprocessing.get_context("spawn")
    failed = []
    for tag in tags:
        shape = tuple(int(n) for n in tag.split("x"))
        world = shape[0] * shape[1] * shape[2]
        (Path(outdir) / tag).mkdir(parents=True, exist_ok=True)
        procs = [ctx.Process(target=_rank_main, args=(rank, world, shape, inputs, outdir)) for rank in range(world)]
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
            failed.append(f"{tag}: exit codes {codes}")
    if failed:
        print(f"lm pod child FAILED {failed}")
        return 1
    print(f"lm pod child OK {' '.join(tags)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
