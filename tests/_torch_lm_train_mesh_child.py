"""Ranks of the port's LM training on a ``(data, model)`` mesh, for tests/test_torch_lm_train_mesh.py.

    PYTHONPATH=src python tests/_torch_lm_train_mesh_child.py INPUTS.npz OUTDIR DATAxMODEL [DATAxMODEL ...]

For each mesh shape in turn, starts ``DATA * MODEL`` processes (``spawn``),
joined in one gloo group through a ``file://`` store in OUTDIR, and runs
every case of that shape inside them (``MESH_CASES``): with the reference's
weights from INPUTS (``convert.model_params_from_reference``, placed as the
mesh model places them, FSDP-widened over the data axis down to
``FSDP_MIN_ELEMS`` elements) the loss and every gradient of the case's
batch, joined back to whole tensors in the reference's tree, under remat
``none`` and ``full``; then three steps of ``launch.train.main`` on the mesh
under the remats of ``TRAIN_REMATS``; at ``(1, 4)`` the gradients of
``NARROWED`` again with every model-group gather's backward narrowing. On
``(2, 2)`` it also runs the refusals
(``--ckpt``, ``int8``, ZeRO-1 moments); on ``(2, 2)`` and ``(2, 1)`` sampled
serving (``launch.serve.main --temperature``) and a batch whose two data
blocks are the same prompts. Each rank writes ``OUTDIR/<DATA>x<MODEL>/rank<r>.npz``
and ``rank<r>.json``. Imports only ``repro_torch`` (no JAX, nothing of the
reference package).
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing
import sys
import tempfile
from pathlib import Path

from _torch_lm_mesh_child import _flat, tree

JOIN_TIMEOUT_S = 240
B, L = 8, 8
FSDP_MIN_ELEMS = 1 << 10  # small enough that FSDP cuts the reduced models' larger leaves
CASES = {"jamba": "jamba-v0.1-52b", "granite": "granite-moe-1b-a400m", "qwen2": "qwen2-0.5b",
         "qwen2_6h": "qwen2-0.5b", "deepseek": "deepseek-v2-236b", "rwkv": "rwkv6-1.6b"}
# qwen2 at 6 heads and 2 kv heads: at (1, 4) the sequence-parallel residual (L 8), at (2, 2) cut on heads
MESH_CASES = {(1, 4): ["jamba", "qwen2_6h", "deepseek", "rwkv"], (2, 2): ["jamba", "granite", "qwen2_6h", "deepseek",
                                                                          "rwkv"],
              (4, 1): ["jamba", "granite", "qwen2"], (2, 1): []}
# the cases whose gradients are taken again at (1, 4) with every model-group gather's backward narrowing
# (``Shard.gather`` without ``reduce``): the K/V gather of the sequence-parallel attention, MLA's q latent
NARROWED = ("qwen2_6h", "deepseek")
# granite's router aux weights raised, so that the aux loss's share of the router gradient is far above
# the gradient tolerance (a data-group sum whose backward is 1/data short shows)
AUX = dict(router_aux_weight=0.1, router_z_weight=0.01)
REMATS = ("none", "full")
TRAIN_REMATS = {"jamba": REMATS, "granite": ("full",), "qwen2": ("none",), "qwen2_6h": (), "deepseek": (),
                "rwkv": ()}  # the 3-step launcher runs
TRAIN_ARGS = ["--device", "cpu", "--steps", "3", "--batch", str(B), "--seq", str(L), "--microbatches", "2",
              "--lr", "3e-3", "--fsdp-min-elems", str(FSDP_MIN_ELEMS), "--quiet"]
SERVE_ARGS = ["--device", "cpu", "--arch", "jamba-v0.1-52b", "--batch", "4", "--prompt-len", "24", "--tokens", "8",
              "--temperature", "1.0", "--quiet"]


def case_config(case: str, get_config, reduced_config):
    cfg = reduced_config(get_config(CASES[case]))
    if case == "granite":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **AUX))
    if case == "qwen2_6h":
        cfg = dataclasses.replace(cfg, num_heads=6, num_kv_heads=2)
    return cfg


def _narrowed_grads(cfg, ref, batch, mesh):
    """The gradients, joined, with every ``Shard.gather`` over the model
    group keeping this rank's slice in its backward (no ``reduce``)."""
    from repro_torch.convert import grads_to_reference
    from repro_torch.models.layers import Shard

    real = Shard.gather
    Shard.gather = lambda self, t, dim, reduce=False: real(self, t, dim)
    try:
        _, grads, model = _grad_case(cfg, ref, batch, mesh, "none")
    finally:
        Shard.gather = real
    return _flat(grads_to_reference(grads, model))


def _grad_case(cfg, ref, batch, mesh, remat: str):
    """(loss, this rank's gradients, the model) of ``batch`` on the mesh."""
    from repro_torch.convert import model_params_from_reference
    from repro_torch.launch.mesh import make_axes
    from repro_torch.models.transformer import Model
    from repro_torch.train.train_step import accumulate_grads

    model = Model(cfg, remat=remat, ax=make_axes(mesh, B), mesh=mesh, fsdp_min_elems=FSDP_MIN_ELEMS)
    model.params = model_params_from_reference(ref, cfg, "cpu", mesh, model=model)
    loss, grads = accumulate_grads(model, batch, 1)
    return loss, grads, model


def _rank_main(rank: int, world: int, data: int, model_size: int, inputs: str, outdir: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.convert import grads_to_reference
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.serve.decode import generate
    from repro_torch.train import train_step as tstep

    torch.set_num_threads(1)
    tag = f"{data}x{model_size}"
    out_dir = Path(outdir) / tag
    dist.init_process_group("gloo", init_method=(out_dir / "store").as_uri(), world_size=world, rank=rank)
    try:
        z = dict(np.load(inputs))
        out: dict = {}
        info: dict = {}
        with make_lm_mesh(data, model_size, "cpu") as mesh:
            info["coords"] = [mesh.data_index, mesh.model_index]
            for case in MESH_CASES[(data, model_size)]:
                cfg = case_config(case, get_config, reduced_config)
                ref = tree(z, f"params/{case}/")
                batch = {k: torch.from_numpy(z[f"batch/{case}/{k}"]).long() for k in ("tokens", "labels")}
                runs = {}
                for remat in REMATS:
                    runs[remat] = _grad_case(cfg, ref, batch, mesh, remat)
                loss, grads, model = runs["none"]
                out[f"{case}/loss"] = loss
                specs = model.leaf_specs()
                info[f"{case}/fsdp_leaves"] = {name: [list(g.shape), list(specs[name])]
                                               for name, g in grads.items() if name in model.fsdp_dims()}
                info[f"{case}/remat_differs"] = sorted(
                    [name for name, g in grads.items() if not torch.equal(g, runs["full"][1][name])]
                    + (["loss"] if not torch.equal(loss, runs["full"][0]) else []))
                joined = _flat(grads_to_reference(grads, model))
                out.update({f"{case}/grad/{k}": torch.from_numpy(v) for k, v in joined.items()})
                if (data, model_size) == (1, 4) and case in NARROWED:
                    out.update({f"{case}/narrowed/{k}": torch.from_numpy(v)
                                for k, v in _narrowed_grads(cfg, ref, batch, mesh).items()})
                for remat in TRAIN_REMATS[case]:
                    res = train.main(["--arch", CASES[case], *TRAIN_ARGS, "--remat", remat,
                                      "--data-shards", str(data), "--model-shards", str(model_size)])
                    info[f"{case}/train/{remat}"] = {"losses": res["losses"], "grad_norms": res["grad_norms"],
                                                     "microbatches": res["microbatches"], "mesh": res["mesh"]}
            if (data, model_size) == (2, 2):  # the refusals on a cut mesh
                mesh_model = Model(case_config("jamba", get_config, reduced_config), mesh=mesh)
                with tempfile.TemporaryDirectory() as ckpt:
                    calls = {
                        "ckpt": lambda: train.main(["--arch", CASES["jamba"], *TRAIN_ARGS, "--ckpt", ckpt,
                                                    "--data-shards", "2", "--model-shards", "2"]),
                        "int8": lambda: tstep.make_train_step(mesh_model, tstep.TrainConfig(compression="int8")),
                        "zero1": lambda: tstep.make_train_step(mesh_model, tstep.TrainConfig(zero1=True)),
                    }
                    info["raises"] = {}
                    for what, call in calls.items():
                        try:
                            call()
                            info["raises"][what] = "ran"
                        except NotImplementedError as err:
                            info["raises"][what] = str(err)
        if data == 2:  # sampled serving
            res = serve.main([*SERVE_ARGS, "--data-shards", str(data), "--model-shards", str(model_size)])
            out["serve/tokens"] = res["tokens"]
            with make_lm_mesh(data, model_size, "cpu") as mesh:
                cfg = reduced_config(get_config("jamba-v0.1-52b"))
                model, _, _, gen = serve.setup(cfg, 4, 24, torch.device("cpu"), 0, mesh)
                # both data blocks hold the same two prompts
                same = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(3))
                out["serve/same_rows"] = generate(model, same, steps=8, temperature=1.0, generator=gen)

        np.savez(out_dir / f"rank{rank}.npz", **{key: val.detach().numpy() for key, val in out.items()})
        (out_dir / f"rank{rank}.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()


def main(argv: list[str]) -> int:
    inputs, outdir, shapes = argv[0], argv[1], argv[2:]
    ctx = multiprocessing.get_context("spawn")
    failed = []
    for shape in shapes:
        data, model_size = (int(n) for n in shape.split("x"))
        world = data * model_size
        (Path(outdir) / shape).mkdir(parents=True, exist_ok=True)
        procs = [ctx.Process(target=_rank_main, args=(rank, world, data, model_size, inputs, outdir))
                 for rank in range(world)]
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
            failed.append(f"{shape}: exit codes {codes}")
    if failed:
        print(f"lm train mesh child FAILED {failed}")
        return 1
    print(f"lm train mesh child OK {' '.join(shapes)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
