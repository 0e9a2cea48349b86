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
``NARROWED`` again with every model-group gather's backward narrowing, and
the loss's forward and backward of ``CUT_LOSS`` under a dispatch mode that
records every tensor as wide as the vocabulary. At ``ZERO1_MESHES`` three
steps of ``ZERO1``'s model (FSDP off) with ZeRO-1 moments and without; at
``(2, 2)`` also the FSDP combination's refusal, ``int8`` compression of
jamba's and that model's gradients (``compress_grads``: which leaves it
joined), the ZeRO-1 state's checkpoint, and jamba's checkpoints through
``launch.train.main --ckpt`` (one step, then ``--resume`` to three; the
one-card ``save`` of the joined state; a restore at ``(1, 4)`` on the same
ranks). On ``(2, 2)`` and ``(2, 1)`` sampled serving
(``launch.serve.main --temperature``) and a batch whose two data blocks
are the same prompts. Each rank writes ``OUTDIR/<DATA>x<MODEL>/rank<r>.npz``
and ``rank<r>.json``; the checkpoints go under ``OUTDIR/<DATA>x<MODEL>/``.
Imports only ``repro_torch`` (no JAX, nothing of the reference package).
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing
import sys
from pathlib import Path

from _torch_lm_mesh_child import _flat, tree

JOIN_TIMEOUT_S = 240
B, L = 8, 8
FSDP_MIN_ELEMS = 1 << 10  # small enough that FSDP cuts the reduced models' larger leaves
CASES = {"jamba": "jamba-v0.1-52b", "granite": "granite-moe-1b-a400m", "qwen2": "qwen2-0.5b",
         "qwen2_6h": "qwen2-0.5b", "deepseek": "deepseek-v2-236b", "rwkv": "rwkv6-1.6b",
         "internvl2": "internvl2-1b"}
# qwen2 at 6 heads and 2 kv heads: at (1, 4) the sequence-parallel residual (L 8), at (2, 2) cut on heads;
# internvl2 (tied) at a vocabulary of 510, which 4 does not divide: its table is whole at (1, 4) and each
# rank takes its 128 (the last 126) columns of the logits
MESH_CASES = {(1, 4): ["jamba", "qwen2_6h", "deepseek", "rwkv", "internvl2"],
              (2, 2): ["jamba", "granite", "qwen2_6h", "deepseek", "rwkv"],
              (4, 1): ["jamba", "granite", "qwen2"], (2, 1): []}
# the training loss at (1, 4) never holds a tensor as wide as the vocabulary: a cut table and a whole one
CUT_LOSS = ("qwen2_6h", "internvl2")
VOCAB = {"internvl2": 510}
# ZeRO-1: reduced qwen2 cut to 3 layers (a repeat axis of 3 over 2 and 4 data ranks) at a vocabulary of
# 509 (a whole table at model 2, whose ZeRO-1 moments cut its 509 rows over data as 255 and 254), FSDP off
ZERO1 = dict(arch="qwen2-0.5b", num_layers=3, vocab_size=509)
ZERO1_STEPS = 3
ZERO1_MESHES = ((2, 1), (2, 2), (4, 1))
# the cases whose gradients are taken again at (1, 4) with every model-group gather's backward narrowing
# (``Shard.gather`` without ``reduce``): the K/V gather of the sequence-parallel attention, MLA's q latent
NARROWED = ("qwen2_6h", "deepseek")
# granite's router aux weights raised, so that the aux loss's share of the router gradient is far above
# the gradient tolerance (a data-group sum whose backward is 1/data short shows)
AUX = dict(router_aux_weight=0.1, router_z_weight=0.01)
REMATS = ("none", "full")
TRAIN_REMATS = {"jamba": REMATS, "granite": ("full",), "qwen2": ("none",), "qwen2_6h": (), "deepseek": (),
                "rwkv": (), "internvl2": ()}  # the 3-step launcher runs
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
    if case in VOCAB:
        cfg = dataclasses.replace(cfg, vocab_size=VOCAB[case])
    return cfg


def zero1_config(get_config, reduced_config):
    return dataclasses.replace(reduced_config(get_config(ZERO1["arch"])), num_layers=ZERO1["num_layers"],
                               vocab_size=ZERO1["vocab_size"])


def zero1_batches(vocab: int):
    """The ZeRO-1 runs' batches, one a step, drawn from a seed."""
    import torch

    gen = torch.Generator().manual_seed(7)
    out = []
    for _ in range(ZERO1_STEPS):
        toks = torch.randint(0, vocab, (B, L + 1), generator=gen)
        out.append({"tokens": toks[:, :L], "labels": toks[:, 1:]})
    return out


def _wide_outputs(model, batch, vocab: int) -> list[str]:
    """The ops of ``model.loss_fn``'s forward and backward on ``batch`` whose
    output's last dimension is ``vocab`` wide."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Watch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.wide = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.dim() and t.shape[-1] == vocab:
                    self.wide.append(f"{func} {tuple(t.shape)}")
            return out

    model.params.requires_grad_(True)
    with Watch() as watch, torch.enable_grad():
        model.loss_fn(batch).backward()
    return watch.wide


def _zero1_runs(cfg, mesh, root: Path, out: dict, info: dict) -> None:
    """Three steps of ``make_train_step`` with ZeRO-1 moments and without
    (FSDP off): losses, norms, joined parameters; the moments' elements a
    rank. At (2, 2) also ``int8`` (the joined leaves) and the ZeRO-1 state's
    checkpoint beside the plain one's."""
    import torch

    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.launch.mesh import make_axes
    from repro_torch.models.transformer import Model
    from repro_torch.train import train_step as tstep
    from repro_torch.train.optimizer import AdamWConfig, zero1_layout

    tag = f"{mesh.data_count}x{mesh.model_count}"
    runs = {}
    for zero1 in (False, True):
        model = Model(cfg, remat="none", ax=make_axes(mesh, B), mesh=mesh, fsdp=1)
        params = model.init(torch.Generator().manual_seed(0))
        tcfg = tstep.TrainConfig(opt=AdamWConfig(lr=3e-3, warmup_steps=1), zero1=zero1)
        step, opt = tstep.make_train_step(model, tcfg), tstep.init_state(model, tcfg)
        losses, norms = [], []
        for batch in zero1_batches(cfg.vocab_size):
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        runs[zero1] = (model, params, opt)
        info[f"zero1/{zero1}"] = {"losses": losses, "grad_norms": norms,
                                  "moment_elems": sum(t.numel() for t in opt.m.values()),
                                  "sliced": len(zero1_layout(model)) if zero1 else 0}
    (model, params, opt), (_, params0, opt0) = runs[True], runs[False]
    joined, joined0 = model.gather(params), model.gather(params0)
    info["zero1/params_equal"] = sorted(name for name in joined0 if torch.equal(joined[name], joined0[name]))
    info["zero1/param_names"] = sorted(joined0)
    if tag != "2x2":
        return
    for zero1, (m, p, o) in runs.items():
        ckpt.save(str(root / f"zero1_{zero1}"), ZERO1_STEPS, (p, o),
                  tstep.StatePlacement(m, zero1_layout(m) if zero1 else None))
    restored, _ = ckpt.restore(str(root / "zero1_True"), (params, opt),
                               placement=tstep.StatePlacement(model, zero1_layout(model)))
    info["zero1/restored_equal"] = all(torch.equal(a, b) for a, b in zip(
        [*restored[1].m.values(), *restored[1].v.values(), *restored[0].parameters()],
        [*opt.m.values(), *opt.v.values(), *params.parameters()]))
    grads = tstep.accumulate_grads(model, zero1_batches(cfg.vocab_size)[0], 1)[1]
    _int8(model, grads, "zero1", out, info)


def _int8(model, grads, case: str, out: dict, info: dict) -> None:
    """``compress_grads(int8)`` of a rank's gradients: the joined compressed
    and uncompressed gradients, and the cut leaves it joined to compress."""
    from repro_torch.train import train_step as tstep

    joined, real = [], model.join_leaf

    def join_leaf(name, block):
        joined.append(name)
        return real(name, block)

    model.join_leaf = join_leaf
    try:
        compressed = tstep.compress_grads(model, grads, "int8")
    finally:
        del model.join_leaf
    specs = model.leaf_specs()
    info[f"int8/{case}/joined"] = sorted(joined)
    info[f"int8/{case}/cut"] = sorted(name for name in grads if model.sh.cut_axes(specs[name]))
    out.update({f"int8/{case}/raw/{k}": v for k, v in model.gather(grads).items()})
    out.update({f"int8/{case}/q/{k}": v for k, v in model.gather(compressed).items()})


def _ckpt_runs(mesh, root: Path, out: dict, info: dict) -> None:
    """Jamba's checkpoints at (2, 2) through ``launch.train.main``: one step
    with ``--ckpt``, then ``--resume`` to three; the one-card ``save`` of
    the joined final state; the final checkpoint restored at (1, 4)."""
    import torch

    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_axes, make_lm_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.train import train_step as tstep
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    args = ["--arch", CASES["jamba"], *TRAIN_ARGS, "--remat", "none", "--ckpt", str(root / "ckpt"),
            "--ckpt-every", "1", "--data-shards", "2", "--model-shards", "2"]
    first = train.main([*args, "--steps", "1"])
    res = train.main([*args, "--resume"])
    info["ckpt/losses"] = first["losses"] + res["losses"]
    cfg = reduced_config(get_config(CASES["jamba"]))
    model = Model(cfg, remat="none", ax=make_axes(mesh, B), mesh=mesh, fsdp_min_elems=FSDP_MIN_ELEMS)
    placement = tstep.StatePlacement(model)
    whole = [(key, placement.join(key, t)) for key, t in ckpt._flatten((res["params"], res["opt_state"]))]
    out.update({f"ckpt/final/{k}": v for k, v in whole if k.startswith("0.")})
    if placement.writer:
        params = {k[2:]: v for k, v in whole if k.startswith("0.")}
        m = {k[4:]: v for k, v in whole if k.startswith("1.m.")}
        v_ = {k[4:]: v for k, v in whole if k.startswith("1.v.")}
        ckpt.save(str(root / "one_card"), 3, (params, tstep.OptState(dict(whole)["1.step"], m, v_)))
    with make_lm_mesh(1, 4, "cpu") as other:
        m14 = Model(cfg, remat="none", ax=make_axes(other, B), mesh=other, fsdp_min_elems=FSDP_MIN_ELEMS)
        p14 = m14.init(torch.Generator().manual_seed(1))
        (p14, o14), step = ckpt.restore(str(root / "ckpt"), (p14, init_opt_state(p14, AdamWConfig())),
                                        placement=tstep.StatePlacement(m14))
        info["ckpt/restored_step_1x4"] = step
        out.update({f"ckpt/1x4/{k}": v for k, v in m14.gather(p14).items()})


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
    from repro_torch.launch.mesh import make_axes, make_lm_mesh
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
                if case in CUT_LOSS and (data, model_size) == (1, 4):
                    info[f"{case}/wide"] = _wide_outputs(model, batch, cfg.vocab_size)
                if case == "jamba" and (data, model_size) == (2, 2):
                    _int8(model, grads, case, out, info)
            if (data, model_size) in ZERO1_MESHES:
                _zero1_runs(zero1_config(get_config, reduced_config), mesh, out_dir, out, info)
            if (data, model_size) == (2, 2):
                fsdp_model = Model(zero1_config(get_config, reduced_config), ax=make_axes(mesh, B), mesh=mesh,
                                   fsdp_min_elems=FSDP_MIN_ELEMS)
                try:
                    tstep.make_train_step(fsdp_model, tstep.TrainConfig(zero1=True))
                    info["zero1/fsdp"] = "ran"
                except ValueError as err:
                    info["zero1/fsdp"] = str(err)
                _ckpt_runs(mesh, out_dir, out, info)
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
