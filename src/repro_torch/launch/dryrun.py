"""Multi-pod dry run: every (arch × shape × mesh) cell's step, run once at
one rank of the production mesh on tensors that hold no memory.

For each cell:
  * a ``fake`` default process group of 256 or 512 ranks, at rank 0's
    coordinates, and the production mesh over it (``make_production_mesh``:
    16 × 16 or 2 × 16 × 16);
  * the model on the ``meta`` device at the reference's dtype (bf16
    parameters), placed by its specs: TP over ``model``, FSDP over ``data``,
    the batch over ``(pod, data)`` (``Model.init_meta``);
  * one step on the inputs of ``input_specs`` (train: ``make_train_step``
    with ``auto_train_config``; prefill: ``make_prefill``; decode:
    ``make_serve_step`` on a ``cache_init`` cache), under
    ``MemTracker`` (the peak), ``FlopCounterMode`` (the FLOPs) and a census
    of the collectives the step issues (``Census``);
  * one JSON record a cell in ``results/dryrun_torch/<cell>.json``
    (resumable: a cell whose record exists is read back).

A record holds the reference's keys where they mean the same (``cell``,
``arch``, ``shape``, ``mesh``, ``params``, ``active_params``, ``kind``,
``microbatches``, ``status`` ``ok`` / ``skip`` / ``error`` with ``error``
and ``traceback``), then ``memory`` (the counterpart of the reference's
``memory_analysis``: argument bytes a rank by kind, from the placed
blocks (``named``), output bytes, and the step's ``peak_bytes``), ``flops``
(the rank's total, the counterpart of ``dot_flops_per_device``),
``collectives`` (``by_op`` count and payload bytes, under the reference's
output-shape convention, and ``total_bytes``) and ``build_s`` / ``run_s``
in place of ``lower_s`` / ``compile_s``. There is no HLO, so the
reference's ``hbm_traffic_per_device`` and ``hlo_bytes`` have no
counterpart. A cell the mesh refuses (``transformer.check_mesh``) records
``error`` with its ``NotImplementedError``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-moe-1b-a400m --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The dry run needs no card and launches nothing: it runs on the host.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Any, Iterator

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES, get_config, registry, shape_applicable
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.mesh import LMMesh, dp_size, make_axes, make_lm_mesh, make_production_mesh, named
from repro_torch.models.layers import P
from repro_torch.models.transformer import Model, layer_cache_init
from repro_torch.serve.decode import make_prefill, make_serve_step
from repro_torch.train.optimizer import init_opt_state, opt_state_specs
from repro_torch.train.train_step import TrainConfig, auto_train_config, batch_specs, make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")

# the collectives torch.distributed issues, by the name of their dispatcher
# op, as the reference's census names them; each payload the op's output
_COLLECTIVES = {
    "allreduce_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
}


def _nbytes(tree) -> int:
    """Bytes of every tensor of a nested structure (``_tensors``)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class Census(TorchDispatchMode):
    """Counts the collectives dispatched while it is on, by op, with their
    payload bytes: an all-reduce's tensors, an all-gather's and a
    reduce-scatter's outputs (the reference's ``parse_hlo`` convention)."""

    def __init__(self):
        super().__init__()
        self.by_op: dict[str, dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = _COLLECTIVES.get(func.__name__.split(".")[0]) if func.namespace == "c10d" else None
        if op is not None:
            entry = self.by_op.setdefault(op, {"count": 0, "bytes": 0})
            entry["count"] += 1
            entry["bytes"] += _nbytes(args[0])  # the tensors the op writes: its output
        return func(*args, **kwargs)

    def record(self) -> dict[str, Any]:
        return {"by_op": self.by_op, "total_bytes": sum(v["bytes"] for v in self.by_op.values())}


def input_specs(arch: ArchConfig, shape: ShapeConfig) -> dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of this cell (the whole
    global batch), the reference's shapes and dtypes."""
    b, l = shape.global_batch, shape.seq_len
    out: dict[str, torch.Tensor] = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = torch.empty((b, l), dtype=torch.int32, device="meta")
        if shape.kind == "train":
            out["labels"] = torch.empty((b, l), dtype=torch.int32, device="meta")
        if arch.input_mode == "embeddings":
            out["embeds"] = torch.empty((b, l, arch.d_model), dtype=torch.bfloat16, device="meta")
    else:  # decode: one new token against a cache of length l
        out["tokens"] = torch.empty((b, 1), dtype=torch.int32, device="meta")
    return out


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[None]:
    """A ``fake`` default process group of ``world`` ranks at rank 0,
    destroyed on exit, whatever happens inside."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake default process group; this process already has one")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_mesh(data: int, model: int, pod: int = 1) -> Iterator[LMMesh]:
    """Rank 0's view of a ``(pod, data, model)`` mesh over a fake group."""
    with fake_group(pod * data * model), make_lm_mesh(data, model, "cpu", pod=pod) as mesh:
        yield mesh


def _block_bytes(mesh: LMMesh, specs: dict[str, P], shapes: dict[str, tuple[int, ...]],
                 dtypes: dict[str, torch.dtype]) -> int:
    """Bytes of a rank's blocks of the leaves ``shapes`` placed by ``specs``."""
    shard = named(mesh, specs)
    return sum(math.prod(shard[k].shard_shape(shapes[k])) * dtypes[k].itemsize for k in shapes)


def argument_bytes(model: Model, mesh: LMMesh, shape: ShapeConfig, tcfg: TrainConfig | None,
                   inputs: dict[str, torch.Tensor]) -> dict[str, int]:
    """A rank's argument bytes by kind, from the placed blocks (``named``):
    the parameters, the optimizer state (train), the cache (decode) and the
    inputs (the rank's rows of the batch)."""
    specs = model.leaf_specs()
    whole = model.leaf_shapes()
    dtypes = {k: p.dtype for k, p in model.params.named_parameters()}
    out = {"params": _block_bytes(mesh, specs, whole, dtypes)}
    if tcfg is not None:
        moments = opt_state_specs(specs, model.ax, zero1=False)
        state = {k: tcfg.opt.state_dtype for k in whole}
        out["opt_state"] = (_block_bytes(mesh, moments.m, whole, state) + _block_bytes(mesh, moments.v, whole, state)
                            + torch.int32.itemsize)
    if shape.kind == "decode":
        cspecs, total = model.cache_specs(), 0
        for si, seg in enumerate(model.segments):
            for i, d in enumerate(seg.layers):
                cache = layer_cache_init(model.cfg, d, shape.global_batch, shape.seq_len, model.dtype, "meta")
                spec = cspecs[f"seg{si}"][f"l{i}"]
                total += seg.repeat * sum(math.prod(named(mesh, P(*sp[1:])).shard_shape(t.shape)) * t.element_size()
                                          for t, sp in zip(cache, spec))
        out["cache"] = total
    rows = batch_specs(model) if shape.kind == "train" else {
        k: P(model.ax.b, *([None] * (v.dim() - 1))) for k, v in inputs.items()}
    out["inputs"] = sum(math.prod(named(mesh, rows[k]).shard_shape(v.shape)) * v.element_size()
                        for k, v in inputs.items())
    out["total"] = sum(out.values())
    return out


def _drawn(ins: dict[str, torch.Tensor], vocab: int, gen: torch.Generator) -> dict[str, torch.Tensor]:
    """CPU tensors of ``ins``'s shapes and dtypes: tokens below ``vocab``, embeddings normal."""
    return {k: (torch.randint(0, vocab, v.shape, generator=gen, dtype=v.dtype) if not v.is_floating_point()
                else torch.randn(v.shape, generator=gen).to(v.dtype)) for k, v in ins.items()}


def cell_model(cfg: ArchConfig, shape: ShapeConfig, mesh: LMMesh, dtype: torch.dtype = torch.bfloat16) -> Model:
    """The cell's model at this rank of ``mesh``, not drawn yet, with the
    reference's ``build_cell`` settings: remat ``full`` for train, else
    ``none``, and ``remat_group`` 6 at 100e9 parameters or more."""
    return Model(cfg, dtype=dtype, remat="full" if shape.kind == "train" else "none",
                 ax=make_axes(mesh, shape.global_batch), mesh=mesh,
                 remat_group=6 if cfg.param_count() >= 100e9 else 1)


def measure(model: Model, shape: ShapeConfig, mesh: LMMesh, tcfg: TrainConfig | None = None,
            census: bool = True) -> dict[str, Any]:
    """One cell's step at this rank of ``mesh``: the record's ``kind``,
    ``microbatches``, ``dtype``, ``params_per_rank`` (elements),
    ``memory``, ``flops``, ``collectives`` and ``build_s`` / ``run_s``.
    Over a fake group (the dry run) ``model`` is placed and the step runs on
    the ``meta`` device; over real ranks on real tensors (weights and inputs
    from seed 0), which holds the dry run's census to theirs. ``tcfg``
    defaults to ``auto_train_config``. Raises what the step raises."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    cfg, train = model.cfg, shape.kind == "train"
    gen = torch.Generator().manual_seed(0)
    on_meta = dist.get_backend() == "fake"
    params = model.init_meta() if on_meta else model.init(gen)
    ins = input_specs(cfg, shape) if on_meta else _drawn(input_specs(cfg, shape), cfg.vocab_size, gen)
    rec: dict[str, Any] = {"kind": shape.kind, "dtype": str(model.dtype).removeprefix("torch."),
                           "remat": model.remat, "remat_group": model.remat_group, "mesh_shape": mesh.shape}
    if train:
        tcfg = tcfg or auto_train_config(cfg.param_count(), shape.global_batch, dp_size(mesh), moe=cfg.moe is not None)
        rec["microbatches"] = tcfg.microbatches
        opt = init_opt_state(params, tcfg.opt)
        step = make_train_step(model, tcfg)
        args, external = (params, opt, ins), [params, *opt.m.values(), *opt.v.values()]
    elif shape.kind == "prefill":
        batch = {k: model.sh.cut(v, P(model.ax.b, *([None] * (v.dim() - 1)))) for k, v in ins.items()}
        step, args, external = make_prefill(model, shape.seq_len), (batch,), [params]
    else:
        caches = model.cache_init(shape.global_batch, shape.seq_len)
        serve = make_serve_step(model)

        def step(caches, tokens):
            return serve(caches, tokens, shape.seq_len - 1)

        args, external = (caches, model.sh.cut(ins["tokens"], P(model.ax.b, None))), [params, *_tensors(caches)]
    memory = argument_bytes(model, mesh, shape, tcfg if train else None, ins)
    placed = sum(p.numel() * p.element_size() for p in params.parameters())
    if placed != memory["params"]:
        raise RuntimeError(f"the model's blocks hold {placed} bytes, the placed specs {memory['params']}")
    rec["params_per_rank"] = sum(p.numel() for p in params.parameters())
    rec["build_s"] = round(time.perf_counter() - t0, 3)
    rec["memory"] = memory

    t1 = time.perf_counter()
    flops = FlopCounterMode(display=False)
    tracker = MemTracker()
    tracker.track_external(*external)
    del external  # the step frees what it replaces (AdamW's moments): hold no reference to them
    counted = Census() if census else contextlib.nullcontext()
    with flops, tracker, counted:
        out = step(*args)
    rec["run_s"] = round(time.perf_counter() - t1, 3)
    peak = tracker.get_tracker_snapshot("peak")
    memory["output_bytes"] = _nbytes(out)
    memory["peak_bytes"] = int(sum(dev["Total"] for dev in peak.values()))
    rec["flops"] = int(flops.get_total_flops())
    if census:
        rec["collectives"] = counted.record()
    return rec


def _tensors(tree) -> Iterator[torch.Tensor]:
    """Every tensor of a nested structure (module, dict, list, tuple), once each."""
    seen = set()

    def walk(node):
        if isinstance(node, torch.Tensor):
            if id(node) not in seen:
                seen.add(id(node))
                yield node
        elif isinstance(node, torch.nn.Module):
            for p in node.parameters():
                yield from walk(p)
        elif isinstance(node, dict):
            for v in node.values():
                yield from walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                yield from walk(v)

    yield from walk(tree)


def build_cell(arch_name: str, shape_name: str, multi_pod: bool, census: bool = True) -> dict[str, Any]:
    """The cell's record fields (``measure``) on the production mesh over a
    fake group of 256 or 512 ranks, destroyed before it returns or raises."""
    cfg, shape = get_config(arch_name), SHAPES[shape_name]
    with fake_group(512 if multi_pod else 256), make_production_mesh(multi_pod, device="cpu") as mesh:
        return measure(cell_model(cfg, shape, mesh), shape, mesh, census=census)


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, out_dir: str, collect_hlo: bool = True,
             force: bool = False) -> dict[str, Any]:
    """The cell's record: read back from ``out_dir`` if it is there (and not
    ``force``), else made and written. ``collect_hlo``: take the collective
    census (the counterpart of the reference's HLO census)."""
    mesh_name = "multi" if multi_pod else "single"
    cell_id = f"{arch_name}__{shape_name}__{mesh_name}"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, cell_id + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    arch = get_config(arch_name)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(arch, shape)
    rec: dict[str, Any] = {
        "cell": cell_id, "arch": arch_name, "shape": shape_name, "mesh": mesh_name,
        "params": arch.param_count(), "active_params": arch.active_param_count(),
    }
    if not ok:
        rec.update(status="skip", reason=reason)
        _write(out_path, rec)
        return rec
    try:
        rec.update(build_cell(arch_name, shape_name, multi_pod, census=collect_hlo))
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _write(out_path, rec)
    return rec


def run_cells(cells: list[tuple[str, str, bool]], out_dir: str, collect_hlo: bool = True,
              force: bool = False) -> tuple[list[dict[str, Any]], dict[str, int]]:
    """(the records, the count of each status) of ``cells``, each ``(arch,
    shape, multi_pod)`` through ``run_cell``, printing one line a cell and
    the counts, as the reference's ``main`` prints them."""
    counts = {"ok": 0, "error": 0, "skip": 0}
    records = []
    for arch_name, shape_name, multi_pod in cells:
        rec = run_cell(arch_name, shape_name, multi_pod, out_dir, collect_hlo=collect_hlo, force=force)
        records.append(rec)
        tag = rec["status"]
        counts[tag] += 1
        extra = ""
        if tag == "ok":
            extra = (f" flops={rec['flops']:.3e} peak={rec['memory']['peak_bytes'] / 1e9:.2f}GB"
                     f" build={rec['build_s']}s run={rec['run_s']}s")
        if tag == "error":
            extra = " " + rec["error"][:160]
        print(f"[{tag:5s}] {rec['cell']}{extra}", flush=True)
    print(f"done: ok={counts['ok']} err={counts['error']} skip={counts['skip']}", flush=True)
    return records, counts


def _write(path: str, rec: dict) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f, indent=1)
    os.replace(path + ".tmp", path)


def main(argv=None) -> dict[str, int]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-hlo", action="store_true", help="skip the collective census (the reference's HLO census)")
    args = ap.parse_args(argv)
    out_dir = args.out or os.path.abspath(RESULTS_DIR)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    archs = [args.arch] if args.arch else sorted(registry())
    shapes = [args.shape] if args.shape else list(SHAPES)
    if not args.all and args.arch is None:
        ap.error("pass --arch/--shape or --all")

    cells = [(a, s, multi) for multi in meshes for a in archs for s in shapes]
    return run_cells(cells, out_dir, collect_hlo=not args.no_hlo, force=args.force)[1]


if __name__ == "__main__":
    main()
