"""End-to-end LM training launcher: the synthetic token pipeline, the
microbatched train step, async checkpoints and restart.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 15
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20 --ckpt CKPT_DIR --resume
  PYTHONPATH=src python -m repro_torch.launch.train --no-reduced --steps 12 --batch 8 --seq 64
  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
      --arch jamba-v0.1-52b --data-shards 2 --model-shards 2 --steps 3

Runs on the card by default and raises where there is none; ``--device
cpu`` runs on the CPU. ``--reduced`` (the default) trains the arch's
structure-preserving tiny config, ``--no-reduced`` its published widths.
The weights are drawn from ``--seed`` in float32 (published checkpoints are
not in the repository), and so is the data. Attention is the plain,
differentiable one on every device, as in the reference's training.

``--data-shards D --model-shards M`` trains on a ``(data, model)`` mesh of
D × M ranks, one process a rank (``torchrun``; on ``cuda`` one card a
rank, NCCL; on the CPU gloo), as ``launch.serve`` serves: each rank draws
the weights layer by layer and keeps its blocks (FSDP-widened over the
data axis, ``models.transformer.Model``), builds each step's whole batch
and keeps its rows (``train.train_step``). When the batch does not split
into ``--microbatches`` of whole data blocks the reference's
``auto_train_config`` rule takes fewer. Only rank 0 prints; every rank
returns the same losses and norms. ``--ckpt`` on a mesh writes the
one-card checkpoint of the whole ``(params, opt_state)`` (rank 0 writes,
every rank joins: ``train_step.StatePlacement``), and ``--resume`` cuts
each rank's blocks from it, so a run resumes at any mesh shape or on one
card. ``--pod-shards P`` makes it the
reference's multi-pod ``(pod, data, model)`` mesh of P × D × M ranks: the
batch cut over the P × D ranks, FSDP over the D ranks of a pod.
"""
from __future__ import annotations

import argparse
import contextlib
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import cut_config, get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, SyntheticTokenSource, device_put_batch
from repro_torch.device import resolve
from repro_torch.launch.mesh import dp_size, make_axes, make_lm_mesh
from repro_torch.models.transformer import REMAT, Model
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import StatePlacement, TrainConfig, make_train_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="the arch's reduced config (default); --no-reduced: its published widths")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch to its first N layers (a whole number of its layer pattern's periods)")
    ap.add_argument("--experts", type=int, default=None, help="cut an MoE arch to N routed experts a layer")
    ap.add_argument("--ckpt", default=None, help="checkpoint directory")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true", help="continue from the newest checkpoint in --ckpt")
    ap.add_argument("--compression", default="none", choices=["none", "bf16", "int8"])
    ap.add_argument("--remat", default="none", choices=REMAT)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and the data")
    ap.add_argument("--pod-shards", type=int, default=1,
                    help="pods: copies of the (data, model) mesh the batch is cut over too (under torchrun)")
    ap.add_argument("--data-shards", type=int, default=1, help="ranks the batch is cut over (under torchrun)")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="ranks the parameters are cut over (under torchrun)")
    ap.add_argument("--fsdp-min-elems", type=int, default=1 << 22,
                    help="on a mesh: the smallest leaf (in elements, counted stacked) that FSDP cuts over the data axis")
    ap.add_argument("--quiet", action="store_true")
    return ap


def microbatches_for(batch: int, n: int, dp: int) -> int:
    """``n``, or fewer where the batch does not split into ``n`` microbatches
    of whole data blocks: the reference's ``auto_train_config`` rule."""
    n = max(1, min(n, batch // dp))
    while batch % n or (batch // n) % dp:
        n -= 1
    return n


def main(argv=None) -> dict:
    """Train; returns ``losses``, ``grad_norms`` (before the clip),
    ``final_loss``, ``params`` and ``opt_state`` (on a mesh, this rank's blocks),
    ``step_seconds`` (each step's host-clock wall, ending in a synchronize
    on the card), ``tokens_per_s`` (tokens trained over the steps' summed
    walls), ``microbatches`` and ``mesh`` (None without one)."""
    args = _parser().parse_args(argv)
    dev = resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    cfg = cut_config(cfg, args.layers, args.experts)
    with contextlib.ExitStack() as stack:
        mesh = None
        if (args.pod_shards, args.data_shards, args.model_shards) != (1, 1, 1):
            mesh = stack.enter_context(make_lm_mesh(args.data_shards, args.model_shards, dev, pod=args.pod_shards))
            dev = mesh.device
        out = _train(args, cfg, dev, mesh)
    return out


def _train(args, cfg, dev: torch.device, mesh) -> dict:
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    loud = not args.quiet and (mesh is None or dist.get_rank() == 0)
    ax = make_axes(mesh, args.batch) if mesh is not None else None
    model = Model(cfg, dtype=torch.float32, remat=args.remat, ax=ax, mesh=mesh, fsdp_min_elems=args.fsdp_min_elems)
    microbatches = microbatches_for(args.batch, args.microbatches, dp_size(mesh) if mesh is not None else 1)
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=5, total_steps=max(args.steps, 10)),
        microbatches=microbatches,
        compression=args.compression,
    )
    step_fn = make_train_step(model, tcfg)

    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    opt = init_opt_state(params, tcfg.opt)
    start_step = 0
    saver = None
    if args.ckpt:
        placement = StatePlacement(model) if mesh is not None else None
        if args.resume and ckpt.latest_step(args.ckpt) is not None:
            (params, opt), start_step = ckpt.restore(args.ckpt, (params, opt), placement=placement)
            if loud:
                print(f"resumed from step {start_step}")
        saver = ckpt.AsyncCheckpointer(args.ckpt, placement=placement)

    def sync() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    src = SyntheticTokenSource(cfg, shape, DataConfig(seed=args.seed))
    losses, grad_norms, step_seconds = [], [], []
    try:
        for step in range(start_step, args.steps):
            batch = device_put_batch(src.batch_at(step), dev)
            t0 = sync()
            params, opt, metrics = step_fn(params, opt, batch)
            step_seconds.append(sync() - t0)
            losses.append(float(metrics["loss"]))
            grad_norms.append(float(metrics["grad_norm"]))
            if loud and (step % 5 == 0 or step == args.steps - 1):
                print(f"step {step:4d} loss {losses[-1]:.4f} "
                      f"gnorm {grad_norms[-1]:.3f} lr {float(metrics['lr']):.2e}")
            if saver and (step + 1) % args.ckpt_every == 0:
                saver.submit(step + 1, (params, opt))
        if saver and args.steps % args.ckpt_every:  # the last step, unless the loop saved it
            saver.submit(args.steps, (params, opt))
    finally:
        if saver:
            saver.close()
    tokens_per_s = args.batch * args.seq * len(step_seconds) / sum(step_seconds) if step_seconds else float("nan")
    if loud and losses:
        where = dev if mesh is None else f"{dev}, mesh {mesh.shape}"
        print(f"{len(losses)} steps in {sum(step_seconds):.2f}s (median {statistics.median(step_seconds):.4f}s, "
              f"{tokens_per_s:.0f} tokens/s, {where}); loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"losses": losses, "grad_norms": grad_norms, "final_loss": losses[-1] if losses else float("nan"),
            "params": params, "opt_state": opt, "step_seconds": step_seconds, "tokens_per_s": tokens_per_s,
            "microbatches": microbatches, "mesh": None if mesh is None else mesh.shape}


if __name__ == "__main__":
    main()
