"""End-to-end LM training launcher: the synthetic token pipeline, the
microbatched train step, async checkpoints and restart.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 15
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20 --ckpt CKPT_DIR --resume
  PYTHONPATH=src python -m repro_torch.launch.train --no-reduced --steps 12 --batch 8 --seq 64

Runs on the card by default and raises where there is none; ``--device
cpu`` runs on the CPU. ``--reduced`` (the default) trains the arch's
structure-preserving tiny config, ``--no-reduced`` its published widths.
The weights are drawn from ``--seed`` in float32 (published checkpoints are
not in the repository), and so is the data. Attention is the plain,
differentiable one on every device, as in the reference's training.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, SyntheticTokenSource, device_put_batch
from repro_torch.device import resolve
from repro_torch.models.transformer import REMAT, Model
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import TrainConfig, make_train_step


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
    ap.add_argument("--ckpt", default=None, help="checkpoint directory")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true", help="continue from the newest checkpoint in --ckpt")
    ap.add_argument("--compression", default="none", choices=["none", "bf16", "int8"])
    ap.add_argument("--remat", default="none", choices=REMAT)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and the data")
    ap.add_argument("--quiet", action="store_true")
    return ap


def main(argv=None) -> dict:
    """Train; returns ``losses``, ``grad_norms`` (before the clip),
    ``final_loss``, ``params``, ``step_seconds`` (each step's host-clock
    wall, ending in a synchronize on the card) and ``tokens_per_s`` (tokens
    trained over the steps' summed walls)."""
    args = _parser().parse_args(argv)
    dev = resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    model = Model(cfg, dtype=torch.float32, remat=args.remat)
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=5, total_steps=max(args.steps, 10)),
        microbatches=args.microbatches,
        compression=args.compression,
    )
    step_fn = make_train_step(model, tcfg)

    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    opt = init_opt_state(params, tcfg.opt)
    start_step = 0
    saver = None
    if args.ckpt:
        if args.resume and ckpt.latest_step(args.ckpt) is not None:
            (params, opt), start_step = ckpt.restore(args.ckpt, (params, opt))
            if not args.quiet:
                print(f"resumed from step {start_step}")
        saver = ckpt.AsyncCheckpointer(args.ckpt)

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
            if not args.quiet and (step % 5 == 0 or step == args.steps - 1):
                print(f"step {step:4d} loss {losses[-1]:.4f} "
                      f"gnorm {grad_norms[-1]:.3f} lr {float(metrics['lr']):.2e}")
            if saver and (step + 1) % args.ckpt_every == 0:
                saver.submit(step + 1, (params, opt))
        if saver:
            saver.submit(args.steps, (params, opt))
    finally:
        if saver:
            saver.close()
    tokens_per_s = args.batch * args.seq * len(step_seconds) / sum(step_seconds) if step_seconds else float("nan")
    if not args.quiet and losses:
        print(f"{len(losses)} steps in {sum(step_seconds):.2f}s (median {statistics.median(step_seconds):.4f}s, "
              f"{tokens_per_s:.0f} tokens/s, {dev}); loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"losses": losses, "grad_norms": grad_norms, "final_loss": losses[-1] if losses else float("nan"), "params": params,
            "step_seconds": step_seconds, "tokens_per_s": tokens_per_s}


if __name__ == "__main__":
    main()
