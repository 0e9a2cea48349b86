"""Batched serving launcher: prefill a batch of prompts, decode N tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced --batch 4 --prompt-len 1000 --tokens 32
  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.serve \
      --no-reduced --arch jamba-v0.1-52b --data-shards 1 --model-shards 4 --prompt-len 1024 --tokens 32

Runs on the card by default, where prefill attention is the hand-written
flash-attention kernel; ``--device cpu`` runs the plain PyTorch path. The
weights and the prompt are drawn from ``--seed`` (published checkpoints
are not in the repository), in float32. ``--reduced`` (the default) runs
the arch's structure-preserving tiny config; ``--no-reduced`` runs its
published widths.

``--data-shards D --model-shards M`` serves on a ``(data, model)`` mesh of
D × M ranks, one process a rank (``torchrun``; on ``cuda`` one card a rank,
NCCL; on the CPU gloo): each rank draws the weights layer by layer from
the seed and keeps its blocks (``models.transformer.Model.place``), takes
its rows of the prompt and runs ``generate``. The defaults, 1 and 1, are
the one-card path with no process group. Only rank 0 prints.
``--pod-shards P`` makes it a ``(pod, data, model)`` mesh of P × D × M
ranks, the batch cut over the P × D ranks.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve
from repro_torch.launch.mesh import LMMesh, make_axes, make_lm_mesh
from repro_torch.models.layers import P
from repro_torch.models.transformer import Model
from repro_torch.serve.decode import decode_input_specs, generate


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="the arch's reduced config (default); --no-reduced: its published widths")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the flash-attention kernel; cpu its plain version")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights, the prompt and sampling")
    ap.add_argument("--pod-shards", type=int, default=1,
                    help="pods: copies of the (data, model) mesh the batch is cut over too (under torchrun)")
    ap.add_argument("--data-shards", type=int, default=1, help="ranks the batch is cut over (under torchrun)")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="ranks the parameters and caches are cut over (under torchrun)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def setup(cfg: ArchConfig, batch: int, prompt_len: int, device: torch.device, seed: int,
          mesh: LMMesh | None = None):
    """(model, prompt, batch_extra, generator): weights, prompt and stub
    embeddings drawn in that order from one generator seeded with ``seed``.
    On a ``mesh`` (whose device ``device`` must be) the model holds this
    rank's blocks of the same weights and the prompt and embeddings are
    this rank's rows (``decode_input_specs``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    # no FSDP for serving: each decode step would gather every layer's
    # weights over the data group for one token (PERF.md, PR 26)
    model = Model(cfg, dtype=torch.float32, ax=make_axes(mesh, batch) if mesh is not None else None, mesh=mesh,
                  fsdp=1)
    model.init(gen)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=device)
    extra = None
    if cfg.input_mode == "embeddings":
        extra = {"embeds": 0.02 * torch.randn((batch, prompt_len, cfg.d_model), generator=gen, device=device)}
    if model.sh is not None:
        rows = decode_input_specs(model)["tokens"]
        prompt = model.sh.cut(prompt, rows)
        if extra is not None:
            extra = {"embeds": model.sh.cut(extra["embeds"], P(*rows, None))}
    return model, prompt, extra, gen


def main(argv=None) -> dict:
    """Serve one batch; returns this rank's tokens (its rows), the wall and
    ``generate``'s timings, and the mesh's shape (None without one)."""
    args = _parser().parse_args(argv)
    dev = resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    with contextlib.ExitStack() as stack:
        mesh = None
        if (args.pod_shards, args.data_shards, args.model_shards) != (1, 1, 1):
            mesh = stack.enter_context(make_lm_mesh(args.data_shards, args.model_shards, dev, pod=args.pod_shards))
            dev = mesh.device
        model, prompt, extra, gen = setup(cfg, args.batch, args.prompt_len, dev, args.seed, mesh)
        timings: dict = {}
        t0 = time.perf_counter()
        out = generate(model, prompt, steps=args.tokens, temperature=args.temperature,
                       generator=gen, batch_extra=extra, timings=timings)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if not args.quiet and (mesh is None or dist.get_rank() == 0):
            where = dev if mesh is None else f"{dev}, mesh {mesh.shape}"
            print(f"generated {args.batch}x{args.tokens} tokens in {dt:.2f}s "
                  f"(prefill {timings['prefill_s']:.3f}s, decode {timings['decode_s']:.3f}s, {where})")
            print("sample:", out[0].tolist())
    return {"tokens": out, "seconds": dt, "mesh": None if mesh is None else mesh.shape, **timings}


if __name__ == "__main__":
    main()
