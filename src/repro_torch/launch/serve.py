"""Batched serving launcher: prefill a batch of prompts, decode N tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced --batch 4 --prompt-len 1000 --tokens 32

Runs on the card by default, where prefill attention is the hand-written
flash-attention kernel; ``--device cpu`` runs the plain PyTorch path. The
weights and the prompt are drawn from ``--seed`` (published checkpoints
are not in the repository), in float32. ``--reduced`` (the default) runs
the arch's structure-preserving tiny config; ``--no-reduced`` runs its
published widths.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve
from repro_torch.models.transformer import Model
from repro_torch.serve.decode import generate


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
    ap.add_argument("--quiet", action="store_true")
    return ap


def setup(cfg: ArchConfig, batch: int, prompt_len: int, device: torch.device, seed: int):
    """(model, prompt, batch_extra, generator): weights, prompt and stub
    embeddings drawn in that order from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = Model(cfg, dtype=torch.float32)
    model.init(gen)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=device)
    extra = None
    if cfg.input_mode == "embeddings":
        extra = {"embeds": 0.02 * torch.randn((batch, prompt_len, cfg.d_model), generator=gen, device=device)}
    return model, prompt, extra, gen


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model, prompt, extra, gen = setup(cfg, args.batch, args.prompt_len, dev, args.seed)
    timings: dict = {}
    t0 = time.perf_counter()
    out = generate(model, prompt, steps=args.tokens, temperature=args.temperature,
                   generator=gen, batch_extra=extra, timings=timings)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if not args.quiet:
        print(f"generated {args.batch}x{args.tokens} tokens in {dt:.2f}s "
              f"(prefill {timings['prefill_s']:.3f}s, decode {timings['decode_s']:.3f}s, {dev})")
        print("sample:", out[0].tolist())
    return {"tokens": out, "seconds": dt, **timings}


if __name__ == "__main__":
    main()
