#!/usr/bin/env python3
"""How far the order of the sums moves an LM's first training gradient on one card.

``launch.train.main``'s first step for the arch at its published widths
(cut by ``--layers``), as ``chip_smoke.py``'s mesh training runs take it:
weights and tokens from seed 0, B 8, L 64, remat ``full``, fp32 with TF32
off; once in 2 microbatches and once in 1, the same arithmetic summed in
another order. ``--off-init`` draws RWKV-6's token-shift mixes, ``u``,
``ln_scale`` and ``w0`` off their init values (``rwkv_off_init``). One JSON
line: each run's loss and gradient norm, and the relative gap of the
second run's to the first's. Where one card's own split moves them past a gate's
tolerance, no mesh run can be held to that gate.

Run from the root of a checkout on a machine with the card:

    python3 tools/grad_spread.py --arch rwkv6-1.6b [--layers N] [--off-init]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402


def step_args(arch: str, layers: int | None, microbatches: int) -> list[str]:
    """``launch.train``'s arguments for one step of ``arch`` on the card."""
    return ["--arch", arch, "--no-reduced", *(["--layers", str(layers)] if layers else []), "--steps", "1",
            "--batch", str(chip_smoke.TRAIN_BATCH), "--seq", str(chip_smoke.TRAIN_SEQ),
            "--microbatches", str(microbatches), "--remat", "full", "--lr", "1e-3", "--device", "cuda",
            "--seed", "0", "--quiet"]


@contextlib.contextmanager
def rwkv_off_init(on: bool = True):
    """While open (and ``on``), every RWKV-6 layer the model draws has its
    constants moved off their init values after its weights, from the
    layer's own generator, as tests/test_torch_lm_train_mesh.py moves them:
    the token-shift mixes, the bonus ``u`` and the head-norm scale
    ``ln_scale`` by 0.1 N(0, 1), ``w0`` drawn at -1 + 0.3 N(0, 1). At init
    u is 0, so the first token's WKV output is exactly 0, where the head
    norm's backward scales its rounding by 1/sqrt(eps) ≈ 316; a spread that
    stays with them moved is not that op's."""
    import torch

    from repro_torch.models import rwkv

    draws = {"rwkv_time_mix_init": ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "u", "ln_scale"),
             "rwkv_channel_mix_init": ("mix_k", "mix_r")}
    saved = {fn: getattr(rwkv, fn) for fn in draws}

    def moved(fn):
        def init(gen, cfg, dtype=torch.float32):
            p = saved[fn](gen, cfg, dtype)
            with torch.no_grad():
                for name in draws[fn]:
                    p[name].add_(0.1 * torch.randn(p[name].shape, generator=gen, device=gen.device))
                if "w0" in p:
                    p["w0"].copy_(-1.0 + 0.3 * torch.randn(p["w0"].shape, generator=gen, device=gen.device))
            return p
        return init

    if on:
        for fn in draws:
            setattr(rwkv, fn, moved(fn))
    try:
        yield
    finally:
        for fn, f in saved.items():
            setattr(rwkv, fn, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/grad_spread.py")
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--off-init", action="store_true", help="RWKV-6's constants off their init values")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("grad_spread: torch.cuda.is_available() is False; this needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.launch import train

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    runs = {}
    for micro in (chip_smoke.TRAIN_MICRO, 1):
        with rwkv_off_init(args.off_init):
            out = train.main(step_args(args.arch, args.layers, micro))
        runs[micro] = {"loss": out["losses"][0], "grad_norm": out["grad_norms"][0]}
        del out
        torch.cuda.empty_cache()
    base, other = runs[chip_smoke.TRAIN_MICRO], runs[1]
    print(json.dumps({"arch": args.arch, "layers": args.layers, "off_init": args.off_init,
                      "card": chip_smoke.smi_line(), "microbatches": {str(m): r for m, r in runs.items()},
                      "loss_rel_gap": abs(other["loss"] - base["loss"]) / abs(base["loss"]),
                      "grad_norm_rel_gap": abs(other["grad_norm"] - base["grad_norm"]) / base["grad_norm"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
