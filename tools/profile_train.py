#!/usr/bin/env python3
"""Time and profile the port's LM training step on the card.

The step is that of ``chip_smoke.py``'s ``qwen2_train`` phase by default
(``--arch granite-moe-1b-a400m``: its ``granite_train`` phase): the arch at
its published widths (24 layers, fp32, weights and tokens
from seed 0), B 8, L 64 in 2 microbatches, AdamW, no remat. ``--batch``,
``--seq``, ``--microbatches`` and ``--remat`` change the shape; Qwen2's
pretraining context is 4,096 tokens (Qwen2 Technical Report,
arXiv:2407.10671, section 3.2), so ``--seq 4096 --batch 4 --microbatches 4
--remat full`` takes one such sequence a microbatch. One run is one process
and prints one JSON line with:

- ``cold_step_s``: the first step (host clock, ending in a synchronize);
  ``step_s``: ``--repeats`` steps after it, ``step_median_s`` their median;
- ``phase_s``: the parts of a step, each timed alone ``--repeats`` times
  (medians, host clock ending in a synchronize): ``fwd_bwd`` (one
  microbatch's ``loss_fn`` and ``torch.autograd.grad``) and ``adamw`` (one
  ``adamw_update`` over every parameter);
- one more step under ``torch.profiler``: ``profiled_wall_s``,
  ``device_busy_ms`` and ``device_busy_share`` (the device events' own
  time, ``profile_ksearch.device_times``), ``device_events`` (their count:
  kernels, copies, fills), ``sgemm_ms`` (the kernels whose name holds
  ``gemm``), ``host_waits`` (``profile_serve.host_waits``) and the
  ``--top`` kernels by device time; ``--trace PATH`` writes its timeline;
- ``tokens_per_s`` (B L over the median step) and ``max_memory_allocated``;
- for an MoE arch, ``dropped_slots``: the slots each MoE layer dropped in
  one more forward of the first microbatch (``chip_smoke.DropCount``,
  outside the timed and profiled steps), and ``routed_slots``, the slots a
  layer routes. Granite 3.0 was pretrained at 4,096 tokens too (IBM,
  "Granite 3.0 Language Models", 2024), so the same flags take its
  pretraining context.

Run from the root of a checkout on a machine with a card:

    python3 tools/profile_train.py [--arch qwen2-0.5b] [--repeats 5] [--remat none|full|dots]
        [--batch 8] [--seq 64] [--microbatches 2]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from profile_ksearch import device_times
from profile_serve import DropCount, host_waits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--remat", default="none", choices=("none", "full", "dots"))
    ap.add_argument("--batch", type=int, default=8)  # chip_smoke.py's qwen2_train phase
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--trace", default=None, help="write the profiled step's chrome trace here")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_train: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import SyntheticTokenSource, device_put_batch
    from repro_torch.device import resolve
    from repro_torch.models.transformer import Model
    from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state
    from repro_torch.train.train_step import TrainConfig, _split_microbatches, make_train_step

    dev = resolve("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = get_config(args.arch)
    model = Model(cfg, remat=args.remat)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=12), microbatches=args.microbatches)
    opt = init_opt_state(params, tcfg.opt)
    step_fn = make_train_step(model, tcfg)
    src = SyntheticTokenSource(cfg, ShapeConfig("profile", args.seq, args.batch, "train"))
    batches = [device_put_batch(src.batch_at(i), dev) for i in range(args.repeats + 2)]

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    state = {"params": params, "opt": opt}

    def step(batch) -> None:
        state["params"], state["opt"], metrics = step_fn(state["params"], state["opt"], batch)
        state["loss"] = metrics["loss"]

    cold = timed(lambda: step(batches[0]))
    walls = [timed(lambda b=b: step(b)) for b in batches[1 : args.repeats + 1]]

    leaves = list(state["params"].parameters())
    names = [n for n, _ in state["params"].named_parameters()]
    micro = {k: v[0] for k, v in _split_microbatches(batches[0], args.microbatches).items()}
    grads = {}

    def fwd_bwd() -> None:
        loss = model.loss_fn(micro)
        grads.update(zip(names, torch.autograd.grad(loss, leaves)))

    fwd_bwd_s = [timed(fwd_bwd) for _ in range(args.repeats)]
    adamw_s = [timed(lambda: adamw_update(state["params"], grads, state["opt"], tcfg.opt))
               for _ in range(args.repeats)]
    grads.clear()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = timed(lambda: step(batches[-1]))
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    if not bool(torch.isfinite(state["loss"])):
        raise AssertionError("profile_train: non-finite loss")
    times = device_times(prof)
    busy = sum(ms for ms, _ in times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[: args.top]
    moe = {}
    if cfg.moe is not None:
        with torch.no_grad(), DropCount(micro["tokens"].shape[0]) as drops:
            model.loss_fn(micro)
        moe = {"dropped_slots": [sum(c) for c in drops.by_call], "routed_slots": micro["tokens"].numel() * cfg.moe.top_k}
    print(json.dumps({
        "card": smi, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "shape": f"{args.arch} full width, B {args.batch}, L {args.seq}, {args.microbatches} microbatches, "
                 f"remat {args.remat}",
        "cold_step_s": cold, "step_s": walls, "step_median_s": statistics.median(walls),
        "tokens_per_s": args.batch * args.seq / statistics.median(walls),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "phase_s": {"fwd_bwd": statistics.median(fwd_bwd_s), "adamw": statistics.median(adamw_s)},
        "profiled_wall_s": wall, "device_busy_ms": busy, "device_busy_share": busy / 1e3 / wall,
        "device_events": sum(count for _, count in times.values()),
        "sgemm_ms": sum(ms for name, (ms, _) in times.items() if "gemm" in name.lower()),
        "host_waits": host_waits(prof), "top": [[name[:80], ms, count] for name, (ms, count) in top],
        **moe,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
