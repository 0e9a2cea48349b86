#!/usr/bin/env python3
"""Time and profile the port's serve prefill on the card.

The prefill is that of ``chip_smoke.py``'s serve phases: qwen2-0.5b (or
``--arch``, e.g. granite-moe-1b-a400m) at its published widths (24 layers,
weights from seed 0), 4 prompts of 1000 tokens (``--prompt-len``), one
flash-attention launch per attention layer. ``--layers N`` cuts the depth
to N layers (jamba-v0.1-52b's one 8-layer period is 13.3 B parameters,
53 GB in fp32; the whole model does not fit one card). One run is one
process and prints one JSON line with:

- ``cold_prefill_s``: the first prefill of the process (host clock, ending
  in a synchronize), after the kernels are built and loaded;
- ``prefill_s``: ``--repeats`` prefills after it, each on the host clock
  and ending in a synchronize; ``prefill_median_s`` their median;
- ``serve_prefill_s`` and ``serve_decode_s``: ``serve.decode.generate``
  as ``launch.serve.main`` runs it (32 new tokens), on the same weights,
  after those prefills;
- ``flash_launches``: the flash-attention launches of one prefill;
- one more prefill under ``torch.profiler``: ``profiled_wall_s``,
  ``device_busy_ms`` (the device events' own time, summed:
  ``profile_ksearch.device_times``; the split pass and the main kernel may
  overlap a little, which this counts twice), ``device_busy_share``,
  ``flash_ms`` (the kernels whose name holds ``flash`` or ``split_kv``),
  ``host_waits`` (the host's calls that wait for the device or copy to
  it, by name and count: each copy from pageable host memory and each
  synchronize holds the host until the device has caught up, and the
  launches after it then reach an idle device) and the ``--top`` kernels
  by device time; ``--trace PATH`` writes its timeline
  (``export_chrome_trace``);
- for an MoE arch, ``dropped_slots``: the slots each MoE layer dropped in
  one more prefill (``chip_smoke.DropCount``; a host read a layer, outside
  the timed and profiled prefills) and ``routed_slots``, the slots a layer
  routes.

``--turns N --parent SRC`` instead runs 2N such processes in turns (parent,
change, change, parent, ...; the change is ``--src``) and, last, prints
for each version the median, least and largest of the processes' figures.
Run from the root of a checkout on a machine with a card:

    python3 tools/profile_serve.py [--src src] [--repeats 5]
    python3 tools/profile_serve.py --arch jamba-v0.1-52b --layers 8 --prompt-len 1024
    python3 tools/profile_serve.py --turns 5 --parent build/parent/src
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from profile_ksearch import device_times

from chip_smoke import DropCount  # noqa: E402  (profile_ksearch puts the repo root on the path)

BATCH, PROMPT, TOKENS = 4, 1000, 32  # chip_smoke.py's serve phases
# the figures of one process that the turns summarize
SUMMARY_KEYS = ("prefill_median_s", "cold_prefill_s", "serve_prefill_s", "profiled_wall_s", "device_busy_ms",
                "flash_ms")
# CUDA runtime calls that hold the host until the device has caught up (or copy to it)
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy", "cudaMemcpyAsync")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this many layers (default: the arch's)")
    ap.add_argument("--prompt-len", type=int, default=PROMPT)
    ap.add_argument("--tag", default=None, help="label of this version in the output (default: --src)")
    ap.add_argument("--repeats", type=int, default=5, help="warm prefills on the host clock")
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--trace", default=None, help="write the profiled prefill's chrome trace here")
    ap.add_argument("--turns", type=int, default=0, help="with --parent: processes of each version, in turns")
    ap.add_argument("--parent", default=None, help="the src directory of the version to compare with")
    args = ap.parse_args(argv)
    if args.turns and not args.parent:
        ap.error("--turns needs --parent")
    if args.repeats < 1:
        ap.error("--repeats takes at least 1")
    if args.layers < 0 or args.prompt_len < 1:
        ap.error("--layers takes 0 or more, --prompt-len 1 or more")
    return args


def turn_order(turns: int) -> list[str]:
    """parent, change, change, parent, ...: each version runs first in half
    of the turns."""
    order = []
    for i in range(turns):
        order += ["parent", "change"] if i % 2 == 0 else ["change", "parent"]
    return order


def summarize(runs: list[dict]) -> dict:
    """For each tag: the median, least and largest of each of SUMMARY_KEYS
    over its runs, and the run count."""
    out = {}
    for tag in dict.fromkeys(run["tag"] for run in runs):
        mine = [run for run in runs if run["tag"] == tag]
        out[tag] = {"runs": len(mine)}
        for key in SUMMARY_KEYS:
            values = [run[key] for run in mine]
            out[tag][key] = {"median": statistics.median(values), "min": min(values), "max": max(values)}
    return out


def flash_ms(times: dict[str, tuple[float, int]]) -> float:
    """Device ms of the flash kernels (any version's: the main kernel and the
    split pass) in ``device_times``' table."""
    return sum(ms for name, (ms, _) in times.items() if "flash" in name or "split_kv" in name)


def host_waits(prof) -> dict[str, int]:
    """Counts of the HOST_WAITS runtime calls among the profiler's events."""
    return {e.key: e.count for e in prof.key_averages() if e.key in HOST_WAITS}


def run_turns(args) -> int:
    here = Path(__file__).resolve()
    srcs = {"parent": args.parent, "change": args.src}
    runs = []
    for tag in turn_order(args.turns):
        cmd = [sys.executable, str(here), "--src", srcs[tag], "--tag", tag, "--repeats", str(args.repeats),
               "--top", str(args.top), "--arch", args.arch, "--layers", str(args.layers),
               "--prompt-len", str(args.prompt_len)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise RuntimeError(f"profile_serve: the {tag} run exited {proc.returncode}")
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        print(lines[-1], flush=True)
        runs.append(json.loads(lines[-1]))
    print(json.dumps({"summary": summarize(runs), "order": turn_order(args.turns)}), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.turns:
        return run_turns(args)
    sys.path.insert(0, args.src)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_serve: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.serve.decode import generate, make_prefill

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    build.load("flash_attention")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model, prompt, _, _ = serve.setup(cfg, BATCH, args.prompt_len, dev, seed=0)
    prefill = make_prefill(model, args.prompt_len + TOKENS)
    batch = {"tokens": prompt}

    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = prefill(batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("profile_serve: non-finite prefill logits")
        return seconds

    cold = timed()
    ops.reset_launch_counts()
    walls = [timed() for _ in range(args.repeats)]
    launches = ops.launch_counts()["flash_attention"] / args.repeats
    out: dict = {}
    generate(model, prompt, steps=TOKENS, timings=out)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = timed()
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    times = device_times(prof)
    busy = sum(ms for ms, _ in times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[: args.top]
    moe = {}
    if cfg.moe is not None:
        with DropCount(BATCH) as drops:
            timed()
        moe = {"dropped_slots": [sum(c) for c in drops.by_call],
               "routed_slots": BATCH * args.prompt_len * cfg.moe.top_k}
    print(json.dumps({
        "tag": args.tag or args.src, "card": smi, "device": torch.cuda.get_device_name(0),
        "shape": f"{args.arch} full width, {cfg.num_layers} layers, B {BATCH}, prompt {args.prompt_len}",
        "params": sum(p.numel() for p in model.params.parameters()),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "cold_prefill_s": cold, "prefill_s": walls, "prefill_median_s": statistics.median(walls),
        "serve_prefill_s": out["prefill_s"], "serve_decode_s": out["decode_s"], "flash_launches": launches,
        "profiled_wall_s": wall, "device_busy_ms": busy, "device_busy_share": busy / 1e3 / wall,
        "flash_ms": flash_ms(times), "host_waits": host_waits(prof), "top": [[name[:70], ms, count] for name, (ms, count) in top],
        **moe,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
