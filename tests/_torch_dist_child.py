"""Ranks of the port's distributed fits, for tests/test_torch_distributed.py.

    PYTHONPATH=src python tests/_torch_dist_child.py WORLD INPUTS.npz OUTDIR [DTYPE]

Starts WORLD processes (``spawn``), joined in one gloo group through a
``file://`` store in OUTDIR. Every rank runs every case on its own row
block of the inputs and writes its results to ``OUTDIR/rank<r>.npz``; the
test compares them with the reference. DTYPE (``float32`` by default, or
``bfloat16``) is the fits' dtype: the inputs' floats (all of them
representable at DTYPE) are cast to it, except the ring collectives'
operands; results are written widened to float32, with each one's dtype
and the dtypes the collectives carried in ``OUTDIR/rank<r>.json``.
Imports only ``repro_torch`` (no JAX, nothing of the reference package).
"""
from __future__ import annotations

import json
import multiprocessing
import sys
from pathlib import Path

JOIN_TIMEOUT_S = 120


def _wire_log(D, log: list) -> None:
    """Record the op and dtype of every sum the fits send over the group
    (``all_reduce``, and the pipelined schedule's reduce-scatter)."""
    import torch.distributed as dist

    all_reduce, reduce_scatter = dist.all_reduce, D._reduce_scatter

    def logged_all_reduce(x, *args, **kw):
        log.append(("all_reduce", str(x.dtype)))
        return all_reduce(x, *args, **kw)

    def logged_reduce_scatter(out, x, *args, **kw):
        log.append(("reduce_scatter", str(x.dtype)))
        return reduce_scatter(out, x, *args, **kw)

    D.dist.all_reduce = logged_all_reduce
    D._reduce_scatter = logged_reduce_scatter


def _rank_main(rank: int, world: int, inputs: str, outdir: str, dtype_name: str = "float32") -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.factorization import distributed as D
    from repro_torch.factorization.nmf import _nmf_masked

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=(Path(outdir) / "store").as_uri(), world_size=world, rank=rank)
    try:
        group = dist.group.WORLD
        dtype = getattr(torch, dtype_name)
        z = {key: torch.from_numpy(val) for key, val in np.load(inputs).items()}
        z = {key: val.to(dtype) if val.is_floating_point() and not key.startswith("ring") else val
             for key, val in z.items()}
        cfg = {key: int(z[key]) for key in ("k", "iters", "k_r", "iters_r", "k_eff", "k_pad", "iters_m", "chunk", "steps")}
        out = {}

        # ring collectives against all_reduce, leading dim not a multiple of the world size
        for name in ("ring_x", "ring_xi"):
            x = z[name][rank]
            want = x.clone()
            dist.all_reduce(want, group=group)
            out[f"{name}_all_reduce"] = want
            for form in (0, 1):
                out[f"{name}_psum_{form}"] = D.ring_psum(x, group, use_ppermute=bool(form))
                shard, lead, work = D.ring_psum_start(x, group, async_op=True)
                out[f"{name}_psum_async_{form}"] = D.ring_psum_finish(shard, lead, group, use_ppermute=bool(form),
                                                                      work=work)
            out[f"{name}_gather_0"] = D.ring_all_gather(x, group)
            out[f"{name}_gather_1"] = D.ring_all_gather(x, group, use_ppermute=True)

        wire: list = []
        _wire_log(D, wire)
        v_l = D.shard_rows(z["v"], group)
        for comm in D.COMM_MODES:
            res = D.distributed_nmf(v_l, cfg["k"], z["dnmf_w"], z["dnmf_h"], group, iters=cfg["iters"], comm=comm)
            out.update({f"nmf_{comm}_w": res.w, f"nmf_{comm}_h": res.h, f"nmf_{comm}_err": res.rel_error})
            w_l, err = D._dnmf_masked_local(v_l, cfg["k_eff"], z["mw"], z["mh"], cfg["k_pad"], cfg["iters_m"],
                                            group, comm=comm)
            out.update({f"masked_{comm}_w": w_l, f"masked_{comm}_err": err})
            w_l, h, err = D._dnmf_masked_chunk_local(
                v_l, D.shard_rows(z["w0"], group), z["h0"], cfg["k_eff"], cfg["k_pad"], cfg["chunk"], group,
                comm=comm, steps=torch.tensor(cfg["steps"]))
            out.update({f"chunk_{comm}_w": w_l, f"chunk_{comm}_h": h, f"chunk_{comm}_err": err})
        res = D.distributed_rescal(D.shard_rows(z["x"], group, dim=1), cfg["k_r"], z["drescal_a"], z["drescal_r"],
                                   group, iters=cfg["iters_r"])
        out.update({"rescal_a": res.a, "rescal_r": res.r, "rescal_err": res.rel_error})
        if rank == 0:  # the single-device masked fit on the same draws
            single = _nmf_masked(z["v"], cfg["k_eff"], z["mw"], z["mh"], cfg["k_pad"], cfg["iters_m"])
            out.update({"single_masked_w": single.w, "single_masked_err": single.rel_error})
        np.savez(Path(outdir) / f"rank{rank}.npz", **{
            key: (val.float() if val.dtype == torch.bfloat16 else val).numpy() for key, val in out.items()})
        (Path(outdir) / f"rank{rank}.json").write_text(json.dumps(
            {"dtypes": {key: str(val.dtype) for key, val in out.items()}, "wire": sorted(set(wire))}))
    finally:
        dist.destroy_process_group()


def main(argv: list[str]) -> int:
    world, inputs, outdir = int(argv[0]), argv[1], argv[2]
    dtype_name = argv[3] if len(argv) > 3 else "float32"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(rank, world, inputs, outdir, dtype_name)) for rank in range(world)]
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
        print(f"dist child FAILED world={world} exit codes {codes}")
        return 1
    print(f"dist child OK world={world}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
