"""Ranks of the port's LM on a ``(data, model)`` mesh, for tests/test_torch_lm_mesh.py.

    PYTHONPATH=src python tests/_torch_lm_mesh_child.py WORLD INPUTS.npz OUTDIR

Starts WORLD processes (``spawn``), joined in one gloo group through a
``file://`` store in OUTDIR. On each mesh of ``MESHES`` (``make_lm_mesh``
over the default group) every rank serves each case of ``CASES`` with the
reference's weights from INPUTS (``convert.model_params_from_reference``,
cut by the mesh): the prefill and ``STEPS`` greedy decode steps, with the
logits and every cache joined back to whole tensors after each, its MoE
routes, and the unsharded port's logits on the whole batch fed the same
tokens. It
also runs the ``convert`` round trip, a mesh ``init`` against the one-card
``init`` cut, the data-sharded MoE drops against the unsharded ones, a
Mamba mixer at d_in 6 at (1, 4) (``_mamba6``), the raises, and
``launch.serve.main`` on a mesh. Each rank writes
``OUTDIR/rank<r>.npz`` and ``OUTDIR/rank<r>.json``. Imports only
``repro_torch`` (no JAX, nothing of the reference package).
"""
from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import sys
from pathlib import Path

JOIN_TIMEOUT_S = 240
WORLD = 4
MESHES = [(1, 4), (2, 2)]  # (data, model)
CASES = {"jamba24": ("jamba-v0.1-52b", 24), "jamba32": ("jamba-v0.1-52b", 32),
         "granite24": ("granite-moe-1b-a400m", 24),
         # qwen2 at 6 heads (OVERRIDES): at model 4 the prompt of 24 takes the sequence-parallel residual,
         # the prompt of 22 the replicated attention; MLA with its MoE; RWKV-6's token loop and chunks of 16
         "qwen24": ("qwen2-0.5b", 24), "qwen22": ("qwen2-0.5b", 22), "deepseek24": ("deepseek-v2-236b", 24),
         "rwkv24": ("rwkv6-1.6b", 24), "rwkv32": ("rwkv6-1.6b", 32)}
# the reduced configs' changes: reduced qwen2's 4 heads divide every axis, 6 do not divide 4
OVERRIDES = {"qwen2-0.5b": dict(num_heads=6, num_kv_heads=2)}
# a Mamba mixer whose d_in (6) does not divide a model axis of 4 while 2·d_in does: reduced jamba's
# mixer at d_model 3, on the (1, 4) mesh, against the reference's mixer
MAMBA6 = dict(d_model=3)
MAMBA6_L, MAMBA6_STEPS = 12, 2
# a combination no registry config reaches: Mamba layers in a model whose residual is sequence-cut
REFUSED = ("jamba-v0.1-52b", dict(num_heads=6, num_kv_heads=2))
STEPS = 3
CACHE_LEN = 32 + STEPS  # one cache length for every case, as the reference's runs use
DROP_CAPACITY = 10  # slots an expert in the drop check: 48 tokens x 2 slots over 4 experts overflow it
DROP_FACTOR = 0.5  # the MoE FFN's capacity factor in the drop check (12 slots an expert)
SERVE_ARGS = ["--device", "cpu", "--arch", "jamba-v0.1-52b", "--batch", "4", "--prompt-len", "32", "--tokens", "4"]


def case_config(arch: str, get_config, reduced_config, **changes):
    """The reduced config of ``arch`` with its ``OVERRIDES`` (and ``changes``):
    the port's or the reference's, by the ``get_config`` and ``reduced_config`` given."""
    import dataclasses

    return dataclasses.replace(reduced_config(get_config(arch)), **{**OVERRIDES.get(arch, {}), **changes})


def tree(z: dict, prefix: str) -> dict:
    """The nested dict of the arrays of ``z`` under ``prefix`` ("a/b/c" keys)."""
    out: dict = {}
    for key, val in z.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = val
    return out


def _serve_case(cfg, ref, prompt, mesh, steps: int) -> tuple[dict, dict]:
    """Prefill and ``steps`` greedy decode steps on the mesh; every logits
    tensor and cache joined to the whole batch's, the tokens fed, and the
    MoE routes of this rank's rows."""
    import torch

    from repro_torch.convert import model_params_from_reference
    from repro_torch.launch.mesh import make_axes
    from repro_torch.models import moe
    from repro_torch.models.layers import P
    from repro_torch.models.transformer import Model
    from repro_torch.serve.decode import decode_input_specs

    model = Model(cfg, ax=make_axes(mesh, prompt.shape[0]), mesh=mesh)
    model.params = model_params_from_reference(ref, cfg, "cpu", mesh=mesh)
    sh, ax = model.sh, model.ax
    rows = decode_input_specs(model)["tokens"]
    specs = model.cache_specs()
    out: dict = {}
    routes: list = []

    def keep(step: int, logits, caches) -> None:
        out[f"logits{step}"] = sh.join(logits, P(ax.b, None, None))
        for si, reps in caches.items():
            for r, layers in enumerate(reps):
                for name, cache in layers.items():
                    for field, t, spec in zip(cache._fields, cache, specs[si][name]):
                        out[f"caches{step}/{si}.{r}.{name}.{field}"] = sh.join(t, P(*spec[1:]))

    real = moe.route

    def spy(params, xt, cfg, capacity, sh=None):
        r = real(params, xt, cfg, capacity, sh)
        routes.append((r.expert_ids.clone(), r.keep.clone()))
        return r

    moe.route = spy
    try:
        l = prompt.shape[1]
        tokens = sh.cut(torch.from_numpy(prompt).long(), rows)
        logits, caches = model.prefill({"tokens": tokens}, cache_len=CACHE_LEN)
        local = {f"{si}.{r}.{name}.{field}": t for si, reps in caches.items() for r, layers in enumerate(reps)
                 for name, cache in layers.items() for field, t in zip(cache._fields, cache)}
        keep(0, logits, caches)
        for i in range(steps):
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            out[f"tokens{i}"] = sh.join(tok, rows)
            logits, caches = model.decode_step(caches, tok, l + i)
            keep(i + 1, logits, caches)
    finally:
        moe.route = real
    # the unsharded port on the whole batch, fed the same tokens
    plain = Model(cfg)
    plain.params = model_params_from_reference(ref, cfg, "cpu")
    logits, caches = plain.prefill({"tokens": torch.from_numpy(prompt).long()}, cache_len=CACHE_LEN)
    out["unsharded_logits0"] = logits
    for i in range(steps):
        logits, caches = plain.decode_step(caches, out[f"tokens{i}"], l + i)
        out[f"unsharded_logits{i + 1}"] = logits
    if routes:
        out["route_ids"] = torch.cat([ids for ids, _ in routes])
        out["route_keep"] = torch.cat([kept for _, kept in routes])
    zeros = model.cache_init(prompt.shape[0], CACHE_LEN)
    return out, {"cache_dims": {name: list(t.shape) for name, t in local.items()},
                 "cache_init_dims": {f"{si}.{r}.{name}.{field}": list(t.shape) for si, reps in zeros.items()
                                     for r, layers in enumerate(reps) for name, cache in layers.items()
                                     for field, t in zip(cache._fields, cache)}}


def _rank_main(rank: int, world: int, inputs: str, outdir: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.convert import model_params_from_reference, model_params_to_reference
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_axes, make_lm_mesh
    from repro_torch.models import moe
    from repro_torch.models.layers import P
    from repro_torch.models.transformer import Model

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=(Path(outdir) / "store").as_uri(), world_size=world, rank=rank)
    try:
        z = dict(np.load(inputs))
        cfgs = {arch: case_config(arch, get_config, reduced_config) for arch, _ in CASES.values()}
        refs = {arch: tree(z, f"params/{arch}/") for arch in cfgs}
        out: dict = {}
        info: dict = {"raises": {}}

        for data, model_size in MESHES:
            tag = f"{data}x{model_size}"
            with make_lm_mesh(data, model_size, "cpu") as mesh:
                info[f"{tag}/coords"] = [mesh.data_index, mesh.model_index, mesh.data_count, mesh.model_count]
                for case, (arch, _) in CASES.items():
                    got, meta = _serve_case(cfgs[arch], refs[arch], z[f"prompt/{case}"], mesh, STEPS)
                    out.update({f"{tag}/{case}/{k}": v for k, v in got.items()})
                    info[f"{tag}/{case}"] = meta
                for arch, cfg in cfgs.items():
                    # the convert round trip, and a mesh init against the one-card init cut
                    m = Model(cfg, mesh=mesh)
                    back = model_params_to_reference(model_params_from_reference(refs[arch], cfg, "cpu", mesh), m)
                    flat_back, flat_ref = _flat(back), _flat(refs[arch])
                    info[f"{tag}/{arch}/round_trip"] = sorted(
                        k for k in flat_ref if k not in flat_back or not np.array_equal(flat_back[k], flat_ref[k]))
                    info[f"{tag}/{arch}/round_trip_extra"] = sorted(set(flat_back) - set(flat_ref))
                    drawn = m.init(torch.Generator().manual_seed(5))
                    whole = Model(cfg).init(torch.Generator().manual_seed(5))
                    cut = m.place(whole)
                    info[f"{tag}/{arch}/init_vs_cut"] = sorted(
                        name for (name, a), (_, b) in zip(drawn.named_parameters(), cut.named_parameters())
                        if not torch.equal(a, b))
                    info[f"{tag}/{arch}/local_shapes"] = {name: list(p.shape) for name, p in drawn.named_parameters()}
                if data > 1:  # the data-sharded MoE drops against the unsharded ones
                    cfg = cfgs["granite-moe-1b-a400m"]
                    m = Model(cfg, ax=make_axes(mesh, 2), mesh=mesh)
                    ffn = model_params_from_reference(refs["granite-moe-1b-a400m"], cfg, "cpu", mesh)["seg0"][0]["l0"]["ffn"]
                    whole_ffn = model_params_from_reference(refs["granite-moe-1b-a400m"], cfg, "cpu")["seg0"][0]["l0"]["ffn"]
                    xt = torch.from_numpy(z["drop/x"])  # (2, 24, d)
                    rows = P(m.ax.b, None, None)
                    mine = m.sh.cut(xt, rows)
                    r_all = moe.route(whole_ffn, xt.reshape(-1, cfg.d_model), cfg, DROP_CAPACITY)
                    r_mine = moe.route(ffn, mine.reshape(-1, cfg.d_model), cfg, DROP_CAPACITY, m.sh)
                    out[f"{tag}/drop/keep_all"], out[f"{tag}/drop/keep_mine"] = r_all.keep, r_mine.keep
                    out[f"{tag}/drop/buf_all"], out[f"{tag}/drop/buf_mine"] = r_all.buf_idx, r_mine.buf_idx
                    y_all, aux_all = moe.moe_ffn(whole_ffn, xt, cfg, DROP_FACTOR)
                    y_mine, aux_mine = moe.moe_ffn(ffn, mine, cfg, DROP_FACTOR, m.sh)
                    out[f"{tag}/drop/y_all"], out[f"{tag}/drop/y_mine"] = y_all, m.sh.join(y_mine, rows)
                    out[f"{tag}/drop/aux_all"] = torch.stack(list(aux_all))
                    out[f"{tag}/drop/aux_mine"] = torch.stack(list(aux_mine))
                if tag == "1x4":
                    out.update(_mamba6(z, mesh))
                    for arch in ("deepseek-v2-236b", "rwkv6-1.6b"):  # refused on a model axis before
                        Model(cfgs[arch], mesh=mesh)
                        info["raises"][arch] = "made"
                    try:
                        Model(case_config(REFUSED[0], get_config, reduced_config, **REFUSED[1]), mesh=mesh)
                        info["raises"]["refused"] = "made"
                    except NotImplementedError as err:
                        info["raises"]["refused"] = str(err)
        try:
            with make_lm_mesh(1, 2, "cpu"):
                info["raises"]["mesh_1x2"] = "made"
        except ValueError as err:
            info["raises"]["mesh_1x2"] = str(err)

        # the serve entry point on a (2, 2) mesh: every rank serves, rank 0 alone prints
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = serve.main([*SERVE_ARGS, "--data-shards", "2", "--model-shards", "2"])
        out["serve/tokens"] = res["tokens"]
        info["serve"] = {"mesh": res["mesh"], "printed": printed.getvalue()}

        np.savez(Path(outdir) / f"rank{rank}.npz", **{key: val.numpy() for key, val in out.items()})
        (Path(outdir) / f"rank{rank}.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()


def _mamba6(z: dict, mesh) -> dict:
    """Reduced jamba's Mamba mixer at d_model 3 (d_in 6) on ``mesh`` with the
    reference's weights: ``in_proj`` alone is cut; the forward and its
    state, ``MAMBA6_STEPS`` decode steps, and the gradients of sum(out · cot)
    (``in_proj``'s joined) and of the input."""
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.convert import to_tensor
    from repro_torch.models import mamba
    from repro_torch.models.layers import frozen
    from repro_torch.models.transformer import Model

    cfg = case_config("jamba-v0.1-52b", get_config, reduced_config, **MAMBA6)
    model = Model(cfg, mesh=mesh)
    whole = frozen(**{k: to_tensor(v, "cpu") for k, v in tree(z, "mamba6/params/").items()})
    params = model.place(whole, "seg0.0.l0.mixer")
    u = torch.from_numpy(z["mamba6/u"]).requires_grad_(True)
    for p in params.values():
        p.requires_grad_(True)
    y, state = mamba.mamba_forward_with_state(params, u, cfg, model.sh)
    torch.sum(y * torch.from_numpy(z["mamba6/cot"])).backward()
    state = mamba.MambaState(state.conv.detach(), state.ssm.detach())
    out = {"mamba6/y": y.detach(), "mamba6/conv": state.conv, "mamba6/ssm": state.ssm, "mamba6/du": u.grad,
           "mamba6/in_proj_shape": torch.tensor(params["in_proj"].shape)}
    out.update({f"mamba6/grad/{k}": g.detach() for k, g in model.gather(
        {f"seg0.0.l0.mixer.{k}": p.grad for k, p in params.items()}).items()})
    with torch.no_grad():
        for i in range(MAMBA6_STEPS):
            yi, state = mamba.mamba_decode(params, torch.from_numpy(z[f"mamba6/step{i}"]), state, cfg, model.sh)
            out[f"mamba6/decode{i}"] = yi
    return {f"1x4/{k}": v for k, v in out.items()}


def _flat(node, prefix: str = "") -> dict:
    out = {}
    for k, v in node.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def main(argv: list[str]) -> int:
    world, inputs, outdir = int(argv[0]), argv[1], argv[2]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(rank, world, inputs, outdir)) for rank in range(world)]
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
        print(f"lm mesh child FAILED world={world} exit codes {codes}")
        return 1
    print(f"lm mesh child OK world={world}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
