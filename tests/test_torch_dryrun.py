"""The port's dry run (``repro_torch.launch.dryrun``), its pod axis and
``remat_group``, against the JAX reference.

The dry run: ``input_specs`` equals the reference's for every applicable
cell (and the twins of ``tests/test_dryrun_tools.py``); the bytes a rank
of parameters, optimizer state and cache equal the reference's block sizes
(``jax.eval_shape`` of its ``Model.init``, its ``apply_fsdp``,
``param_specs``, ``opt_state_specs`` and ``cache_specs`` under its
``Axes``) for every arch of the registry, at published widths
on both production meshes, without running a step; the FLOPs of reduced
qwen2 and granite at train and prefill equal the reference's
``parse_hlo(...)["dot_flops_per_device"]`` of a CPU ``jit`` within
``FLOPS_RTOL`` (1 %; no term differs by design, and they agree exactly);
the collective census of a reduced dense decode cell on a fake group of 4
ranks equals a hand count from the layer code, and the decode and train
cells' censuses equal those of the same cells on real gloo ranks; refused
cells (a stand-in refusal: ``check_mesh`` refuses no registry arch) record
``check_mesh``'s ``NotImplementedError``, inapplicable ones
skip, a second ``run_cell`` reads the record back, and no default process
group is left behind.

The pod axis runs in ``tests/_torch_lm_pod_child.py``: gloo ranks at
``(pod 2, data 2, model 1)`` and ``(2, 1, 2)`` train reduced jamba and
granite (2 microbatches, remat ``full``, FSDP over data; granite's router
aux weights raised, as in ``tests/test_torch_lm_train_mesh.py``) on the
reference's weights and batches, against the reference's
``jax.value_and_grad(loss_fn)`` here, accumulated over the same 2
microbatches as its train step accumulates: the loss at ``LOSS_RTOL`` and
every gradient joined to whole at that file's one-card tolerances, every
rank the same bits; granite's two steps of ``launch.train --pod-shards 2``
against the one-rank launcher at ``RUN_RTOL``. Reduced jamba served at
``(2, 1, 2)`` on the reference's weights gives the reference's greedy
tokens (``_torch_reference.reference_greedy_run``), and ``launch.serve
--pod-shards 2`` the one-rank launcher's.
``remat_group`` 2 and 3 (3 takes groups of 2 at a depth of 4 or 2 repeats)
give per-layer remat's loss and gradients bit for bit on the CPU.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.mesh import apply_fsdp as japply_fsdp  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import Axes as JAxes  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import SHAPES, ShapeConfig, registry, shape_applicable  # noqa: E402
from repro_torch.launch import dryrun, serve, train  # noqa: E402
from repro_torch.launch.mesh import make_axes, make_lm_mesh, make_production_mesh, named  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import P, Axes  # noqa: E402
from repro_torch.train.optimizer import OptState, init_opt_state  # noqa: E402
from repro_torch.train.train_step import TrainConfig, accumulate_grads, auto_train_config, make_train_step  # noqa: E402

from _torch_lm_mesh_child import _flat  # noqa: E402
from _torch_lm_pod_child import (B, CASES, CENSUS_CELLS, LAUNCHED, MESH_CASES, MICRO, SERVE_ARGS, SERVE_B,  # noqa: E402
                                 SERVE_L, SERVE_STEPS, TRAIN_ARGS, L, census_cell)
from _torch_lm_train_mesh_child import AUX  # noqa: E402
from _torch_reference import reference_greedy_run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
KEY = jax.random.PRNGKey(0)
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-5
RUN_RTOL = 1e-4
FLOPS_RTOL = 0.01
CHILD_TIMEOUT_S = 300
PLACED = ["deepseek-v2-236b", "granite-moe-1b-a400m", "h2o-danube-1.8b", "internvl2-1b", "jamba-v0.1-52b",
          "llama3-405b", "llama3.2-3b", "musicgen-large", "qwen2-0.5b", "rwkv6-1.6b"]
POD_TAGS = ["x".join(map(str, shape)) for shape in MESH_CASES]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this module: its steps are many small ops, which
    threads beside the other test workers' only slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_dryrun():
    """The reference's dry-run module, imported with this process's JAX
    backend already made and ``XLA_FLAGS`` put back: the module sets a
    512-device flag at import, which would reach later subprocesses."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


# ---------------------------------------------------------------------------
# the pod axis on gloo ranks: started first, read by the tests that need it
# ---------------------------------------------------------------------------
def _jcfg(case: str):
    jcfg = jconfigs.reduced_config(jconfigs.get_config(CASES[case]))
    if case == "granite":
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **AUX))
    return jcfg


def _batch(seed: int, vocab: int) -> dict[str, np.ndarray]:
    """A B × L training batch: next-token labels of random tokens."""
    toks = np.random.default_rng(seed).integers(0, vocab, (B, L + 1)).astype(np.int32)
    return {"tokens": toks[:, :L], "labels": toks[:, 1:].copy()}


def _reference_accumulated(jm, params, batch: dict[str, np.ndarray]):
    """(loss, grads) of the reference's train step's accumulation: the mean
    of ``jax.value_and_grad(loss_fn)`` over its ``MICRO`` microbatches."""
    vg = jax.jit(jax.value_and_grad(jm.loss_fn))
    mb = jstep._split_microbatches(batch, MICRO)
    parts = [vg(params, {k: v[i] for k, v in mb.items()}) for i in range(MICRO)]
    loss = sum(loss_i for loss_i, _ in parts) / MICRO
    grads = jax.tree.map(lambda *g: sum(g) / MICRO, *[g for _, g in parts])
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """({tag: [(npz, json) per rank]}, {case: reference (loss, grads)},
    {case: one-rank launcher run}, the one-rank launcher's served tokens,
    the reference's greedy run, {cell: census of the cell on a fake
    group}). The child's ranks start once the reference's weights are
    drawn; the reference's runs, the one-rank launchers and the fake-group
    censuses are made here while they work."""
    tmp = tmp_path_factory.mktemp("lm_pod")
    models = {case: jtf.Model(_jcfg(case), remat="none", dtype=jnp.float32) for case in CASES}
    params = {case: jax.tree.map(np.asarray, jax.jit(jm.init)(KEY)) for case, jm in models.items()}
    batches = {case: _batch(i + 21, jm.cfg.vocab_size) for i, (case, jm) in enumerate(models.items())}
    prompt = np.random.default_rng(20).integers(0, models["jamba"].cfg.vocab_size, (SERVE_B, SERVE_L)).astype(np.int32)
    inputs = {f"params/{case}/{k}": v for case, p in params.items() for k, v in _flat(p).items()}
    inputs.update({f"batch/{case}/{k}": v for case, b in batches.items() for k, v in b.items()})
    inputs["serve/prompt"] = prompt
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (SRC, os.environ.get("PYTHONPATH")) if p),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_lm_pod_child.py"), str(tmp / "inputs.npz"),
                               str(tmp), tag], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for tag in POD_TAGS]  # one spawn a mesh shape, all at once
    try:
        reference = {case: _reference_accumulated(jm, params[case], batches[case]) for case, jm in models.items()}
        jamba = models["jamba"]
        greedy = reference_greedy_run(jamba, params["jamba"], jax.jit(jamba.decode_step), prompt, SERVE_STEPS,
                                      SERVE_L + SERVE_STEPS)
        launcher = {case: train.main(["--arch", CASES[case], *TRAIN_ARGS]) for case in LAUNCHED}
        served = serve.main(SERVE_ARGS)["tokens"].numpy()
        fake = {}
        for arch, kind, seq, batch in CENSUS_CELLS:
            with dryrun.fake_mesh(2, 2) as mesh:
                fake[f"{arch}/{kind}"] = census_cell(arch, kind, seq, batch, mesh)["collectives"]
    finally:
        done = [(proc, *proc.communicate(timeout=CHILD_TIMEOUT_S)) for proc in procs]
    for proc, stdout, stderr in done:
        assert proc.returncode == 0, f"child failed:\n{stdout}\n{stderr}"
        assert "lm pod child OK" in stdout
    ranks = {tag: [(dict(np.load(tmp / tag / f"rank{r}.npz")), json.loads((tmp / tag / f"rank{r}.json").read_text()))
                   for r in range(4)] for tag in POD_TAGS}
    return ranks, reference, launcher, served, greedy, fake


POD_CASES = [("x".join(map(str, shape)), case) for shape, cases in MESH_CASES.items() for case in cases]


@pytest.mark.parametrize("tag,case", POD_CASES)
def test_a_pod_mesh_trains_like_one_rank(pod, tag, case):
    """The loss on every rank, and every gradient joined to whole, against
    one rank of the reference: its unsharded loss and gradients accumulated
    over the same microbatches: the pod axis's reductions (whole leaves over pod × data,
    FSDP leaves over pod after their reduce-scatter over data, all divided
    by dp; the loss and the MoE aux sums over pod × data)."""
    ranks, reference = pod[:2]
    want_loss, want = reference[case]
    want = _flat(want)
    for arrays, info in ranks[tag]:
        np.testing.assert_allclose(float(arrays[f"{case}/loss"]), want_loss, rtol=LOSS_RTOL)
        assert (info[f"{case}/fsdp_leaves"] > 0) == (tag == "2x2x1")
    arrays = ranks[tag][0][0]
    assert sorted(k[len(f"{case}/grad/"):] for k in arrays if k.startswith(f"{case}/grad/")) == sorted(want)
    for name, ref in want.items():
        got = arrays[f"{case}/grad/{name}"]
        scale = float(np.abs(ref).max())
        assert scale > 0, name
        assert np.linalg.norm(got - ref) <= GRAD_NORM_RTOL * np.linalg.norm(ref), name
        np.testing.assert_allclose(got, ref, rtol=GRAD_RTOL, atol=GRAD_ATOL_SCALE * scale, err_msg=name)


@pytest.mark.parametrize("tag,case", [(tag, case) for tag, case in POD_CASES if case in LAUNCHED])
def test_pod_mesh_steps_follow_the_one_rank_launcher(pod, tag, case):
    """Two steps of ``launch.train --pod-shards 2`` against the one-rank launcher."""
    ranks, _, launcher = pod[:3]
    want = launcher[case]
    p, d, m = (int(n) for n in tag.split("x"))
    for _, info in ranks[tag]:
        got = info[f"{case}/train"]
        assert got["mesh"] == {"pod": p, "data": d, "model": m} and got["microbatches"] == MICRO
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=RUN_RTOL)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=RUN_RTOL)


@pytest.mark.parametrize("tag", POD_TAGS[:2])
def test_every_rank_of_a_pod_mesh_returns_the_same_bits(pod, tag):
    """Every rank's loss bits and joined gradients, and the launcher's numbers;
    the ranks' coordinates are the pod-major (pod, data, model) layout."""
    ranks = pod[0][tag]
    p, d, m = (int(n) for n in tag.split("x"))
    assert [info["coords"] for _, info in ranks] == [[i // (d * m), i // m % d, i % m] for i in range(4)]
    first = ranks[0]
    for arrays, info in ranks[1:]:
        for key in first[0]:
            if not key.startswith("serve/"):
                np.testing.assert_array_equal(arrays[key], first[0][key], err_msg=key)
        for case in set(MESH_CASES[(p, d, m)]) & set(LAUNCHED):
            assert info[f"{case}/train"] == first[1][f"{case}/train"]


def test_a_pod_mesh_serves_the_one_rank_tokens(pod):
    """Greedy serving at (pod 2, data 1, model 2): on the reference's
    weights each pod's ranks return their rows of the reference's
    unsharded greedy tokens, and ``launch.serve --pod-shards 2`` its rows of the one-rank
    launcher's; the model group alike."""
    ranks, _, _, served, greedy, _ = pod
    want = np.concatenate(greedy["tokens"], axis=1)
    rows = SERVE_B // 2
    for r, (arrays, info) in enumerate(ranks["2x1x2"]):
        block = slice((r // 2) * rows, (r // 2 + 1) * rows)
        assert info["serve/mesh"] == {"pod": 2, "data": 1, "model": 2}
        np.testing.assert_array_equal(arrays["serve/reference_weights"], want[block])
        np.testing.assert_array_equal(arrays["serve/tokens"], served[block])


@pytest.mark.parametrize("cell", [f"{a}/{k}" for a, k, _, _ in CENSUS_CELLS])
def test_the_census_of_a_fake_group_is_that_of_real_ranks(pod, cell):
    """The same cell at (data 2, model 2): on a fake group of 4 ranks, on
    ``meta``, and on 4 gloo ranks with real tensors, every rank."""
    ranks, fake = pod[0], pod[-1]
    assert fake[cell]["total_bytes"] > 0
    for _, info in ranks["1x2x2"]:
        assert info["census"][cell] == fake[cell]


def test_the_census_of_a_dense_decode_is_the_layer_codes_count():
    """Reduced musicgen's decode step at (data 2, model 2), fp32: the
    embedding's masked lookup, each layer's attention output and MLP
    all-reduced over the model group, the logits' vocabulary blocks
    all-gathered; FSDP cuts nothing at the default ``fsdp_min_elems``."""
    arch, kind, seq, batch = CENSUS_CELLS[0]
    assert kind == "decode"
    cfg = configs.reduced_config(configs.get_config(arch))
    rows = batch // 2  # the batch cut over 2 data ranks
    hidden = rows * 1 * cfg.d_model * 4  # one token a row, fp32
    logits = rows * 1 * cfg.vocab_size * 4
    assert cfg.num_kv_heads % 2 == 0 and cfg.d_ff % 2 == 0 and cfg.vocab_size % 2 == 0
    with dryrun.fake_mesh(2, 2) as mesh:
        rec = census_cell(arch, kind, seq, batch, mesh)
    n_reduce = 1 + 2 * cfg.num_layers
    assert rec["collectives"] == {"by_op": {"all-reduce": {"count": n_reduce, "bytes": n_reduce * hidden},
                                            "all-gather": {"count": 1, "bytes": logits}},
                                  "total_bytes": n_reduce * hidden + logits}


# ---------------------------------------------------------------------------
# the dry run against the reference
# ---------------------------------------------------------------------------
def test_input_specs_cover_every_cell():
    """Twin of tests/test_dryrun_tools.py::test_input_specs_cover_every_cell."""
    for arch in registry().values():
        for shape in SHAPES.values():
            if not shape_applicable(arch, shape)[0]:
                continue
            ins = dryrun.input_specs(arch, shape)
            assert "tokens" in ins
            assert ins["tokens"].shape[0] == shape.global_batch
            if arch.input_mode == "embeddings" and shape.kind != "decode":
                assert ins["embeds"].shape == (shape.global_batch, shape.seq_len, arch.d_model)


def test_input_specs_are_the_references():
    """Every applicable cell's inputs: the reference's names, shapes and dtypes."""
    jdryrun = _reference_dryrun()
    for name, arch in registry().items():
        for sname, shape in SHAPES.items():
            if not shape_applicable(arch, shape)[0]:
                continue
            got = dryrun.input_specs(arch, shape)
            want = jdryrun.input_specs(jconfigs.get_config(name), jconfigs.SHAPES[sname])
            assert sorted(got) == sorted(want), (name, sname)
            for k, v in want.items():
                assert v.shape == tuple(got[k].shape), (name, sname, k)
                assert str(v.dtype) == str(got[k].dtype).removeprefix("torch."), (name, sname, k)
                assert got[k].is_meta


def test_long_500k_applicability():
    """Twin of tests/test_dryrun_tools.py::test_long_500k_applicability."""
    reg = registry()
    runs = {n for n in reg if shape_applicable(reg[n], SHAPES["long_500k"])[0]}
    assert runs == {"h2o-danube-1.8b", "jamba-v0.1-52b", "rwkv6-1.6b"}


def test_the_production_meshes_and_named():
    """``make_production_mesh`` over a fake group at rank 0: the reference's
    shapes and batch axes; ``named`` pairs each spec with the mesh, and a
    spec's ``shard_shape`` is the block ``Shard.cut`` cuts."""
    for multi, world, shape in ((False, 256, {"data": 16, "model": 16}),
                                (True, 512, {"pod": 2, "data": 16, "model": 16})):
        with dryrun.fake_group(world), make_production_mesh(multi, device="cpu") as mesh:
            assert mesh.shape == shape and (mesh.pod_index, mesh.data_index, mesh.model_index) == (0, 0, 0)
            ax = make_axes(mesh, 256)
            assert ax.b == (("pod", "data") if multi else ("data",)) and make_axes(mesh, 1).b is None
            tree = named(mesh, {"w": P(ax.b, "model"), "o": OptState(P(), {"m": P("data")}, {"v": P(None)})})
            assert tree["w"].shard_shape((64, 32)) == ((2 if multi else 4), 2)
            assert tree["o"].m["m"].shard_shape((32, 3)) == (2, 3) and tree["o"].step.shard_shape(()) == ()
            model = tf.Model(configs.get_config("granite-moe-1b-a400m"), ax=ax, mesh=mesh)
            whole = torch.empty((64, 32), device="meta")
            assert tuple(model.sh.cut(whole, P(ax.b, "model")).shape) == tree["w"].shard_shape((64, 32))
            with pytest.raises(ValueError, match="does not split"):
                tree["w"].shard_shape((40, 32))
    assert not torch.distributed.is_initialized()


def _reference_block_bytes(specs, shapes, sizes: dict[str, int]) -> int:
    total = 0
    for spec, leaf in zip(jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP)), jax.tree.leaves(shapes)):
        n = 1
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * (len(leaf.shape) - len(spec))):
            names = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
            blocks = math.prod(sizes[name] for name in names)
            assert dim % blocks == 0
            n *= dim // blocks
        total += n * leaf.dtype.itemsize
    return total


def _reference_bytes(arch: str, multi: bool, shape_names: list[str]) -> dict[str, dict[str, int]]:
    """The reference's blocks a rank of each cell's parameters, optimizer
    state (train) and cache (decode): dimension ÷ product of axis sizes."""
    jcfg = jconfigs.get_config(arch)
    sizes = {"pod": 2 if multi else 1, "data": 16, "model": 16}
    dp = sizes["pod"] * sizes["data"]
    out = {}
    for sname in shape_names:
        shape = jconfigs.SHAPES[sname]
        batch = ("pod", "data") if multi else ("data",)
        ax = JAxes(batch=batch if shape.global_batch % dp == 0 else (), model="model", model_size=16)
        jm = jtf.Model(jcfg, ax)
        if not out:  # the parameters' blocks do not depend on the batch axes
            pshape = jax.eval_shape(jm.init, KEY)
            pspecs = japply_fsdp(jm.param_specs(), pshape, fsdp_axis="data", fsdp_size=16)
            params = _reference_block_bytes(pspecs, pshape, sizes)
        cell = out[sname] = {"params": params}
        if shape.kind == "train":
            tcfg = jstep.auto_train_config(jcfg.param_count(), shape.global_batch, dp, moe=jcfg.moe is not None)
            oshape = jax.eval_shape(lambda p: jopt.init_opt_state(p, tcfg.opt), pshape)
            cell["opt_state"] = _reference_block_bytes(jopt.opt_state_specs(pspecs, ax, zero1=False), oshape, sizes)
        if shape.kind == "decode":
            cshape = jax.eval_shape(lambda: jm.cache_init(shape.global_batch, shape.seq_len))
            cell["cache"] = _reference_block_bytes(jm.cache_specs(), cshape, sizes)
    return out


@pytest.mark.parametrize("arch", PLACED)
def test_bytes_a_rank_are_the_references_blocks(arch):
    """At published widths, bf16, on both production meshes: the dry run's
    parameter, optimizer-state and cache bytes a rank (``argument_bytes``
    of the cell's model, placed; no step run)."""
    cfg = configs.get_config(arch)
    shapes = ["train_4k", "decode_32k"] + (["long_500k"] if cfg.subquadratic else [])
    for multi in (False, True):
        for sname, want in _reference_bytes(arch, multi, shapes).items():
            shape = SHAPES[sname]
            with dryrun.fake_group(512 if multi else 256), make_production_mesh(multi, device="cpu") as mesh:
                model = dryrun.cell_model(cfg, shape, mesh)
                model.init_meta()
                tcfg = auto_train_config(cfg.param_count(), shape.global_batch, mesh.pod_count * mesh.data_count,
                                         moe=cfg.moe is not None) if shape.kind == "train" else None
                got = dryrun.argument_bytes(model, mesh, shape, tcfg, dryrun.input_specs(cfg, shape))
            assert {k: got[k] for k in want} == want, (sname, multi)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch,kind", [(a, k) for a in ("qwen2-0.5b", "granite-moe-1b-a400m")
                                       for k in ("train", "prefill")])
def test_flops_are_the_references_dot_flops(arch, kind):
    """Reduced, bf16, B 4, L 32 on a (1, 1) mesh, the dry run's defaults
    (remat ``full`` and ``auto_train_config`` for train): the port's
    ``FlopCounterMode`` total against the reference's
    ``dot_flops_per_device`` of its compiled step."""
    jdryrun = _reference_dryrun()
    b, l = 4, 32
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    jm = jtf.Model(jcfg, remat="full" if kind == "train" else "none")
    params = jax.eval_shape(jm.init, KEY)
    ins = {"tokens": jax.ShapeDtypeStruct((b, l), jnp.int32)}
    if kind == "train":
        ins["labels"] = jax.ShapeDtypeStruct((b, l), jnp.int32)
        tcfg = jstep.auto_train_config(jcfg.param_count(), b, 1, moe=jcfg.moe is not None)
        opt = jax.eval_shape(lambda p: jopt.init_opt_state(p, tcfg.opt), params)
        compiled = jax.jit(jstep.make_train_step(jm, tcfg)).lower(params, opt, ins).compile()
    else:
        compiled = jax.jit(lambda p, batch: jm.prefill(p, batch, cache_len=l)).lower(params, ins).compile()
    want = jdryrun.parse_hlo(compiled.as_text())["dot_flops_per_device"]
    cfg = configs.reduced_config(configs.get_config(arch))
    shape = ShapeConfig("flops", l, b, kind)
    with dryrun.fake_mesh(1, 1) as mesh:
        rec = dryrun.measure(dryrun.cell_model(cfg, shape, mesh), shape, mesh)
    assert want > 0 and abs(rec["flops"] - want) <= FLOPS_RTOL * want


def test_a_reduced_cell_on_a_pod_mesh_is_recorded():
    """Reduced granite's train step on a fake (pod 2, data 2, model 2) mesh:
    the blocks' bytes, FSDP's gathers and reduce-scatters in the census,
    and a peak at least the arguments it holds."""
    cfg = configs.reduced_config(configs.get_config("granite-moe-1b-a400m"))
    shape = ShapeConfig("pod", 16, 8, "train")
    with dryrun.fake_mesh(2, 2, pod=2) as mesh:
        model = tf.Model(cfg, dtype=torch.bfloat16, ax=make_axes(mesh, 8), mesh=mesh, fsdp_min_elems=1 << 10)
        rec = dryrun.measure(model, shape, mesh)
    mem = rec["memory"]
    whole = sum(math.prod(s) for s in tf.Model(cfg).leaf_shapes().values())
    assert rec["mesh_shape"] == {"pod": 2, "data": 2, "model": 2} and rec["dtype"] == "bfloat16"
    assert whole // 4 <= rec["params_per_rank"] < whole  # leaves cut over data and model, some whole
    assert 2 * rec["params_per_rank"] <= mem["params"] < 4 * rec["params_per_rank"]  # bf16, some fp32 leaves
    assert mem["peak_bytes"] >= mem["params"] + mem["opt_state"] and rec["flops"] > 0
    assert {"all-reduce", "all-gather", "reduce-scatter"} <= set(rec["collectives"]["by_op"])
    assert not torch.distributed.is_initialized()


def test_the_dry_runs_peak_is_the_steps_own():
    """``measure``'s peak is the train step's, tracked with no other
    reference held: the moments AdamW replaces are freed as it goes (a
    held list of the old ones once added their bytes to the peak). On a
    real one-rank group, so the step runs on CPU tensors."""
    from torch.distributed._tools.mem_tracker import MemTracker

    cfg = configs.reduced_config(configs.get_config("granite-moe-1b-a400m"))
    shape, tcfg = ShapeConfig("peak", 16, 4, "train"), TrainConfig(microbatches=2)
    with make_lm_mesh(1, 1, "cpu") as mesh:
        rec = dryrun.measure(dryrun.cell_model(cfg, shape, mesh, torch.float32), shape, mesh, tcfg)
        model = tf.Model(cfg, remat="full", ax=make_axes(mesh, shape.global_batch), mesh=mesh)
        gen = torch.Generator().manual_seed(0)
        params = model.init(gen)
        batch = dryrun._drawn(dryrun.input_specs(cfg, shape), cfg.vocab_size, gen)
        opt = init_opt_state(params, tcfg.opt)
        tracker = MemTracker()
        tracker.track_external(params, *opt.m.values(), *opt.v.values())
        with tracker:
            make_train_step(model, tcfg)(params, opt, batch)
    want = sum(dev["Total"] for dev in tracker.get_tracker_snapshot("peak").values())
    assert rec["memory"]["peak_bytes"] == want
    assert want < rec["memory"]["peak_bytes"] + rec["memory"]["opt_state"] // 2
    assert not torch.distributed.is_initialized()


def _refusing(monkeypatch, arch: str) -> None:
    """``check_mesh`` refusing ``arch`` as it refuses a combination with no
    mesh path (the registry's archs have one at every production model size)."""
    real = tf.check_mesh

    def check_mesh(cfg, ax):
        if cfg.name == arch and ax.model_size > 1:
            raise NotImplementedError(f"{cfg.name} on a model axis of {ax.model_size} ranks: a refused "
                                      "combination has no mesh path yet (ROADMAP M5)")
        real(cfg, ax)

    monkeypatch.setattr(tf, "check_mesh", check_mesh)


def test_refused_and_inapplicable_cells_and_reading_back(tmp_path, capsys, monkeypatch):
    """``run_cell``: a cell ``check_mesh`` refuses (here by a stand-in: no
    registry arch is refused any more) records ``error`` with its
    ``NotImplementedError``; an inapplicable one skips; a second call reads
    the record back; ``main`` prints the reference's lines. No default
    process group is left behind."""
    _refusing(monkeypatch, "qwen2-0.5b")
    err = dryrun.run_cell("qwen2-0.5b", "decode_32k", True, str(tmp_path))
    with pytest.raises(NotImplementedError) as want:
        tf.check_mesh(configs.get_config("qwen2-0.5b"), Axes(model_size=16))
    assert err["status"] == "error" and err["error"] == f"NotImplementedError: {want.value}"
    assert err["cell"] == "qwen2-0.5b__decode_32k__multi" and err["params"] > 0
    skip = dryrun.run_cell("qwen2-0.5b", "long_500k", False, str(tmp_path))
    assert skip["status"] == "skip" and skip["reason"] == shape_applicable(
        configs.get_config("qwen2-0.5b"), SHAPES["long_500k"])[1]
    path = tmp_path / "qwen2-0.5b__decode_32k__multi.json"
    path.write_text(json.dumps(dict(err, marker=1)))
    assert dryrun.run_cell("qwen2-0.5b", "decode_32k", True, str(tmp_path))["marker"] == 1
    assert "marker" not in dryrun.run_cell("qwen2-0.5b", "decode_32k", True, str(tmp_path), force=True)
    assert not torch.distributed.is_initialized()
    _refusing(monkeypatch, "rwkv6-1.6b")
    counts = dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "long_500k", "--mesh", "both", "--out", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert counts == {"ok": 0, "error": 2, "skip": 0} and out[-1] == "done: ok=0 err=2 skip=0"
    assert out[0].startswith("[error] rwkv6-1.6b__long_500k__single NotImplementedError: ")
    assert not torch.distributed.is_initialized()


def test_chip_smokes_dry_run_gates(tmp_path, monkeypatch):
    """``chip_smoke.check_dry_run`` passes a refused cell's (``check_mesh``
    refusing by a stand-in) and an inapplicable cell's records and fails
    one whose error is not ``check_mesh``'s refusal."""
    _refusing(monkeypatch, "llama3.2-3b")
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    records = [dryrun.run_cell("llama3.2-3b", "prefill_32k", False, str(tmp_path)),
               dryrun.run_cell("llama3.2-3b", "long_500k", True, str(tmp_path))]
    lines = []
    chip_smoke.check_dry_run([(records, 0.0)], lines.append)
    assert '"ok": 0, "error": 1, "skip": 1' in lines[-1]
    wrong = dict(records[0], error="NotImplementedError: something else")
    with pytest.raises(AssertionError, match="want error"):
        chip_smoke.check_dry_run([([wrong], 0.0)], lines.append)


def test_the_meta_scan_has_the_loops_shapes_and_flops():
    """``_ssm_scan`` on ``meta`` (one pass over the sequence) against the
    token loop on the CPU: the same shapes, dtypes and contraction FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    b, l, d_in, n = 2, 32, 8, 4
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=gen) for s in ((b, l, d_in), (b, l, d_in), (b, l, n), (b, l, n), (d_in, n),
                                                     (b, d_in, n))]
    flops = []
    outs = []
    for device in ("cpu", "meta"):
        with FlopCounterMode(display=False) as counter:
            outs.append(mamba._ssm_scan(*(t.to(device) for t in args)))
        flops.append(counter.get_total_flops())
    for got, want in zip(outs[1], outs[0]):
        assert got.is_meta and got.shape == want.shape and got.dtype == want.dtype
    assert flops[0] == flops[1] == 2 * b * l * d_in * n


@pytest.mark.parametrize("b,l,d_in,n", [(2, 48, 8, 4), (1, 32, 16, 16), (3, 7, 8, 16)])
def test_the_meta_scan_holds_the_loops_bytes_without_gradients(b, l, d_in, n):
    """Under ``inference_mode`` (prefill) the ``meta`` scan's ``MemTracker``
    peak is the CPU token loop's to within one token's (B, d_in) fp32
    output: a few (B, d_in, n) states and the outputs, no (B, L, d_in, n)
    tensor (which the batched form, kept for autograd, holds)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=gen) for s in ((b, l, d_in), (b, l, d_in), (b, l, n), (b, l, n), (d_in, n),
                                                     (b, d_in, n))]
    peaks = {}
    for device in ("cpu", "meta"):
        on = [t.to(device) for t in args]
        with torch.inference_mode():
            tracker = MemTracker()
            tracker.track_external(*on)
            with tracker:
                mamba._ssm_scan(*on)
        peaks[device] = tracker.get_tracker_snapshot("peak")[torch.device(device)]["Total"]
    assert abs(peaks["meta"] - peaks["cpu"]) <= b * d_in * 4, peaks


# ---------------------------------------------------------------------------
# remat_group
# ---------------------------------------------------------------------------
def test_remat_group_takes_the_largest_divisor_at_most_g():
    """The reference's rule, and one checkpoint a group around the per-layer ones."""
    assert [tf._group_of(6, g) for g in (1, 2, 3, 4, 5, 6, 7)] == [1, 2, 3, 3, 3, 6, 6]
    assert [tf._group_of(4, 3), tf._group_of(3, 2), tf._group_of(126, 6)] == [2, 1, 6]
    cfg = dataclasses.replace(configs.reduced_config(configs.get_config("qwen2-0.5b")), num_layers=4)
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(0, cfg.vocab_size).items()}
    calls = {}
    for g in (1, 2, 3):
        m = tf.Model(cfg, remat="full", remat_group=g)
        m.init(torch.Generator().manual_seed(0))
        count = [0]
        real = tf.checkpoint

        def counted(*a, **k):
            count[0] += 1
            return real(*a, **k)

        tf.checkpoint = counted
        try:
            accumulate_grads(m, batch, 1)
        finally:
            tf.checkpoint = real
        calls[g] = count[0]
    # g 1: one checkpoint a layer; g 2 (and 3, which does not divide 4): two
    # group checkpoints, each layer's own inside them, entered again when the
    # backward recomputes its group
    assert calls == {1: 4, 2: 2 + 4 + 4, 3: 2 + 4 + 4}


@pytest.mark.parametrize("arch,layers,g", [("qwen2-0.5b", 4, 2), ("qwen2-0.5b", 4, 3), ("jamba-v0.1-52b", 16, 3)])
def test_remat_group_gives_per_layer_remats_bits(arch, layers, g):
    """The loss and every gradient (2 microbatches) of ``remat_group`` g,
    bit for bit those of per-layer remat (g 1)."""
    cfg = dataclasses.replace(configs.reduced_config(configs.get_config(arch)), num_layers=layers)
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(0, cfg.vocab_size).items()}
    runs = []
    for group in (1, g):
        m = tf.Model(cfg, remat="full", remat_group=group)
        m.init(torch.Generator().manual_seed(0))
        runs.append(accumulate_grads(m, batch, 2))
    (loss1, grads1), (loss, grads) = runs
    assert torch.equal(loss, loss1)
    assert grads.keys() == grads1.keys()
    for name in grads1:
        assert torch.equal(grads[name], grads1[name]), name
