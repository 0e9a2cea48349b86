"""The port's LM on a ``(data, model)`` mesh against the JAX reference.

The sharding specs (``Axes``, the ``*_specs`` functions, ``Model.param_specs``
and ``cache_specs``) are data: for every arch of the registry at model
sizes 1, 2, 4 and 16 they equal the reference's trees leaf for leaf, under
the same key paths.

The sharded serve path runs in ``tests/_torch_lm_mesh_child.py``: four gloo
ranks, on meshes ``(1, 4)`` and ``(2, 2)``, serve reduced jamba (8 layers;
prompts of 24 and 32 tokens, the scans' token recurrence and their chunks
of 16), reduced granite, reduced qwen2 at 6 heads and 2 kv heads (at model
4 the prompt of 24 takes the sequence-parallel residual and the flash
attention at a query offset, the prompt of 22 the replicated attention;
its cache is cut on head_dim), reduced deepseek-v2 (MLA with its MoE; the
latent cache cut on its width, a block straddling the latent's end) and
reduced rwkv6 (prompts of 24 and 32) with the reference's weights, cut by
the mesh (``convert.model_params_from_reference(..., mesh=)``). A Mamba
mixer at d_in 6 on the model axis of 4 (``in_proj`` alone cut) is held to
the reference's mixer: output, state, decode and gradients. The reference runs
here, unsharded, while the ranks work. Tolerances, those of the unsharded
port's own tests of these models (``tests/test_torch_mamba.py``,
``tests/test_torch_models.py``): the logits at 2e-3 (the whole model's
fp32 sums in another order), every cache and state at 1e-5; against the
unsharded port, fed the same tokens, the logits at 1e-5. The greedy tokens
are the reference's, every rank of a model group returns the same tokens,
logits and routes, the data-sharded MoE drops are the unsharded ones, and
the ``convert`` round trip is bitwise.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import mamba as jmam  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import Axes as JAxes  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import dp_size, make_axes, make_lm_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import P, Axes, block_shape  # noqa: E402

from _torch_lm_mesh_child import (CACHE_LEN, CASES, MAMBA6, MAMBA6_L, MAMBA6_STEPS, MESHES, REFUSED,  # noqa: E402
                                  SERVE_ARGS, STEPS, WORLD, case_config)
from _torch_reference import reference_greedy_run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
KEY = jax.random.PRNGKey(7)
B = 2
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
MODEL_SIZES = (1, 2, 4, 16)
ARCHS = sorted(configs.registry())


# ---------------------------------------------------------------------------
# the specs, as data
# ---------------------------------------------------------------------------
def _ref_leaves(tree) -> dict[str, tuple]:
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda s: isinstance(s, PartitionSpec))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): tuple(spec)
            for path, spec in leaves}


def _port_leaves(tree, prefix: str = "") -> dict[str, tuple]:
    if isinstance(tree, P):
        return {prefix[:-1]: tuple(tree)}
    items = tree.items() if isinstance(tree, dict) else zip(tree._fields, tree)
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, f"{prefix}{k}."))
    return out


@pytest.mark.parametrize("model_size", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_are_the_reference_trees(arch, model_size):
    ref = jtf.Model(jconfigs.get_config(arch), JAxes(model_size=model_size))
    port = tf.Model(configs.get_config(arch), ax=Axes(model_size=model_size))
    got = _port_leaves(port.param_specs())
    assert got == _ref_leaves(ref.param_specs())
    assert _port_leaves(port.cache_specs()) == _ref_leaves(ref.cache_specs())
    # a spec for each parameter of the port's tree: a segment's without its repeat entry
    want = {}
    for name, spec in got.items():
        if name.startswith("seg"):
            si, rest = name.split(".", 1)
            want.update({f"{si}.{r}.{rest}": spec[1:] for r in range(port.segments[int(si[3:])].repeat)})
        else:
            want[name] = spec
    assert {k: tuple(v) for k, v in port.leaf_specs().items()} == want


def test_spec_entries_are_normalized_as_the_reference_does():
    assert tuple(P(("data",), None, "model")) == tuple(PartitionSpec(("data",), None, "model"))
    assert tuple(P(("pod", "data"), None)) == tuple(PartitionSpec(("pod", "data"), None))
    assert P(None) == (None,) and P() == ()


def test_seq_sharded_mode_is_the_reference():
    for arch in ARCHS:
        for m in MODEL_SIZES:
            assert tf.seq_sharded_mode(configs.get_config(arch), Axes(model_size=m)) == jtf.seq_sharded_mode(
                jconfigs.get_config(arch), JAxes(model_size=m)), (arch, m)


def test_make_axes_drops_unshardable_batch():
    """Twin of tests/test_dryrun_tools.py::test_make_axes_drops_unshardable_batch,
    on a one-rank gloo mesh."""
    with make_lm_mesh(1, 1, "cpu") as mesh:
        ax = make_axes(mesh, global_batch=1)
        assert ax.b is not None  # batch 1 shards over 1 rank fine
        assert (ax.model_size, dp_size(mesh), mesh.shape) == (1, 1, {"data": 1, "model": 1})
    # simulated bigger mesh: batch 1 over dp 16 must replicate
    ax2 = Axes(batch=(), model="model", model_size=16)
    assert ax2.b is None


@pytest.mark.parametrize("arch,model_size,words", [
    ("deepseek-v2-236b", 2, "MLA"), ("rwkv6-1.6b", 4, "RWKV"), ("qwen2-0.5b", 4, "seq_sharded_mode"),
])
def test_layer_kinds_without_a_mesh_path_raise(arch, model_size, words):
    """The layer kinds the mesh refused before (MLA, RWKV, attention whose
    heads do not divide the axis: the reference's sequence-parallel
    residual) now have a path: ``check_mesh`` admits them at every model
    size of the registry's, and a ``Model`` on a mesh of that model size
    places them (its specs cut every leaf into whole blocks). A narrowed
    refusal stays for a combination no registry config reaches, and names
    the kinds it refuses."""
    from repro_torch.launch.dryrun import fake_mesh

    cfg = configs.get_config(arch)
    for m in (1, 2, 4, 16):
        tf.check_mesh(cfg, Axes(model_size=m))
    assert tf.seq_sharded_mode(cfg, Axes(model_size=model_size)) == (words == "seq_sharded_mode")
    with fake_mesh(1, model_size) as mesh:  # rank 0 of a fake group: the blocks on ``meta``
        model = tf.Model(cfg, mesh=mesh)
        params = dict(model.init_meta().named_parameters())
    sizes = {"pod": 1, "data": 1, "model": model_size}
    shapes, specs = model.leaf_shapes(), model.leaf_specs()
    assert sorted(params) == sorted(shapes)
    for name, param in params.items():
        assert tuple(param.shape) == block_shape(shapes[name], specs[name], sizes), name
    assert any(tuple(p.shape) != shapes[n] for n, p in params.items())
    refused = dataclasses.replace(configs.get_config(REFUSED[0]), **REFUSED[1])
    with pytest.raises(NotImplementedError, match="sequence-cut") as err:
        tf.check_mesh(refused, Axes(model_size=4))
    assert "ROADMAP M5" in str(err.value)


def test_serve_model_shards_on_the_cpu_without_torchrun_raises():
    import torch.distributed as dist

    assert "WORLD_SIZE" not in os.environ
    with pytest.raises(ValueError, match="needs 2 ranks"):
        serve.main(["--device", "cpu", "--model-shards", "2", "--tokens", "2"])
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the sharded serve path, four gloo ranks
# ---------------------------------------------------------------------------
def _ref_models():
    return {arch: jtf.Model(case_config(arch, jconfigs.get_config, jconfigs.reduced_config), remat="none",
                            dtype=jnp.float32)
            for arch in {arch for arch, _ in CASES.values()}}


def _prompt(case: str, l: int) -> np.ndarray:
    seed = {"granite24": 1, "jamba24": 2, "jamba32": 3}.get(case, 4 + sorted(CASES).index(case))
    return np.random.default_rng(seed).integers(0, 512, (B, l)).astype(np.int32)


def _mamba6_inputs() -> dict[str, np.ndarray]:
    """The reference's Mamba mixer at d_in 6 (``MAMBA6``): its ``mamba_init``
    draws with the conv bias, dt bias, A and D moved off their init values,
    an input, a cotangent and the decode steps' inputs."""
    jcfg = case_config("jamba-v0.1-52b", jconfigs.get_config, jconfigs.reduced_config, **MAMBA6)
    rng = np.random.default_rng(21)
    jp = {k: np.array(v) for k, v in jmam.mamba_init(KEY, jcfg, jnp.float32).items()}
    for name in ("conv_b", "dt_bias", "a_log", "d_skip"):
        jp[name] = (jp[name] + 0.1 * rng.normal(size=jp[name].shape)).astype(np.float32)
    out = {f"mamba6/params/{k}": v for k, v in jp.items()}
    for name, shape in (("u", (B, MAMBA6_L, 3)), ("cot", (B, MAMBA6_L, 3)),
                        *((f"step{i}", (B, 1, 3)) for i in range(MAMBA6_STEPS))):
        out[f"mamba6/{name}"] = rng.normal(size=shape).astype(np.float32)
    return out


def _flat(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The child's four ranks, started once the reference's weights are
    drawn; the reference's runs computed while they work. ([(npz, json)
    per rank], {case: reference run}, {arch: reference params})."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    models = _ref_models()
    params = {arch: jax.tree.map(np.asarray, jax.jit(jm.init)(KEY)) for arch, jm in models.items()}
    inputs = {f"params/{arch}/{k}": v for arch, p in params.items() for k, v in _flat(p).items()}
    inputs.update({f"prompt/{case}": _prompt(case, l) for case, (_, l) in CASES.items()})
    inputs["drop/x"] = np.random.default_rng(9).normal(size=(B, 24, 64)).astype(np.float32)
    inputs.update(_mamba6_inputs())
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_lm_mesh_child.py"), str(WORLD),
                             str(tmp / "inputs.npz"), str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        decode = {arch: jax.jit(jm.decode_step) for arch, jm in models.items()}
        reference = {case: reference_greedy_run(models[arch], params[arch], decode[arch], _prompt(case, l), STEPS,
                                                CACHE_LEN)
                     for case, (arch, l) in CASES.items()}
    finally:
        stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"child failed:\n{stdout}\n{stderr}"
    assert f"lm mesh child OK world={WORLD}" in stdout
    ranks = [(dict(np.load(tmp / f"rank{r}.npz")), json.loads((tmp / f"rank{r}.json").read_text()))
             for r in range(WORLD)]
    return ranks, reference, params, inputs


def _ref_cache(run: dict, step: int, name: str) -> np.ndarray:
    """The reference's cache leaf ``seg{i}.{r}.l{j}.{field}`` after ``step``."""
    si, r, layer, field = name.split(".")
    return np.asarray(getattr(run["caches"][step][si][layer], field))[int(r)]


MESH_TAGS = [f"{d}x{m}" for d, m in MESHES]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tag", MESH_TAGS)
def test_mesh_prefill_and_decode_match_reference(runs, tag, case):
    """Prefill logits, every cache and state, and three greedy decode steps,
    joined over the mesh, against the reference's unsharded model; the
    tokens fed are the reference's greedy tokens."""
    ranks, reference, _, _ = runs
    run = reference[case]
    arrays, info = ranks[0]
    pre = f"{tag}/{case}/"
    names = sorted(k[len(pre) + len("caches0/"):] for k in arrays if k.startswith(pre + "caches0/"))
    assert names == sorted(f"{si}.{r}.{layer}.{field}" for si, layers in run["caches"][0].items()
                           for layer, cache in layers.items() for field in cache._fields
                           for r in range(np.asarray(getattr(cache, field)).shape[0]))
    for step in range(STEPS + 1):
        np.testing.assert_allclose(arrays[f"{pre}logits{step}"], run["logits"][step], err_msg=f"step {step} logits",
                                   **LOGIT_TOL)
        np.testing.assert_allclose(arrays[f"{pre}logits{step}"], arrays[f"{pre}unsharded_logits{step}"],
                                   err_msg=f"step {step} logits vs the unsharded port", **BLOCK_TOL)
        for name in names:
            np.testing.assert_allclose(arrays[f"{pre}caches{step}/{name}"], _ref_cache(run, step, name),
                                       err_msg=f"step {step} {name}", **BLOCK_TOL)
    for i in range(STEPS):
        np.testing.assert_array_equal(arrays[f"{pre}tokens{i}"], run["tokens"][i])


@pytest.mark.parametrize("tag", MESH_TAGS)
def test_each_rank_holds_its_blocks(runs, tag):
    """The caches each rank holds are its blocks by ``cache_specs``: at
    model 4 reduced jamba's one kv head does not divide, so its KV cache is
    cut on head_dim (16 -> 4); at model 2 on head_dim too; granite's two kv
    heads are cut at model 2, and its head_dim at model 4. Mamba's states
    are cut on d_in, and so are the parameters by their specs: the
    vocabulary, Mamba's d_in, the query heads, the experts, d_ff. Zero
    caches from ``Model.cache_init`` on the mesh have the prefill's blocks."""
    ranks = runs[0]
    data, model = (int(n) for n in tag.split("x"))
    for rank, (_, info) in enumerate(ranks):
        assert info[f"{tag}/coords"] == [rank // model, rank % model, data, model]
        jamba = info[f"{tag}/jamba24"]["cache_dims"]
        assert jamba["seg1.0.l0.k"] == [B // data, CACHE_LEN, 1, 16 // model]
        assert jamba["seg0.0.l0.ssm"] == [B // data, 128 // model, 8]
        assert jamba["seg0.0.l0.conv"] == [B // data, 3, 128 // model]
        for case in CASES:  # Model.cache_init's blocks are the prefill's
            assert info[f"{tag}/{case}"]["cache_init_dims"] == info[f"{tag}/{case}"]["cache_dims"]
        granite = info[f"{tag}/granite24"]["cache_dims"]
        assert granite["seg0.0.l0.k"] == ([B // data, CACHE_LEN, 1, 16] if model == 2
                                          else [B // data, CACHE_LEN, 2, 16 // model])
        shapes = info[f"{tag}/jamba-v0.1-52b/local_shapes"]
        assert shapes["embed.table"] == [512 // model, 64] and shapes["embed.lm_head"] == [64, 512 // model]
        assert shapes["seg0.0.l0.mixer.in_proj"] == [64, 256 // model]
        assert shapes["seg0.0.l1.ffn.w_gate"] == [4 // model, 64, 32]
        assert shapes["seg1.0.l0.mixer.wq"] == [64, 4 // model, 16] and shapes["seg1.0.l0.mixer.wk"] == [64, 1, 16]
        assert shapes["seg1.0.l0.mixer.wo"] == [4 // model, 16, 64] and shapes["seg1.0.l0.ffn.w_down"] == [128 // model, 64]
        assert shapes["seg0.0.l0.mixer.x_proj"] == [128 // model, 4 + 2 * 8] and shapes["final_norm.scale"] == [64]
        # qwen2 at 6 heads: whole attention and MLP at model 4 (the sequence-parallel residual's specs), cut
        # on heads and d_ff at model 2; its cache cut on head_dim at 4 (2 kv heads), on kv heads at 2
        qwen = info[f"{tag}/qwen2-0.5b/local_shapes"]
        heads = 6 if model == 4 else 6 // model
        assert qwen["seg0.0.l0.mixer.wq"] == [64, heads, 16] and qwen["seg0.0.l0.mixer.bq"] == [heads, 16]
        assert qwen["seg0.0.l0.ffn.w_gate"] == [64, 128 if model == 4 else 128 // model]
        for case in ("qwen24", "qwen22"):
            assert info[f"{tag}/{case}"]["cache_dims"]["seg0.0.l0.k"] == (
                [B // data, CACHE_LEN, 2, 16 // model] if model == 4 else [B // data, CACHE_LEN, 1, 16])
        # MLA: the q latent and the heads cut, the latent cache on its width (40: 10 a rank at model 4)
        mla = info[f"{tag}/deepseek-v2-236b/local_shapes"]
        assert mla["seg0.0.l0.mixer.wq_a"] == [64, 48 // model] and mla["seg0.0.l0.mixer.wq_b"] == [48, 4 // model, 24]
        assert mla["seg0.0.l0.mixer.wkv_a"] == [64, 40] and mla["seg0.0.l0.mixer.wo"] == [4 // model, 16, 64]
        assert info[f"{tag}/deepseek24"]["cache_dims"]["seg1.0.l0.ckv"] == [B // data, CACHE_LEN, 40 // model]
        # RWKV-6: the time mix on heads (wo on its input), the decay LoRA whole, the channel mix on d_ff
        rwkv = info[f"{tag}/rwkv6-1.6b/local_shapes"]
        assert rwkv["seg0.0.l0.mixer.wr"] == [64, 64 // model] and rwkv["seg0.0.l0.mixer.wo"] == [64 // model, 64]
        assert rwkv["seg0.0.l0.mixer.u"] == [4 // model, 16] and rwkv["seg0.0.l0.mixer.w_a"] == [64, 8]
        assert rwkv["seg0.0.l0.ffn.wk"] == [64, 128 // model] and rwkv["seg0.0.l0.ffn.wr"] == [64, 64 // model]
        for case in ("rwkv24", "rwkv32"):
            dims = info[f"{tag}/{case}"]["cache_dims"]
            assert dims["seg0.1.l0.s"] == [B // data, 4 // model, 16, 16]
            assert dims["seg0.1.l0.x_prev_tm"] == [B // data, 64]


@pytest.mark.parametrize("tag", MESH_TAGS)
def test_every_rank_of_a_model_group_agrees(runs, tag):
    """Tokens, logits, caches (joined) and MoE routes: the same bits on every
    rank of a model group; the joined tensors on every rank of the mesh."""
    ranks = runs[0]
    model = int(tag.split("x")[1])
    first = ranks[0][0]
    for rank, (arrays, _) in enumerate(ranks):
        for key in first:
            if not key.startswith(tag + "/") or "/drop/" in key:
                continue
            if key.endswith(("route_ids", "route_keep")):
                np.testing.assert_array_equal(arrays[key], ranks[rank - rank % model][0][key], err_msg=key)
            else:
                np.testing.assert_array_equal(arrays[key], first[key], err_msg=f"rank {rank} {key}")


def test_data_sharded_drops_are_the_unsharded_drops(runs):
    """At 10 slots an expert (48 tokens, top-2 of 4 experts) the data ranks'
    queues are the whole batch's: each rank's ``keep`` and buffer rows are
    the unsharded route's for its tokens, and the MoE FFN at capacity factor
    0.5, which drops slots, gives the unsharded output and aux losses."""
    ranks = runs[0]
    for rank, (arrays, _) in enumerate(ranks):
        data = rank // 2
        keep_all = arrays["2x2/drop/keep_all"]
        assert not keep_all.all()
        n = keep_all.shape[0] // 2
        np.testing.assert_array_equal(arrays["2x2/drop/keep_mine"], keep_all[data * n:(data + 1) * n])
        np.testing.assert_array_equal(arrays["2x2/drop/buf_mine"], arrays["2x2/drop/buf_all"][data * n:(data + 1) * n])
        np.testing.assert_allclose(arrays["2x2/drop/y_mine"], arrays["2x2/drop/y_all"], **BLOCK_TOL)
        np.testing.assert_allclose(arrays["2x2/drop/aux_mine"], arrays["2x2/drop/aux_all"], **BLOCK_TOL)


@pytest.mark.parametrize("tag", MESH_TAGS)
def test_convert_round_trip_and_mesh_init_are_bitwise(runs, tag):
    """``model_params_to_reference`` of the blocks that
    ``model_params_from_reference(..., mesh=)`` cut is the reference's tree
    bit for bit; a mesh ``init`` draws the one-card model's weights, cut."""
    ranks = runs[0]
    for _, info in ranks:
        for arch in {arch for arch, _ in CASES.values()}:
            assert info[f"{tag}/{arch}/round_trip"] == []
            assert info[f"{tag}/{arch}/round_trip_extra"] == []
            assert info[f"{tag}/{arch}/init_vs_cut"] == []


def test_mesh_raises_in_the_ranks(runs):
    """MLA and RWKV, which the ranks refused at (1, 4) before, are made there
    now; a combination no registry config reaches (Mamba layers under a
    sequence-cut residual) and a mesh short of the world still raise."""
    ranks = runs[0]
    for _, info in ranks:
        assert info["raises"]["deepseek-v2-236b"] == info["raises"]["rwkv6-1.6b"] == "made"
        assert "sequence-cut" in info["raises"]["refused"] and "ROADMAP M5" in info["raises"]["refused"]
        assert "must span all 4" in info["raises"]["mesh_1x2"]


def test_a_mamba_mixer_whose_d_in_does_not_divide_the_axis(runs):
    """d_in 6 on a model axis of 4 (2·d_in 12 divides it): ``in_proj`` alone
    is cut, in its natural [x | z] order (no ``in_proj_layout``), its output
    gathered and the rest of the mixer whole. The output, the decode state
    and two decode steps at the port's one-card tolerance of the reference's
    mixer; the gradients of the input and of every parameter (``in_proj``'s
    joined over the ranks) at its gradient tolerances."""
    ranks, _, _, inputs = runs
    jcfg = case_config("jamba-v0.1-52b", jconfigs.get_config, jconfigs.reduced_config, **MAMBA6)
    jp = {k[len("mamba6/params/"):]: v for k, v in inputs.items() if k.startswith("mamba6/params/")}
    u, cot = inputs["mamba6/u"], inputs["mamba6/cot"]
    ax = JAxes(batch=("data",), model="model", model_size=1)
    want_y = jmam.mamba_forward(jp, u, jcfg, ax)
    want_gp, want_gu = jax.grad(lambda p, x: jnp.sum(jmam.mamba_forward(p, x, jcfg, ax) * cot), argnums=(0, 1))(jp, u)
    d_in = 6
    state = jmam.MambaState(conv=(u @ jp["in_proj"])[:, -3:, :d_in], ssm=jtf._mamba_final_state(jp, u, jcfg))
    arrays = ranks[0][0]
    assert arrays["1x4/mamba6/in_proj_shape"].tolist() == [3, 2 * d_in // 4]
    np.testing.assert_allclose(arrays["1x4/mamba6/y"], want_y, **BLOCK_TOL)
    np.testing.assert_allclose(arrays["1x4/mamba6/conv"], state.conv, **BLOCK_TOL)
    np.testing.assert_allclose(arrays["1x4/mamba6/ssm"], state.ssm, **BLOCK_TOL)
    for i in range(MAMBA6_STEPS):
        want, state = jmam.mamba_decode(jp, inputs[f"mamba6/step{i}"], state, jcfg, ax)
        np.testing.assert_allclose(arrays[f"1x4/mamba6/decode{i}"], want, err_msg=f"step {i}", **BLOCK_TOL)
    for name, got, want in [("input", arrays["1x4/mamba6/du"], want_gu)] + [
            (k, arrays[f"1x4/mamba6/grad/seg0.0.l0.mixer.{k}"], want_gp[k]) for k in jp]:
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0 and np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), name
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale, err_msg=name)


def test_serve_main_on_a_mesh_returns_each_data_rank_its_rows(runs):
    """``launch.serve.main`` at ``--data-shards 2 --model-shards 2``: the
    one-card run's tokens, rows 0-1 on data rank 0 and 2-3 on data rank 1;
    only rank 0 prints."""
    ranks = runs[0]
    want = serve.main(SERVE_ARGS)["tokens"].numpy()
    for rank, (arrays, info) in enumerate(ranks):
        data = rank // 2
        np.testing.assert_array_equal(arrays["serve/tokens"], want[2 * data:2 * data + 2])
        assert info["serve"]["mesh"] == {"data": 2, "model": 2}
        assert ("generated" in info["serve"]["printed"]) == (rank == 0)
