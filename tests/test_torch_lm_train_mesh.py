"""The port's LM training on a ``(data, model)`` mesh against the JAX reference.

The specs are data: ``apply_fsdp``, ``opt_state_specs`` (with and without
ZeRO-1), ``batch_specs`` and ``metric_specs`` equal the reference's trees
for every arch of the registry at meshes ``(16, 16)``, ``(2, 2)`` and
``(4, 1)``, on the reference's stacked shapes (``jax.eval_shape`` of its
``Model.init``, which ``Model.param_shapes`` reproduces).

The mesh runs in ``tests/_torch_lm_train_mesh_child.py``: gloo ranks, one
spawn per mesh shape, every case of that shape inside it, while the
reference runs here, unsharded. Reduced jamba (8 layers) at ``(1, 4)``,
``(2, 2)`` and ``(4, 1)``, reduced granite (MoE, router aux weights raised
to 0.1 and 0.01) at ``(2, 2)`` and ``(4, 1)``, reduced qwen2 at ``(4, 1)``
with ``ignore_id`` labels spread unevenly over the data ranks; reduced
qwen2 at 6 heads (the sequence-parallel residual at ``(1, 4)``: K/V
gathered over the sequence, every leaf's gradient summed over the model
group), reduced deepseek-v2 (MLA and MoE) and reduced rwkv6 at ``(1, 4)``
and ``(2, 2)``, where at ``(1, 4)`` the gradients taken with every
model-group gather narrowing its backward miss the reference (the K/V and
q-latent gathers must reduce-scatter); FSDP cuts
every leaf of 2^10 elements or more over the data axis. Tolerances, the
one-card port's (``tests/test_torch_train.py``): the loss at rtol 1e-5 of
the reference's ``jax.value_and_grad(loss_fn)``; every gradient, joined to
whole, at a relative norm error of 1e-4 and elementwise at rtol 1e-4, atol
1e-5 times the leaf's largest |g|; three training steps through
``launch.train.main`` (2 microbatches, remat ``none`` and ``full``) at rtol
1e-4 of the one-card launcher's losses and gradient norms. Every rank
returns the same loss bits, and remat ``full`` gives ``none``'s bits.
Reduced internvl2 at a vocabulary of 510 (its tied table whole at ``(1,
4)``) meets the same gates, and at ``(1, 4)`` neither it nor qwen2 at 6
heads (a cut table) holds a tensor as wide as the vocabulary in the
loss's forward or backward (the one-card loss does).

The training options on a mesh, bit for bit: ZeRO-1 moments at ``(2,
1)``, ``(2, 2)`` and ``(4, 1)`` give ``zero1=False``'s losses, norms and
parameters, a rank holding the elements of the reference's
``opt_state_specs(zero1=True)`` blocks in GSPMD's ceil layout (an uneven
repeat axis and an uneven table), and with FSDP they raise where JAX's
``NamedSharding`` refuses the reference's spec; ``int8`` compression's
joined gradients are the reference's ``compress_tree`` of the joined
gradients in its stacked tree, on the joined and on the aligned local
path; a ``(2, 2)``
checkpoint's files are the one-card ``save`` of the joined state, a
resumed run's losses the uninterrupted run's, and it restores at ``(1,
4)`` and on one card to the same parameters.

Sampled serving on a data-cut mesh draws the whole batch's uniforms on
every rank: at ``(2, 1)`` and ``(2, 2)`` the served tokens are the
one-process run's, row for row, and two data ranks given the same prompts
draw different tokens.
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
from jax.sharding import Mesh, NamedSharding, PartitionSpec  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.mesh import apply_fsdp as japply_fsdp  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import Axes as JAxes  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import checkpointer as ckpt  # noqa: E402
from repro_torch.convert import reference_leaf  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.mesh import apply_fsdp  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import P, Axes  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

from _torch_lm_mesh_child import _flat  # noqa: E402
from _torch_lm_train_mesh_child import (B, CASES, CUT_LOSS, FSDP_MIN_ELEMS, L, MESH_CASES, NARROWED,  # noqa: E402
                                        SERVE_ARGS, TRAIN_ARGS, TRAIN_REMATS, ZERO1_MESHES, _wide_outputs,
                                        case_config, zero1_config)

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
KEY = jax.random.PRNGKey(0)
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-5
RUN_RTOL = 1e-4
SPEC_MESHES = [(16, 16), (2, 2), (4, 1)]  # (data, model)
ARCHS = sorted(configs.registry())
CHILD_TIMEOUT_S = 300


def _ref_leaves(tree) -> dict[str, tuple]:
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda s: isinstance(s, PartitionSpec))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): tuple(spec)
            for path, spec in leaves}


def _port_leaves(tree, prefix: str = "") -> dict[str, tuple]:
    if isinstance(tree, (P, tuple)) and not hasattr(tree, "_fields"):
        return {prefix[:-1]: tuple(tree)}
    items = tree.items() if isinstance(tree, dict) else zip(tree._fields, tree)
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, f"{prefix}{k}."))
    return out


def _flat_shapes(tree, prefix: str = "") -> dict[str, tuple]:
    out = {}
    for k, v in tree.items():
        out.update(_flat_shapes(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": tuple(v)})
    return out


_SHAPES: dict = {}


def _shapes(arch: str):
    """(the reference's ``jax.eval_shape(Model.init)``, the port's ``param_shapes``)
    of ``arch`` at its published widths."""
    if arch not in _SHAPES:
        _SHAPES[arch] = (jax.eval_shape(jtf.Model(jconfigs.get_config(arch)).init, KEY),
                         tf.Model(configs.get_config(arch)).param_shapes())
    return _SHAPES[arch]


# ---------------------------------------------------------------------------
# the mesh runs, gloo ranks
# ---------------------------------------------------------------------------
def _cfgs(case: str):
    return case_config(case, jconfigs.get_config, jconfigs.reduced_config)


def _moved_off_init(case: str, params: dict) -> dict:
    """RWKV-6's constants moved off their init values, as tests/test_torch_rwkv.py
    moves them (token-shift mixes, bonus u, head-norm scale, w0 to about -1):
    at init u is 0, so the first token's WKV output is exactly 0, where the
    head norm's backward scales rounding by 1/sqrt(eps) ≈ 316 and the
    one-card port itself leaves the gradient tolerance. Other cases as drawn."""
    if case != "rwkv":
        return params
    rng = np.random.default_rng(5)
    for seg in sorted(k for k in params if k.startswith("seg")):
        mixer, ffn = params[seg]["l0"]["mixer"], params[seg]["l0"]["ffn"]
        for node, names in ((mixer, ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "u", "ln_scale")),
                            (ffn, ("mix_k", "mix_r"))):
            for name in names:
                node[name] = (node[name] + 0.1 * rng.normal(size=node[name].shape)).astype(np.float32)
        mixer["w0"] = (-1.0 + 0.3 * rng.normal(size=mixer["w0"].shape)).astype(np.float32)
    return params


def _batch(case: str, vocab: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(sorted(CASES).index(case) + 11)
    toks = rng.integers(0, vocab, (B, L + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :L], "labels": toks[:, 1:].copy()}
    if case == "qwen2":  # unmasked labels by data rank at (4, 1): 3, 12, 16, 15
        batch["labels"][0, :] = -1
        batch["labels"][1, :5] = -1
        batch["labels"][2, 4:] = -1
        batch["labels"][7, 0] = -1
    return batch


MESH_TAGS = [f"{d}x{m}" for d, m in MESH_CASES]
GRAD_CASES = [(f"{d}x{m}", case) for (d, m), cases in MESH_CASES.items() for case in cases]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({tag: [(npz, json) per rank]}, {case: reference (loss, grads, params)},
    {(case, remat): one-card launcher run}, one-process sampled tokens, the
    child's directory, whose ``<tag>/`` holds the checkpoints). The
    child's ranks start once the reference's weights are drawn; the
    reference and the one-card runs are computed while they work."""
    tmp = tmp_path_factory.mktemp("lm_train_mesh")
    models = {case: jtf.Model(_cfgs(case), remat="none", dtype=jnp.float32) for case in CASES}
    params = {case: _moved_off_init(case, jax.tree.map(np.asarray, jax.jit(jm.init)(KEY)))
              for case, jm in models.items()}
    batches = {case: _batch(case, jm.cfg.vocab_size) for case, jm in models.items()}
    inputs = {f"params/{case}/{k}": v for case, p in params.items() for k, v in _flat(p).items()}
    inputs.update({f"batch/{case}/{k}": v for case, b in batches.items() for k, v in b.items()})
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_lm_train_mesh_child.py"),
                               str(tmp / "inputs.npz"), str(tmp), tag],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for tag in MESH_TAGS]  # one spawn a mesh shape, all at once
    try:
        reference = {}
        for case, jm in models.items():
            loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(params[case], batches[case])
            reference[case] = (float(loss), jax.tree.map(np.asarray, grads))
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one_card = {(case, remat): train.main(["--arch", CASES[case], *TRAIN_ARGS, "--remat", remat])
                        for case in CASES for remat in TRAIN_REMATS[case]}
            sampled = serve.main(SERVE_ARGS)["tokens"].numpy()
        finally:
            torch.set_num_threads(n)
        for arch in ARCHS:  # the spec tests' shapes, while the ranks work
            _shapes(arch)
    finally:
        done = [(proc, *proc.communicate(timeout=CHILD_TIMEOUT_S)) for proc in procs]
    for proc, stdout, stderr in done:
        assert proc.returncode == 0, f"child failed:\n{stdout}\n{stderr}"
        assert "lm train mesh child OK" in stdout
    ranks = {}
    for d, m in MESH_CASES:
        tag = f"{d}x{m}"
        ranks[tag] = [(dict(np.load(tmp / tag / f"rank{r}.npz")), json.loads((tmp / tag / f"rank{r}.json").read_text()))
                      for r in range(d * m)]
    return ranks, reference, one_card, sampled, tmp


@pytest.mark.parametrize("tag,case", GRAD_CASES)
def test_loss_and_every_gradient_match_the_reference(runs, tag, case):
    """The loss on every rank, and every gradient joined to whole, against
    the reference's unsharded ``jax.value_and_grad(loss_fn)``."""
    ranks, reference, _, _, _ = runs
    want_loss, want = reference[case]
    for arrays, _ in ranks[tag]:
        np.testing.assert_allclose(float(arrays[f"{case}/loss"]), want_loss, rtol=LOSS_RTOL)
    arrays = ranks[tag][0][0]
    names = sorted(k[len(f"{case}/grad/"):] for k in arrays if k.startswith(f"{case}/grad/"))
    assert names == sorted(_flat(want))
    for name in names:
        got, ref = arrays[f"{case}/grad/{name}"], _flat(want)[name]
        scale = float(np.abs(ref).max())
        assert scale > 0, name
        assert np.linalg.norm(got - ref) <= GRAD_NORM_RTOL * np.linalg.norm(ref), name
        np.testing.assert_allclose(got, ref, rtol=GRAD_RTOL, atol=GRAD_ATOL_SCALE * scale, err_msg=name)


@pytest.mark.parametrize("tag,case", GRAD_CASES)
def test_fsdp_cuts_leaves_over_the_data_axis(runs, tag, case):
    """At data > 1 the case's larger leaves are FSDP blocks: a ``data`` entry
    in the spec, and the rank's gradient block that dimension's share."""
    ranks, reference, _, _, _ = runs
    data, model = (int(n) for n in tag.split("x"))
    for _, info in ranks[tag]:
        leaves = info[f"{case}/fsdp_leaves"]
        assert bool(leaves) == (data > 1)
        for name, (shape, spec) in leaves.items():
            whole = reference_leaf(reference[case][1], name).shape
            dim = spec.index("data")
            assert shape[dim] * data == whole[dim], name
            model_dims = [i for i, e in enumerate(spec) if e == "model"]
            assert all(shape[i] * model == whole[i] for i in model_dims), name


@pytest.mark.parametrize("tag", MESH_TAGS[:3])
def test_every_rank_returns_the_same_loss_and_gradients(runs, tag):
    """The loss's bits on every rank of the mesh (a model group's ranks and
    the data ranks alike), and the joined gradients."""
    ranks = runs[0][tag]
    first = ranks[0][0]
    for arrays, info in ranks[1:]:
        for key in first:
            if not key.startswith("serve/"):
                np.testing.assert_array_equal(arrays[key], first[key], err_msg=key)
        for key, run in info.items():
            if "/train/" in key:
                assert run == ranks[0][1][key], key


@pytest.mark.parametrize("tag,case", GRAD_CASES)
def test_remat_full_gives_the_loss_and_gradients_of_none(runs, tag, case):
    """Twin of tests/test_torch_train.py::test_remat_gives_the_loss_and_gradients_of_none
    on the mesh: the replayed forward re-runs its collectives, bit for bit."""
    for _, info in runs[0][tag]:
        assert info[f"{case}/remat_differs"] == []


@pytest.mark.parametrize("tag,case,remat", [(tag, case, remat) for tag, case in GRAD_CASES
                                             for remat in TRAIN_REMATS[case]])
def test_three_steps_follow_the_one_card_run(runs, tag, case, remat):
    """``launch.train.main`` on the mesh (2 microbatches, the global batch
    split first) against the one-card launcher: losses and gradient norms."""
    ranks, _, one_card, _, _ = runs
    want = one_card[(case, remat)]
    data, model = (int(n) for n in tag.split("x"))
    for _, info in ranks[tag]:
        got = info[f"{case}/train/{remat}"]
        assert got["mesh"] == {"data": data, "model": model} and got["microbatches"] == 2
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=RUN_RTOL)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=RUN_RTOL)


@pytest.mark.parametrize("case", NARROWED)
def test_a_narrowing_backward_on_the_model_gathers_misses_the_reference(runs, case):
    """The K/V of the sequence-parallel attention (qwen2 at 6 heads) and MLA's
    q latent (deepseek) are gathered over the model group and feed other
    queries or heads on each rank: with a backward that keeps this rank's
    slice instead of summing the ranks' gradients into it, the gradients
    leave the reference's tolerance, while the reduce-scatter's meet it
    (``test_loss_and_every_gradient_match_the_reference``)."""
    ranks, reference, _, _, _ = runs
    want = _flat(reference[case][1])
    arrays = ranks["1x4"][0][0]
    missed = [name for name in want
              if np.linalg.norm(arrays[f"{case}/narrowed/{name}"] - want[name]) > GRAD_NORM_RTOL * np.linalg.norm(
                  want[name])]
    assert missed, "a narrowing backward on the model-group gathers met the reference's gradients"
    for name in missed:
        assert np.linalg.norm(arrays[f"{case}/grad/{name}"] - want[name]) <= GRAD_NORM_RTOL * np.linalg.norm(
            want[name]), name


def test_uneven_labels_reach_the_ranks_unevenly():
    """qwen2's batch gives the data ranks of (4, 1) different counts of
    unmasked labels, so a mean of per-rank means would miss the loss."""
    labels = _batch("qwen2", 512)["labels"]
    counts = [(labels[2 * r:2 * r + 2] != -1).sum() for r in range(4)]
    assert len(set(counts)) == 4


@pytest.mark.parametrize("case", CUT_LOSS)
def test_the_training_loss_never_holds_a_whole_vocabulary_row(runs, case):
    """At (1, 4) no op of the loss's forward or backward outputs a tensor as
    wide as the vocabulary, on a cut table (qwen2 at 6 heads, 512 over 4)
    and on a whole one (internvl2, 510); the one-card loss does."""
    for _, info in runs[0]["1x4"]:
        assert info[f"{case}/wide"] == []
    cfg = _cfgs(case)
    model = tf.Model(cfg, remat="none")
    model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(case, cfg.vocab_size).items()}
    assert _wide_outputs(model, batch, cfg.vocab_size)


def _zero1_jax_model(model_size: int):
    jcfg = zero1_config(jconfigs.get_config, jconfigs.reduced_config)
    return jtf.Model(jcfg, JAxes(model_size=model_size))


def _gspmd_elems(shape, spec, coords: dict[str, tuple[int, int]]) -> int:
    """Elements of a rank's block of a leaf of ``shape`` placed by ``spec`` in
    GSPMD's layout: a dimension cut over n ranks in blocks of ceil(size / n),
    the last short or empty; ``coords``: {axis: (this rank's index, ranks)}."""
    n = 1
    for size, entry in zip(shape, spec):
        if entry is None:
            n *= size
            continue
        index, count = coords[entry]
        per = -(-size // count)
        n *= max(0, min(per, size - index * per))
    return n


@pytest.mark.parametrize("tag", [f"{d}x{m}" for d, m in ZERO1_MESHES])
def test_zero1_steps_are_bitwise_the_plain_steps(runs, tag):
    """Three steps with ZeRO-1 moments: the losses, gradient norms and joined
    parameters of ``zero1=False`` bit for bit, on every rank."""
    for _, info in runs[0][tag]:
        assert info["zero1/True"]["losses"] == info["zero1/False"]["losses"]
        assert info["zero1/True"]["grad_norms"] == info["zero1/False"]["grad_norms"]
        assert info["zero1/params_equal"] == info["zero1/param_names"]
        assert info["zero1/True"]["sliced"] > 0


@pytest.mark.parametrize("tag", [f"{d}x{m}" for d, m in ZERO1_MESHES])
def test_zero1_moments_are_the_reference_zero1_blocks(runs, tag):
    """A rank's moment elements equal its blocks of the reference's
    ``opt_state_specs(param_specs, zero1=True)`` in GSPMD's ceil layout: the
    3 repeats over 2 data ranks as 2 and 1, over 4 as 1, 1, 1, 0; at (2, 2)
    the whole 509-row table's moments as 255 and 254 rows. Without ZeRO-1,
    the parameters' blocks."""
    data, model_size = (int(n) for n in tag.split("x"))
    jm = _zero1_jax_model(model_size)
    specs = _ref_leaves(jm.param_specs())
    shapes = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(jax.eval_shape(jm.init, KEY))[0]}
    zero1 = _ref_leaves(jopt.opt_state_specs(jm.param_specs(), jm.ax, zero1=True).m)
    for _, info in runs[0][tag]:
        d, m = info["coords"]
        coords = {"data": (d, data), "model": (m, model_size)}
        assert info["zero1/True"]["moment_elems"] == sum(_gspmd_elems(shapes[k], zero1[k], coords) for k in zero1)
        assert info["zero1/False"]["moment_elems"] == sum(_gspmd_elems(shapes[k], specs[k], coords) for k in specs)
    assert len({info["zero1/True"]["moment_elems"] for _, info in runs[0][tag]}) > 1  # uneven


def test_zero1_with_fsdp_raises_as_jax_refuses_the_reference_spec(runs):
    """With FSDP the reference's ZeRO-1 spec names ``data`` twice: JAX's
    ``NamedSharding`` raises ``DuplicateSpecError`` on it, and the port's
    step raises ``ValueError`` naming the leaf and the spec."""
    jm = _zero1_jax_model(2)
    shapes = jax.eval_shape(jm.init, KEY)
    widened = japply_fsdp(jm.param_specs(), shapes, fsdp_axis="data", fsdp_size=2, min_elems=FSDP_MIN_ELEMS)
    spec = jopt.opt_state_specs(widened, jm.ax, zero1=True).m["embed"]["table"]
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with pytest.raises(Exception, match="duplicate entries") as err:
        NamedSharding(mesh, spec)
    assert type(err.value).__name__ == "DuplicateSpecError"
    for _, info in runs[0]["2x2"]:
        assert "embed.table" in info["zero1/fsdp"] and str(P(*spec)) in info["zero1/fsdp"]


def _stacked(arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Whole tensors by the port's parameter names as the reference's leaves:
    a segment's ``seg{i}.{r}.rest`` stacked over r as ``seg{i}.rest``."""
    runs: dict[str, list] = {}
    for name, a in arrays.items():
        parts = name.split(".")
        if parts[0].startswith("seg"):
            runs.setdefault(".".join([parts[0], *parts[2:]]), []).append((int(parts[1]), a))
        else:
            runs[name] = a
    return {k: np.stack([a for _, a in sorted(v, key=lambda ra: ra[0])]) if isinstance(v, list) else v
            for k, v in runs.items()}


@pytest.mark.parametrize("case", ["jamba", "zero1"])
def test_int8_on_the_mesh_is_the_reference_compress_tree_of_the_joined_gradients(runs, case):
    """At (2, 2) ``compress_grads(int8)``'s gradients, joined and stacked
    over each segment's repeats, are the reference's ``compress_tree`` of
    the joined uncompressed gradients in the reference's stacked tree, bit
    for bit: jamba's (FSDP, the Mamba ``in_proj``'s re-laid block, 64-wide
    norms whose blocks straddle repeats) through the joined path; qwen2's,
    FSDP off, also through the aligned local path (``w_down`` and ``wo``
    cut on their first dimension alone)."""
    for arrays, info in runs[0]["2x2"]:
        raw = _stacked({k[len(f"int8/{case}/raw/"):]: v for k, v in arrays.items()
                        if k.startswith(f"int8/{case}/raw/")})
        got = _stacked({k[len(f"int8/{case}/q/"):]: v for k, v in arrays.items() if k.startswith(f"int8/{case}/q/")})
        want = jax.tree.map(np.asarray, jcomp.compress_tree({k: jnp.asarray(v) for k, v in raw.items()}, "int8"))
        assert set(got) == set(want)
        for name, ref in want.items():
            np.testing.assert_array_equal(got[name], ref, err_msg=name)
        joined, cut = set(info[f"int8/{case}/joined"]), set(info[f"int8/{case}/cut"])
        assert joined and joined <= cut
        if case == "zero1":
            assert cut - joined  # the aligned local path


def test_a_mesh_checkpoint_is_the_one_card_checkpoint_of_the_joined_state(runs):
    """A (2, 2) checkpoint through ``launch.train.main --ckpt`` holds the
    bytes of a one-card ``save`` of the joined state, file for file; the
    ZeRO-1 state's checkpoint those of the plain state's, and it restores
    the ZeRO-1 slices exactly."""
    root = runs[4] / "2x2"
    for a, b in (("ckpt", "one_card"), ("zero1_True", "zero1_False")):
        mine, other = root / a / "step_00000003", root / b / "step_00000003"
        names = sorted(p.name for p in mine.iterdir())
        assert names == sorted(p.name for p in other.iterdir()) and "manifest.json" in names
        for name in names:
            assert (mine / name).read_bytes() == (other / name).read_bytes(), (a, name)
    for _, info in runs[0]["2x2"]:
        assert info["zero1/restored_equal"]


def test_a_resumed_mesh_run_is_the_uninterrupted_run(runs):
    """One step with ``--ckpt``, then ``--resume`` to three, at (2, 2): the
    uninterrupted three steps' losses, bit for bit."""
    for _, info in runs[0]["2x2"]:
        assert info["ckpt/losses"] == info["jamba/train/none"]["losses"]


def test_a_mesh_checkpoint_restores_at_another_mesh_and_on_one_card(runs):
    """The (2, 2) run's last checkpoint restored at (1, 4) on the same ranks,
    and on one card here, gives the (2, 2) run's joined parameters bit for
    bit."""
    arrays = runs[0]["2x2"][0][0]
    final = {k[len("ckpt/final/0."):]: v for k, v in arrays.items() if k.startswith("ckpt/final/")}
    for name, want in final.items():
        np.testing.assert_array_equal(arrays[f"ckpt/1x4/{name}"], want, err_msg=name)
    cfg = _cfgs("jamba")
    model = tf.Model(cfg, remat="none")
    params = model.init(torch.Generator().manual_seed(1))
    (params, _), step = ckpt.restore(str(runs[4] / "2x2" / "ckpt"), (params, opt.init_opt_state(params, opt.AdamWConfig())))
    assert step == 3
    got = dict(params.named_parameters())
    assert sorted(got) == sorted(final)
    for name, want in final.items():
        np.testing.assert_array_equal(got[name].detach().numpy(), want, err_msg=name)


@pytest.mark.parametrize("tag", ["2x1", "2x2"])
def test_sampled_serving_returns_the_one_process_tokens(runs, tag):
    """``launch.serve.main --temperature 1``: each data rank's rows are the
    one-process run's, row for row."""
    ranks, _, _, sampled, _ = runs
    model = int(tag.split("x")[1])
    for rank, (arrays, _) in enumerate(ranks[tag]):
        data = rank // model
        np.testing.assert_array_equal(arrays["serve/tokens"], sampled[2 * data:2 * data + 2])


@pytest.mark.parametrize("tag", ["2x1", "2x2"])
def test_two_data_ranks_with_the_same_prompts_draw_differently(runs, tag):
    """Each data rank takes its own rows' uniforms of the global batch, so
    the same two prompts on both data ranks do not draw the same tokens."""
    ranks = runs[0][tag]
    model = int(tag.split("x")[1])
    first, second = ranks[0][0]["serve/same_rows"], ranks[model][0]["serve/same_rows"]
    np.testing.assert_array_equal(first[:, 0], second[:, 0])  # the first token is greedy
    assert not np.array_equal(first, second)
    for rank in range(1, model):  # a model group agrees
        np.testing.assert_array_equal(ranks[rank][0]["serve/same_rows"], first)


# ---------------------------------------------------------------------------
# the specs, as data (after the mesh runs, whose fixture draws the shapes while the ranks work)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("data,model_size", SPEC_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_opt_state_batch_and_metric_specs_are_the_reference_trees(arch, data, model_size):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    ref_shapes, port_shapes = _shapes(arch)
    assert _flat_shapes(port_shapes) == _flat_shapes(jax.tree.map(lambda s: s.shape, ref_shapes))
    jax_ax, ax = JAxes(model_size=model_size), Axes(model_size=model_size)
    ref, port = jtf.Model(jcfg, jax_ax), tf.Model(cfg, ax=ax)
    want = japply_fsdp(ref.param_specs(), ref_shapes, fsdp_axis="data", fsdp_size=data)
    got = apply_fsdp(port.param_specs(), port_shapes, "data", data)
    assert _port_leaves(got) == _ref_leaves(want)
    assert any("data" in spec for spec in _port_leaves(got).values())
    for zero1 in (False, True):
        want_opt = jopt.opt_state_specs(want, jax_ax, zero1=zero1)
        got_opt = opt.opt_state_specs(got, ax, zero1=zero1)
        assert tuple(got_opt.step) == tuple(want_opt.step) == ()
        assert _port_leaves(got_opt.m) == _ref_leaves(want_opt.m)
        assert _port_leaves(got_opt.v) == _ref_leaves(want_opt.v)
    assert _port_leaves(tstep.batch_specs(port)) == _ref_leaves(jstep.batch_specs(ref))
    assert _port_leaves(tstep.metric_specs()) == _ref_leaves(jstep.metric_specs())


def test_apply_fsdp_widens_large_leaves():
    """Twin of tests/test_dryrun_tools.py::test_apply_fsdp_widens_large_leaves."""
    specs = {"big": P(None, "model"), "small": P(None, None), "stacked": P(None, None, "model")}
    shapes = {"big": (4096, 4096), "small": (64, 64), "stacked": (24, 4096, 4096)}
    out = apply_fsdp(specs, shapes, fsdp_axis="data", fsdp_size=16, min_elems=1 << 20)
    assert out["big"] == P("data", "model")
    assert out["small"] == P(None, None)  # too small
    assert out["stacked"] == P(None, "data", "model")  # never the stack dim


def test_a_mesh_model_places_by_the_widened_specs():
    """``Model.leaf_specs`` of a mesh model is ``apply_fsdp`` of its specs,
    without the repeat entry; without a mesh nothing is widened."""
    cfg = configs.reduced_config(configs.get_config("jamba-v0.1-52b"))

    @dataclasses.dataclass
    class FakeMesh:  # a (4, 1) mesh's shape; no collective runs here
        data_count: int = 4
        model_count: int = 1
        model_group: object = None
        model_index: int = 0
        data_group: object = None
        data_index: int = 0
        pod_group: object = None
        pod_index: int = 0
        pod_count: int = 1
        dp_group: object = None

    m = tf.Model(cfg, mesh=FakeMesh(), fsdp_min_elems=1 << 10)
    widened = _port_leaves(apply_fsdp(m.param_specs(), m.param_shapes(), "data", 4, 1 << 10))
    assert m.leaf_specs()["seg0.0.l0.mixer.in_proj"] == P(*widened["seg0.l0.mixer.in_proj"][1:]) == P("data", "model")
    assert m.fsdp_dims()["embed.table"] == 1 and "final_norm.scale" not in m.fsdp_dims()
    assert tf.Model(cfg).fsdp_dims() == {} and tf.Model(cfg, mesh=FakeMesh()).fsdp_dims() == {}
    with pytest.raises(ValueError, match="fsdp over 2"):
        tf.Model(cfg, mesh=FakeMesh(), fsdp=2)
