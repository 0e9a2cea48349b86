"""The port's LM training stack (``repro_torch.models`` loss path,
``repro_torch.train``, ``repro_torch.data``, ``repro_torch.launch.train``)
against the JAX reference, on the CPU.

Inputs are drawn with numpy from fixed seeds and handed to both packages;
the weights are the reference's ``Model.init`` draws, carried across by
``repro_torch.convert.model_params_from_reference`` and made trainable.
Tolerances:

- the loss, float32 throughout in another evaluation order: rtol 1e-5
  (measured <= 3e-7);
- every parameter's gradient against ``jax.grad(model.loss_fn)``: its
  relative norm error ||g - g_ref|| / ||g_ref|| at 1e-4 (measured <= 2.5e-6),
  and elementwise at rtol 1e-4 with an atol of 1e-5 times the leaf's
  largest |g_ref| (a gradient sums B * L terms, so an element that cancels
  carries the rounding of its largest terms; measured max |g - g_ref| /
  max |g_ref| <= 2.8e-6);
- ``cross_entropy`` and AdamW, the same float32 arithmetic: rtol 1e-6;
- a 3-step training run's losses: rtol 1e-4. At step 1 Adam's update is
  about lr * sign(g), so parameters differ by up to 2 lr wherever |g| is
  near rounding noise; the parameters of whole steps are not compared,
  the gradients and the optimizer are, each on the same inputs;
- the token pipeline and ``quantize_int8``: bit for bit.
"""
import copy
import functools
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models.layers import cross_entropy as jcross_entropy  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import model_params_from_reference, opt_state_from_reference, reference_leaf  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.layers import cross_entropy  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-5
EXACT_TOL = dict(rtol=1e-6, atol=0.0)
RUN_RTOL = 1e-4
KEY = jax.random.PRNGKey(0)
# danube's window 16 bites at L 32
ARCHS = ["qwen2-0.5b", "h2o-danube-1.8b", "internvl2-1b", "granite-moe-1b-a400m", "deepseek-v2-236b"]
MOE_ARCHS = ARCHS[3:]
B, L = 4, 32
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these tiny CPU models, restored after each
    test: with the default (a thread a core) a test slows ~70x when
    parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str):
    return jconfigs.reduced_config(jconfigs.get_config(arch)), configs.reduced_config(configs.get_config(arch))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed: int, b: int = B, l: int = L) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, l + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :l], "labels": toks[:, 1:]}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = (0.02 * rng.standard_normal((b, l, cfg.d_model))).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """(reference model, params, batch, loss, grads) on reduced ``arch``."""
    jcfg, _ = _cfgs(arch)
    jm = JModel(jcfg, remat="none", dtype=jnp.float32)
    jp = jm.init(KEY)
    batch = _batch(jcfg, 1)
    loss, grads = jax.value_and_grad(jm.loss_fn)(jp, batch)
    return jm, jp, batch, float(loss), _np(grads)


def _port(arch: str, **model_kw) -> Model:
    _, jp, *_ = _reference(arch)
    cfg = _cfgs(arch)[1]
    m = Model(cfg, **model_kw)
    m.params = model_params_from_reference(_np(jp), cfg, "cpu")
    return m


def _loss_and_grads(m: Model, batch):
    return tstep.accumulate_grads(m, _torch(batch), 1)


# -----------------------------------------------------------------------------
# loss and gradients
# -----------------------------------------------------------------------------
def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = (4 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, 6] = -1
    for ignore in (-1, 5):
        want = float(jcross_entropy(logits, labels, ignore_id=ignore))
        got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), ignore_id=ignore)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, **EXACT_TOL)
    all_masked = np.full((2, 3), -1, np.int32)
    assert float(cross_entropy(torch.from_numpy(logits[:2, :3]), torch.from_numpy(all_masked))) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch):
    _, _, batch, want, _ = _reference(arch)
    m = _port(arch, remat="none")
    got = m.loss_fn(_torch(batch))
    assert got.requires_grad is False  # the parameters come frozen
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_matches_reference(arch):
    _, _, batch, want_loss, want = _reference(arch)
    m = _port(arch, remat="none")
    loss, grads = _loss_and_grads(m, batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert len(grads) == len(jax.tree.leaves(want)) + sum(
        (s.repeat - 1) * len(jax.tree.leaves(want[f"seg{i}"])) for i, s in enumerate(m.segments))
    for name, g in grads.items():
        ref = reference_leaf(want, name)
        scale = float(np.abs(ref).max())
        assert scale > 0, name
        assert np.linalg.norm(g.numpy() - ref) <= GRAD_NORM_RTOL * np.linalg.norm(ref), name
        np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_RTOL, atol=GRAD_ATOL_SCALE * scale, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS[:2] + MOE_ARCHS)
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_loss_and_gradients_of_none(remat, arch):
    """Rematerialization recomputes the same float32 ops: bit for bit on the CPU."""
    _, _, batch, *_ = _reference(arch)
    loss0, grads0 = _loss_and_grads(_port(arch, remat="none"), batch)
    loss, grads = _loss_and_grads(_port(arch, remat=remat), batch)
    assert torch.equal(loss, loss0)
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_loss_matches_reference(arch):
    """The router aux loss summed over the layers: the reference backbone's
    ``moe_aux`` (the loss carries it: ``test_loss_fn_matches_reference``)."""
    jm, jp, batch, want_loss, _ = _reference(arch)
    _, want_aux = jm.backbone(jp, jm.embed_input(jp, batch))
    m = _port(arch, remat="none")
    _, aux = m.hidden(m.embed_input(_torch(batch)))
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=LOSS_RTOL)


def test_model_rejects_an_unknown_remat():
    with pytest.raises(ValueError, match="remat"):
        Model(configs.reduced_config(configs.get_config("qwen2-0.5b")), remat="some")


def test_training_forward_takes_plain_attention(monkeypatch):
    """``loss_fn`` never reaches ``_attend``, the path that is the flash
    kernel on the card; serving's prefill does, once a layer."""
    _, _, batch, want, _ = _reference("qwen2-0.5b")
    calls = []
    real = attn._attend
    monkeypatch.setattr(attn, "_attend", lambda *a, **k: calls.append(1) or real(*a, **k))
    m = _port("qwen2-0.5b")
    np.testing.assert_allclose(float(m.loss_fn(_torch(batch))), want, rtol=LOSS_RTOL)
    assert calls == []
    m.prefill(_torch(batch))
    assert len(calls) == 2


def test_flash_kernel_refuses_operands_that_require_grad(monkeypatch):
    """The kernel has no backward: on the card its wrapper raises instead of
    returning an output that drops the gradients (``_on_card`` stands in)."""
    q = torch.zeros((1, 2, 8, 16), requires_grad=True)
    k = torch.zeros((1, 1, 8, 16))
    monkeypatch.setattr(ops, "_on_card", lambda *a, **kw: True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q.detach(), k.requires_grad_(True), k)


def test_init_parameters_stay_frozen_until_a_train_step():
    cfg = configs.reduced_config(configs.get_config("qwen2-0.5b"))
    m = Model(cfg, remat="none")
    params = m.init(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in params.parameters())
    tcfg = tstep.TrainConfig(opt=opt.AdamWConfig(lr=1e-3))
    batch = pipeline.device_put_batch(_batch(cfg, 2, 2, 8), "cpu")
    params, state, metrics = tstep.make_train_step(m, tcfg)(params, opt.init_opt_state(params, tcfg.opt), batch)
    assert all(p.requires_grad for p in params.parameters())
    assert int(state.step) == 1 and set(metrics) == {"loss", "grad_norm", "lr"}
    assert all(math.isfinite(float(v)) for v in metrics.values())


# -----------------------------------------------------------------------------
# AdamW
# -----------------------------------------------------------------------------
def _tree(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference_over_three_steps(state_dtype):
    jcfg = jopt.AdamWConfig(lr=1e-2, weight_decay=0.05, grad_clip=2.0, warmup_steps=2, total_steps=5,
                            state_dtype=getattr(jnp, state_dtype))
    cfg = opt.AdamWConfig(lr=1e-2, weight_decay=0.05, grad_clip=2.0, warmup_steps=2, total_steps=5,
                          state_dtype=getattr(torch, state_dtype))
    jp = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    jst = jopt.init_opt_state(jp, jcfg)
    p = {k: torch.from_numpy(v.copy()) for k, v in _tree(0).items()}
    st = opt.init_opt_state(p, cfg)
    for step in range(3):
        g = {k: v * (3.0 if step == 1 else 0.3) for k, v in _tree(10 + step).items()}  # step 1 clips
        jp, jst, jm = jopt.adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, jst, jcfg)
        p, st, m = opt.adamw_update(p, {k: torch.from_numpy(v) for k, v in g.items()}, st, cfg)
        assert int(st.step) == int(jst.step) == step + 1
        for name in p:
            np.testing.assert_allclose(p[name].numpy(), np.asarray(jp[name]), err_msg=name, **EXACT_TOL)
            for got, want in ((st.m[name], jst.m[name]), (st.v[name], jst.v[name])):
                assert got.dtype == getattr(torch, state_dtype)
                np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **EXACT_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), **EXACT_TOL)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), **EXACT_TOL)


def test_adamw_matches_hand_rolled_numpy():
    """Port of ``test_adamw_matches_reference``: one step against numpy."""
    cfg = opt.AdamWConfig(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.01,
                          grad_clip=1e9, warmup_steps=0, total_steps=10**9)
    w0 = np.asarray([[1.0, -2.0], [0.5, 3.0]], np.float32)
    g = np.asarray([[0.1, 0.2], [-0.3, 0.4]], np.float32)
    p = {"w": torch.from_numpy(w0.copy())}
    p2, st2, _ = opt.adamw_update(p, {"w": torch.from_numpy(g)}, opt.init_opt_state(p, cfg), cfg)
    m, v = 0.1 * g, 0.01 * g**2
    mh, vh = m / (1 - 0.9), v / (1 - 0.99)
    lr = float(opt.lr_at(cfg, torch.tensor(1)))
    want = w0 - lr * (mh / (np.sqrt(vh) + 1e-8) + 0.01 * w0)
    np.testing.assert_allclose(p2["w"].numpy(), want, rtol=1e-5)
    assert int(st2.step) == 1


def test_grad_clip_caps_update():
    cfg = opt.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0, warmup_steps=0)
    p = {"w": torch.zeros(4)}
    _, _, metrics = opt.adamw_update(p, {"w": 1e6 * torch.ones(4)}, opt.init_opt_state(p, cfg), cfg)
    assert float(metrics["grad_norm"]) > 1e5  # reported pre-clip


def test_lr_schedule_shape():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(opt.lr_at(cfg, torch.tensor(0))) == 0.0
    assert abs(float(opt.lr_at(cfg, torch.tensor(10))) - 1.0) < 1e-6
    assert abs(float(opt.lr_at(cfg, torch.tensor(100))) - 0.1) < 1e-3


def test_lr_at_matches_reference():
    jcfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=7, total_steps=100, min_lr_frac=0.1)
    cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=7, total_steps=100, min_lr_frac=0.1)
    steps = np.arange(121, dtype=np.int32)
    want = np.asarray(jopt.lr_at(jcfg, jnp.asarray(steps)))
    np.testing.assert_allclose(opt.lr_at(cfg, torch.from_numpy(steps)).numpy(), want, **EXACT_TOL)


def test_opt_state_from_reference_carries_every_moment():
    jm, jp, *_ = _reference("qwen2-0.5b")
    m = _port("qwen2-0.5b")
    names = [n for n, _ in m.params.named_parameters()]
    jst = jopt.init_opt_state(jp, jopt.AdamWConfig(state_dtype=jnp.bfloat16))
    jst = jst._replace(step=jnp.asarray(3, jnp.int32), m=jax.tree.map(lambda a: a + 0.5, jst.m))
    st = opt_state_from_reference(_np(jst), names, "cpu")
    assert int(st.step) == 3 and st.step.dtype == torch.int32
    assert set(st.m) == set(st.v) == set(names)
    assert all(t.dtype == torch.bfloat16 for t in st.m.values())
    assert all(float(t.float().min()) == 0.5 for t in st.m.values())


# -----------------------------------------------------------------------------
# train step: microbatches and a short run against the reference's
# -----------------------------------------------------------------------------
def test_microbatching_matches_single_batch():
    """Port of ``test_microbatching_matches_single_batch``: accumulating
    over 4 microbatches == one batch, at that test's tolerances."""
    cfg = configs.reduced_config(configs.get_config("qwen2-0.5b"))
    model = Model(cfg, remat="none")
    params = model.init(torch.Generator().manual_seed(0))
    opt_cfg = opt.AdamWConfig(lr=1e-3, weight_decay=0.0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 16)))
    batch = {"tokens": tokens, "labels": tokens}
    outs = []
    for n in (1, 4):
        p = copy.deepcopy(params)
        step = tstep.make_train_step(model, tstep.TrainConfig(opt=opt_cfg, microbatches=n))
        p2, _, metrics = step(p, opt.init_opt_state(p, opt_cfg), batch)
        outs.append((float(metrics["loss"]), p2))
    assert abs(outs[0][0] - outs[1][0]) < 1e-4
    for a, b in zip(outs[0][1].parameters(), outs[1][1].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=2e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_accumulated_gradients_match_one_batch(n):
    """``accumulate_grads`` over n microbatches gives one batch's loss and
    gradients (relative norm error at the gradients' tolerance); the first
    microbatch alone, divided by n, a fault the check must catch, does not."""
    _, _, batch, *_ = _reference("qwen2-0.5b")
    m = _port("qwen2-0.5b", remat="none")
    loss1, g1 = tstep.accumulate_grads(m, _torch(batch), 1)
    loss, g = tstep.accumulate_grads(m, _torch(batch), n)
    np.testing.assert_allclose(float(loss), float(loss1), rtol=LOSS_RTOL)
    assert set(g) == set(g1)
    for name in g1:
        assert torch.linalg.norm(g[name] - g1[name]) <= GRAD_NORM_RTOL * torch.linalg.norm(g1[name]), name
    _, first = tstep.accumulate_grads(m, {k: v[: B // n] for k, v in _torch(batch).items()}, 1)
    assert any(torch.linalg.norm(first[k] / n - g1[k]) > GRAD_NORM_RTOL * torch.linalg.norm(g1[k]) for k in g1)


@pytest.mark.parametrize("microbatches,compression", [(2, "none"), (1, "bf16")])
def test_three_steps_follow_the_reference_loss_trajectory(microbatches, compression):
    jcfg, cfg = _cfgs("qwen2-0.5b")
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    jm = JModel(jcfg, remat="none", dtype=jnp.float32)
    jp = jm.init(KEY)
    jt = jax.jit(jstep.make_train_step(jm, jstep.TrainConfig(
        opt=jopt.AdamWConfig(**kw), microbatches=microbatches, compression=compression)))
    jst = jopt.init_opt_state(jp, jopt.AdamWConfig(**kw))
    m = Model(cfg, remat="full")
    params = model_params_from_reference(_np(jp), cfg, "cpu")
    tcfg = tstep.TrainConfig(opt=opt.AdamWConfig(**kw), microbatches=microbatches, compression=compression)
    step_fn = tstep.make_train_step(m, tcfg)
    st = opt.init_opt_state(params, tcfg.opt)
    jsrc = jpipeline.SyntheticTokenSource(jcfg, jconfigs.ShapeConfig("t", 16, 4, "train"))
    src = pipeline.SyntheticTokenSource(cfg, configs.ShapeConfig("t", 16, 4, "train"))
    for step in range(3):
        jp, jst, jmet = jt(jp, jst, {k: jnp.asarray(v) for k, v in jsrc.batch_at(step).items()})
        params, st, met = step_fn(params, st, pipeline.device_put_batch(src.batch_at(step), "cpu"))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=RUN_RTOL)
        np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=RUN_RTOL)
        np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]), **EXACT_TOL)


def test_moe_microbatches_average_loss_and_aux_as_the_reference():
    """One step of granite-MoE in 2 microbatches: each microbatch routes at
    its own capacity and carries its own aux loss, and the step's loss and
    gradient norm are their means, as the reference's scan has them."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    jm = JModel(jcfg, remat="none", dtype=jnp.float32)
    jp = jm.init(KEY)
    jt = jax.jit(jstep.make_train_step(jm, jstep.TrainConfig(opt=jopt.AdamWConfig(**kw), microbatches=2)))
    batch = _batch(jcfg, 4)
    _, _, jmet = jt(jp, jopt.init_opt_state(jp, jopt.AdamWConfig(**kw)), {k: jnp.asarray(v) for k, v in batch.items()})
    m = Model(cfg, remat="none")
    params = model_params_from_reference(_np(jp), cfg, "cpu")
    tcfg = tstep.TrainConfig(opt=opt.AdamWConfig(**kw), microbatches=2)
    _, _, met = tstep.make_train_step(m, tcfg)(params, opt.init_opt_state(params, tcfg.opt), _torch(batch))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=GRAD_NORM_RTOL)
    whole = float(_port("granite-moe-1b-a400m", remat="none").loss_fn(_torch(batch)))
    assert abs(float(met["loss"]) - whole) > 1e-6  # not one batch's loss: capacity and aux are per microbatch


def test_split_microbatches_refuses_a_ragged_split():
    with pytest.raises(ValueError, match="microbatches"):
        tstep._split_microbatches({"tokens": torch.zeros((6, 4))}, 4)
    out = tstep._split_microbatches({"tokens": torch.arange(24).reshape(6, 4)}, 3)
    assert out["tokens"].shape == (3, 2, 4) and int(out["tokens"][1, 0, 0]) == 8


def test_auto_train_config_matches_reference():
    for param_count in (0.5e9, 3e9, 30e9, 236e9, 405e9):
        for global_batch, dp in ((256, 16), (256, 32), (8, 1), (24, 4), (1, 1)):
            for moe in (False, True):
                want = jstep.auto_train_config(param_count, global_batch, dp, moe)
                got = tstep.auto_train_config(param_count, global_batch, dp, moe)
                assert got.microbatches == want.microbatches
                assert str(got.opt.state_dtype).removeprefix("torch.") == jnp.dtype(want.opt.state_dtype).name
                assert str(got.accum_dtype).removeprefix("torch.") == jnp.dtype(want.accum_dtype).name


def test_auto_train_config_fits_batch():
    """Port of ``test_auto_train_config_fits_batch``."""
    t = tstep.auto_train_config(405e9, 256, 16)
    assert t.microbatches == 4 and t.opt.state_dtype == torch.bfloat16
    t = tstep.auto_train_config(405e9, 256, 32)
    assert (256 // t.microbatches) % 32 == 0
    t = tstep.auto_train_config(1e9, 256, 16)
    assert (256 // t.microbatches) % 16 == 0


# -----------------------------------------------------------------------------
# compression
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("shape,scale", [((1000,), 0.01), ((64, 64), 1.0), ((3, 300), 1e-3), ((256,), 0.0)])
def test_quantize_int8_is_the_reference_bit_for_bit(shape, scale):
    x = (scale * np.random.default_rng(sum(shape)).standard_normal(shape)).astype(np.float32)
    x.reshape(-1)[:3] = [scale, -scale, 0.5 * scale]  # ties at the block's largest magnitude
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    q, s = comp.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = comp.dequantize_int8(q, s, shape, torch.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jcomp.dequantize_int8(jq, js, shape, jnp.float32)))


def test_int8_quantization_roundtrip_error():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32) * 0.01)
    q, s = comp.quantize_int8(x)
    back = comp.dequantize_int8(q, s, x.shape, x.dtype)
    assert float(torch.linalg.norm(back - x) / torch.linalg.norm(x)) < 0.01  # blockwise int8 keeps ~1% error


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_compression_modes(mode):
    g = {"a": torch.from_numpy(np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32) * 0.01)}
    out = comp.compress_tree(g, mode)
    rel = float(torch.linalg.norm(out["a"].float() - g["a"]) / torch.linalg.norm(g["a"]))
    assert rel < (0.02 if mode != "none" else 1e-9)
    want = jcomp.compress_tree({"a": jnp.asarray(g["a"].numpy())}, mode)["a"]
    np.testing.assert_array_equal(out["a"].float().numpy(), np.asarray(want, np.float32))
    with pytest.raises(ValueError):
        comp.compress_tree(g, "fp4")


# -----------------------------------------------------------------------------
# the token pipeline
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-1b"])
def test_synthetic_batches_are_the_reference_bit_for_bit(arch):
    jcfg, cfg = _cfgs(arch)
    jsrc = jpipeline.SyntheticTokenSource(jcfg, jconfigs.ShapeConfig("t", 24, 3, "train"), jpipeline.DataConfig(seed=5))
    src = pipeline.SyntheticTokenSource(cfg, configs.ShapeConfig("t", 24, 3, "train"), pipeline.DataConfig(seed=5))
    for step, got in zip(range(4), src):
        want = jsrc.batch_at(step)
        assert sorted(got) == sorted(want) == sorted(["tokens", "labels"] + (["embeds"] if arch == "internvl2-1b" else []))
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    on_dev = pipeline.device_put_batch(src.batch_at(0), "cpu")
    assert on_dev["tokens"].dtype == on_dev["labels"].dtype == torch.int64
    np.testing.assert_array_equal(on_dev["tokens"].numpy(), jsrc.batch_at(0)["tokens"])


# -----------------------------------------------------------------------------
# the launcher
# -----------------------------------------------------------------------------
def test_loss_decreases_qwen():
    """Port of ``test_loss_decreases_qwen``."""
    out = train.main(["--device", "cpu", "--arch", "qwen2-0.5b", "--steps", "15", "--batch", "8", "--seq", "32",
                      "--lr", "3e-3", "--quiet"])
    assert out["losses"][-1] < out["losses"][0] * 0.9
    assert len(out["step_seconds"]) == 15 and out["tokens_per_s"] > 0
    assert out["final_loss"] == out["losses"][-1]


def test_launcher_runs_on_the_card_by_default():
    ap = train._parser()
    assert ap.parse_args([]).device == "cuda" and ap.parse_args([]).remat == "none"
    assert ap.parse_args(["--no-reduced"]).reduced is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--steps", "1", "--quiet"])


def test_loss_decreases_moe():
    """Port of ``test_loss_decreases_moe``."""
    out = train.main(["--device", "cpu", "--arch", "granite-moe-1b-a400m", "--steps", "12", "--batch", "8",
                      "--seq", "32", "--lr", "3e-3", "--quiet"])
    assert out["losses"][-1] < out["losses"][0]


def test_deepseek_trains_with_remat_dots():
    out = train.main(["--device", "cpu", "--arch", "deepseek-v2-236b", "--steps", "4", "--batch", "4", "--seq", "16",
                      "--remat", "dots", "--quiet"])
    assert len(out["losses"]) == 4 and all(math.isfinite(x) for x in out["losses"])


def test_train_lm_example_runs_on_the_cpu():
    """``examples/torch_train_lm.py`` at its defaults (reduced granite-MoE,
    200 steps, B 16, L 64, 4 microbatches, a checkpoint every 50 steps) on
    the CPU: its own assert is that the loss drops by more than 0.3 nats."""
    spec = importlib.util.spec_from_file_location("torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.run(["--device", "cpu"])
    assert len(out["losses"]) == 200 and out["losses"][0] - out["final_loss"] > 0.3


@pytest.mark.parametrize("arch,item", [("rwkv6-1.6b", "M4")])
def test_unported_archs_name_their_roadmap_item(arch, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        train.main(["--device", "cpu", "--arch", arch, "--steps", "1", "--quiet"])


def test_window_arch_trains_with_remat_and_compression():
    out = train.main(["--device", "cpu", "--arch", "h2o-danube-1.8b", "--steps", "4", "--batch", "4", "--seq", "32",
                      "--remat", "dots", "--compression", "bf16", "--quiet"])
    assert len(out["losses"]) == 4 and all(math.isfinite(x) for x in out["losses"])
