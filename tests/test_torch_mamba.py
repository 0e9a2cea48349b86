"""The port's Mamba mixer (``repro_torch.models.mamba``) and the Jamba
hybrid that runs it, against the JAX reference on the CPU.

Inputs are drawn with numpy from fixed seeds and handed to both packages;
the weights are the reference's draws (``mamba_init``, ``Model.init``),
carried across as numpy. Tolerances:

- the mixer's building blocks, its output and its states: 1e-5 (fp32, the
  same algebra in another evaluation order);
- its gradient against ``jax.grad``: the relative norm error at 1e-4 and
  elementwise at rtol 1e-4 with an atol of 1e-5 times the leaf's largest
  |g| (``tests/test_torch_train.py``'s gradient tolerances);
- whole-model logits: 2e-3 (``tests/test_models.py``'s decode-vs-forward
  tolerance), the prefill's states 1e-5.

The whole reduced jamba (8 layers: Mamba with dense and MoE FFNs, one
attention layer) is run at prompts of 24 (the scan's chunk of 1) and 32
(its chunk of 16); the reference's jitted init, prefill and decode run
once per prompt (``_reference_run``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import mamba as jmam  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import Axes  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import model_params_from_reference  # noqa: E402
from repro_torch.models import mamba as mam  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import frozen, rmsnorm  # noqa: E402

from _torch_reference import reference_greedy_run, reference_shapes  # noqa: E402

BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_NORM_RTOL, GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-4, 1e-5
ARCH = "jamba-v0.1-52b"
KEY = jax.random.PRNGKey(7)
AX = Axes(batch=("data",), model="model", model_size=1)
B, STEPS = 2, 3
CACHE_LEN = 32 + STEPS  # the attention layer's KV cache at both prompts


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these tiny CPU models, restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _cfgs():
    return jconfigs.reduced_config(jconfigs.get_config(ARCH)), configs.reduced_config(configs.get_config(ARCH))


@functools.lru_cache(maxsize=None)
def _mixer_params() -> dict[str, np.ndarray]:
    """The reference's ``mamba_init`` draws, with the zero conv bias and the
    constant dt bias, A and D moved off their init values, so that every
    parameter enters the comparison."""
    jp = {k: np.array(v) for k, v in jmam.mamba_init(KEY, _cfgs()[0], jnp.float32).items()}
    for i, name in enumerate(("conv_b", "dt_bias", "a_log", "d_skip")):
        jp[name] = jp[name] + _normal(40 + i, jp[name].shape, 0.1)
    return jp


def _torch_params(jp, requires_grad: bool = False):
    if requires_grad:
        return {k: torch.tensor(v, requires_grad=True) for k, v in jp.items()}
    return frozen(**{k: torch.from_numpy(v.copy()) for k, v in jp.items()})


def _close(got: torch.Tensor, want, tol=BLOCK_TOL, what: str = "") -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=what, **tol)


def _grad_close(got: torch.Tensor, want, what: str) -> None:
    got, want = got.numpy(), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    assert np.linalg.norm(got - want) <= GRAD_NORM_RTOL * np.linalg.norm(want), what
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL_SCALE * scale, err_msg=what)


# -----------------------------------------------------------------------------
# the mixer, function by function
# -----------------------------------------------------------------------------
def test_mamba_init_draws_the_reference_shapes_and_constants():
    jcfg, cfg = _cfgs()
    want = {k: np.asarray(v) for k, v in jmam.mamba_init(KEY, jcfg, jnp.float32).items()}
    got = mam.mamba_init(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 and not v.requires_grad for v in got.values())
    for name in ("conv_b", "dt_bias", "a_log", "d_skip"):
        _close(got[name], want[name], what=name)
    d_in, d_state, d_conv, dt_rank = mam._dims(cfg)
    assert (d_in, d_state, d_conv, dt_rank) == jmam._dims(jcfg) == (128, 8, 4, 4)


def test_conv_causal_matches_reference():
    jp = _mixer_params()
    x = _normal(1, (B, 10, 128))
    want = jmam._conv_causal(x, jp["conv_w"], jp["conv_b"])
    got = mam._conv_causal(torch.from_numpy(x), torch.from_numpy(jp["conv_w"]), torch.from_numpy(jp["conv_b"]))
    _close(got, want)


def test_ssm_params_match_reference():
    jp = _mixer_params()
    x = _normal(2, (B, 10, 128))
    want = jmam._ssm_params(jp, x, 8, 4)
    got = mam._ssm_params(_torch_params(jp), torch.from_numpy(x), 8, 4)
    for name, g, w in zip(("dt", "b", "c", "a"), got, want):
        assert g.dtype == torch.float32
        _close(g, w, what=name)


@pytest.mark.parametrize("l", [32, 24], ids=["chunk-16", "chunk-1"])
def test_ssm_scan_matches_reference(l):
    d, n = 128, 8
    xs = _normal(3, (B, l, d))
    dt = np.log1p(np.exp(_normal(4, (B, l, d)))).astype(np.float32)
    b, c = _normal(5, (B, l, n)), _normal(6, (B, l, n))
    a = -np.exp(_normal(7, (d, n), 0.3))
    h0 = _normal(8, (B, d, n), 0.1)
    want_h, want_y = jmam._ssm_scan(xs, dt, b, c, a, h0)
    got_h, got_y = mam._ssm_scan(*(torch.from_numpy(t) for t in (xs, dt, b, c, a, h0)))
    _close(got_y, want_y, what="ys")
    _close(got_h, want_h, what="final state")


@pytest.mark.parametrize("l", [32, 24], ids=["chunk-16", "chunk-1"])
def test_mamba_forward_state_and_gradient_match_reference(l):
    """The output, the decode state after the sequence (the pre-conv tail
    and the reference's re-scanned final state) and the gradient of
    <out, cotangent> with respect to every parameter and the input."""
    jcfg, cfg = _cfgs()
    jp = _mixer_params()
    u = _normal(9, (B, l, jcfg.d_model))
    cot = _normal(10, (B, l, jcfg.d_model))

    def loss(p, x):
        return jnp.sum(jmam.mamba_forward(p, x, jcfg, AX) * cot)

    want_out = jmam.mamba_forward(jp, u, jcfg, AX)
    want_gp, want_gu = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, u)
    p = _torch_params(jp, requires_grad=True)
    tu = torch.tensor(u, requires_grad=True)
    out, state = mam.mamba_forward_with_state(p, tu, cfg)
    _close(out, want_out, what="output")
    xs = (u @ jp["in_proj"])[..., : mam._dims(cfg)[0]]
    _close(state.conv, xs[:, -3:], what="conv state")
    _close(state.ssm, jtf._mamba_final_state(jp, u, jcfg), what="ssm state")
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [tu, *p.values()])
    _grad_close(grads[0], want_gu, "input")
    for (name, _), g in zip(p.items(), grads[1:]):
        _grad_close(g, want_gp[name], name)


def test_mamba_decode_matches_reference_over_three_steps():
    """Three decode steps from the state after a 5-token prefix, each
    step's output and both parts of the state."""
    jcfg, cfg = _cfgs()
    jp = _mixer_params()
    p = _torch_params(jp)
    prefix = _normal(11, (B, 5, jcfg.d_model))
    xs = (prefix @ jp["in_proj"])[..., :128]
    jstate = jmam.MambaState(conv=xs[:, -3:], ssm=jtf._mamba_final_state(jp, prefix, jcfg))
    _, state = mam.mamba_forward_with_state(p, torch.from_numpy(prefix), cfg)
    _close(state.ssm, jstate.ssm, what="prefix state")
    for i in range(STEPS):
        u = _normal(12 + i, (B, 1, jcfg.d_model))
        want, jstate = jmam.mamba_decode(jp, u, jstate, jcfg, AX)
        got, state = mam.mamba_decode(p, torch.from_numpy(u), state, cfg)
        _close(got, want, what=f"step {i} output")
        _close(state.conv, jstate.conv, what=f"step {i} conv state")
        _close(state.ssm, jstate.ssm, what=f"step {i} ssm state")


# -----------------------------------------------------------------------------
# the reduced jamba: prefill, decode, states, against the reference
# -----------------------------------------------------------------------------
def _tokens(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, _cfgs()[0].vocab_size, (B, n)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference():
    """(reference model, its jitted init's params as numpy, its jitted decode step)."""
    jm = jtf.Model(_cfgs()[0], remat="none", dtype=jnp.float32)
    return jm, jax.tree.map(np.asarray, jax.jit(jm.init)(KEY)), jax.jit(jm.decode_step)


def _port() -> tf.Model:
    cfg = _cfgs()[1]
    m = tf.Model(cfg)
    m.params = model_params_from_reference(_reference()[1], cfg, "cpu")
    return m


@functools.lru_cache(maxsize=None)
def _reference_run(l: int) -> dict:
    """The reference's prefill of a seed-1 prompt of ``l`` tokens and STEPS
    greedy decode steps after it, at one CACHE_LEN for both prompts."""
    jm, jp, decode = _reference()
    return reference_greedy_run(jm, jp, decode, _tokens(1, l), STEPS, CACHE_LEN)


def _hold_caches(caches, want, m: tf.Model, what: str) -> int:
    """Every layer's cache against the reference's (stacked on the repeat
    axis), field by field; returns the Mamba states compared."""
    n = 0
    for _, d, si, r, name in m._layers():
        got, ref = caches[f"seg{si}"][r][name], want[f"seg{si}"][name]
        assert type(got).__name__ == type(ref).__name__
        for field in got._fields:
            _close(getattr(got, field), getattr(ref, field)[r], what=f"{what} seg{si}.{r}.{name}.{field}")
        n += d.mixer == "m"
    return n


@pytest.mark.parametrize("l", [24, 32], ids=["prompt-24", "prompt-32"])
def test_jamba_prefill_and_decode_match_reference(l):
    """Prefill logits and every layer's cache (Mamba states at 1e-5, the
    attention layer's KV cache), then three teacher-forced decode steps."""
    run = _reference_run(l)
    m = _port()
    logits, caches = m.prefill({"tokens": torch.from_numpy(run["prompt"])}, cache_len=CACHE_LEN)
    _close(logits, run["logits"][0], LOGIT_TOL, "prefill logits")
    assert _hold_caches(caches, run["caches"][0], m, "prefill") == 7
    for i, tok in enumerate(run["tokens"]):
        logits, caches = m.decode_step(caches, torch.from_numpy(tok), l + i)
        _close(logits, run["logits"][i + 1], LOGIT_TOL, f"decode step {i} logits")
        _hold_caches(caches, run["caches"][i + 1], m, f"decode step {i}")


@pytest.mark.parametrize("l", [24, 32], ids=["prompt-24", "prompt-32"])
def test_jamba_prefill_states_are_the_rescanned_final_states(l):
    """The prefill takes each Mamba layer's state from the forward's own
    scan; the reference scans the layer input again
    (``_mamba_final_state``). Same operations on the same input: the same bits."""
    m = _port()
    x = m.embed_input({"tokens": torch.from_numpy(_tokens(1, l))})
    n = 0
    with torch.inference_mode():
        for params, d, *_ in m._layers():
            h = rmsnorm(params["norm1"], x, m.cfg.norm_eps)
            x, cache = tf.layer_prefill(params, x, m.cfg, d, l)
            if d.mixer == "m":
                assert torch.equal(cache.ssm, tf._mamba_final_state(params["mixer"], h, m.cfg))
                assert torch.equal(cache.conv, (h @ params["mixer"]["in_proj"])[:, -3:, :128])
                n += 1
    assert n == 7


def test_jamba_decode_matches_full_forward():
    """The port's decode steps against its own full forward, teacher-forced,
    at capacity factor 2.0 (the reference's ``align_cf``: 4 experts, top-2,
    a slot for every token)."""
    cfg = _cfgs()[1]
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=2.0))
    m = tf.Model(cfg)
    m.params = model_params_from_reference(_reference()[1], cfg, "cpu")
    l = 24
    seq = torch.from_numpy(_tokens(2, l + 2)).long()

    def full_logits(n):
        h, aux = m.backbone(m.embed_input({"tokens": seq[:, :n]}))
        assert float(aux) > 0
        return m.logits(h)[:, -1]

    lg, caches = m.prefill({"tokens": seq[:, :l]}, cache_len=l + 4)
    torch.testing.assert_close(lg[:, -1], full_logits(l), **LOGIT_TOL)
    for i in range(2):
        lg, caches = m.decode_step(caches, seq[:, l + i : l + i + 1], l + i)
        torch.testing.assert_close(lg[:, -1], full_logits(l + i + 1), **LOGIT_TOL)


def test_jamba_has_the_reference_parameters():
    """Names and shapes of the reduced jamba's tree, the converted reference
    tree's names, and the count: ``param_count`` leaves out the final norm."""
    cfg = _cfgs()[1]
    params = tf.Model(cfg).init(torch.Generator().manual_seed(0))
    want = reference_shapes(_reference()[1])
    assert {k: tuple(v.shape) for k, v in params.state_dict().items()} == want
    assert {k: tuple(v.shape) for k, v in _port().params.state_dict().items()} == want
    assert sum(p.numel() for p in params.parameters()) == cfg.param_count() + cfg.d_model


def test_jamba_pattern():
    """Port of the reference's ``test_jamba_pattern``, and the 8-layer cut
    that the card serves."""
    segs = tf.build_segments(configs.get_config(ARCH))
    assert segs[0].repeat == 4 and len(segs[0].layers) == 8
    assert [d.mixer for d in segs[0].layers] == ["m", "m", "m", "m", "a", "m", "m", "m"]
    assert [d.ffn == "moe" for d in segs[0].layers] == [False, True] * 4

    def layout(segments):
        return [(s.repeat, [(d.mixer, d.ffn) for d in s.layers]) for s in segments]

    cut = layout(tf.build_segments(dataclasses.replace(configs.get_config(ARCH), num_layers=8)))
    assert cut == layout(jtf.build_segments(dataclasses.replace(jconfigs.get_config(ARCH), num_layers=8)))
    assert sum(r * len(layers) for r, layers in cut) == 8
