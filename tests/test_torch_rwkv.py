"""The port's RWKV-6 time mix and channel mix (``repro_torch.models.rwkv``)
and the rwkv6 model that runs them, against the JAX reference on the CPU.

Inputs are drawn with numpy from fixed seeds and handed to both packages;
the weights are the reference's draws (``rwkv_time_mix_init``,
``rwkv_channel_mix_init``, ``Model.init``), carried across as numpy.
Tolerances:

- the building blocks, the WKV recurrences and their states, the mixers'
  outputs: 1e-5 (fp32, the same algebra in another evaluation order);
- the time mix's gradient against ``jax.grad``: the relative norm error at
  1e-4 and elementwise at rtol 1e-4 with an atol of 1e-5 times the leaf's
  largest |g| (``tests/test_torch_train.py``'s gradient tolerances);
- whole-model logits: 2e-3 (``tests/test_models.py``'s decode-vs-forward
  tolerance), the prefill's states 1e-5.

At init ``w0`` is -6, so each step decays by e^{-e^{-6}} ≈ 0.9975 and the
chunked WKV's clamp of a chunk's cumulative log decay at -25 never binds:
the mixer tests raise ``w0`` to about -1, and one case to +1, where a
chunk's cumulative log decay passes -25 and the clamp binds. The reduced
rwkv6 runs at prompts of 24 (the token recurrence) and 32 (the chunked
WKV), the reference's jitted init, prefill and decode once per prompt.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import Axes  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import model_params_from_reference  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import frozen, rmsnorm  # noqa: E402

from _torch_reference import reference_greedy_run, reference_shapes  # noqa: E402

BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_NORM_RTOL, GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-4, 1e-5
ARCH = "rwkv6-1.6b"
KEY = jax.random.PRNGKey(7)
AX = Axes(batch=("data",), model="model", model_size=1)
B, STEPS = 2, 3
CACHE_LEN = 32 + STEPS
NH, HS = 4, 16  # the reduced config's heads


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
def _tm_params(w0: float = -1.0) -> dict[str, np.ndarray]:
    """The reference's time-mix draws with the constants moved off their
    init values (token-shift mixes, bonus u, head-norm scale, and w0 to
    about ``w0``), so that every parameter enters the comparison."""
    jp = {k: np.array(v) for k, v in jrwkv.rwkv_time_mix_init(KEY, _cfgs()[0], jnp.float32).items()}
    for i, name in enumerate(("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "u", "ln_scale")):
        jp[name] = jp[name] + _normal(40 + i, jp[name].shape, 0.1)
    jp["w0"] = w0 + _normal(50, jp["w0"].shape, 0.3)
    return jp


@functools.lru_cache(maxsize=None)
def _cm_params() -> dict[str, np.ndarray]:
    jp = {k: np.array(v) for k, v in jrwkv.rwkv_channel_mix_init(KEY, _cfgs()[0], jnp.float32).items()}
    for i, name in enumerate(("mix_k", "mix_r")):
        jp[name] = jp[name] + _normal(60 + i, jp[name].shape, 0.1)
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
# the mixers, function by function
# -----------------------------------------------------------------------------
def test_rwkv_init_draws_the_reference_shapes_and_constants():
    jcfg, cfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    for jinit, init in ((jrwkv.rwkv_time_mix_init, rwkv.rwkv_time_mix_init),
                        (jrwkv.rwkv_channel_mix_init, rwkv.rwkv_channel_mix_init)):
        want = {k: np.asarray(v) for k, v in jinit(KEY, jcfg, jnp.float32).items()}
        got = init(gen, cfg)
        assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        assert all(v.dtype == torch.float32 and not v.requires_grad for v in got.values())
        for name in want:
            if not name.startswith("w") or name == "w0":
                np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
    assert rwkv._dims(cfg) == jrwkv._dims(jcfg) == (NH, HS, 8)


def test_mix_decay_and_head_norm_match_reference():
    jp = _tm_params()
    p = _torch_params(jp)
    x, xp = _normal(1, (B, 7, 64)), _normal(2, (B, 7, 64))
    _close(rwkv._mix(torch.from_numpy(x), torch.from_numpy(xp), p["mix_w"]), jrwkv._mix(x, xp, jp["mix_w"]))
    w = rwkv._decay(p, torch.from_numpy(x))
    assert w.dtype == torch.float32 and float(w.min()) > 0 and float(w.max()) < 1
    _close(w, jrwkv._decay(jp, x))
    out = _normal(3, (B, 7, NH, HS))
    _close(rwkv._head_norm(p, torch.from_numpy(out)), jrwkv._head_norm(jp, out))
    _close(rwkv._shift(torch.from_numpy(x)), np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1])


def _wkv_inputs(l: int, w0: float):
    """r, k, v (B, l, H, hs), the decays of a time mix with ``w0`` about
    ``w0`` on a random input, a non-zero bonus u and start state s0."""
    rh, kh, vh = (_normal(4 + i, (B, l, NH, HS)) for i in range(3))
    wh = np.array(jrwkv._decay(_tm_params(w0), _normal(7, (B, l, 64)))).reshape(B, l, NH, HS)
    return rh, kh, vh, wh, _tm_params(w0)["u"], _normal(8, (B, NH, HS, HS), 0.1)


def test_wkv_naive_matches_reference():
    args = _wkv_inputs(24, -1.0)
    want_s, want_out = jrwkv._wkv_naive(*args)
    got_s, got_out = rwkv._wkv_naive(*(torch.from_numpy(a) for a in args))
    _close(got_out, want_out, what="out")
    _close(got_s, want_s, what="state")


@pytest.mark.parametrize("w0,clamp_binds", [(-1.0, False), (1.0, True)], ids=["w0-1", "w0+1-clamp-binds"])
def test_wkv_chunked_matches_reference(w0, clamp_binds):
    args = _wkv_inputs(48, w0)
    wh = args[3]
    lw = np.cumsum(np.log(wh.reshape(B, 3, 16, NH, HS)), axis=2)  # each chunk's cumulative log decay
    assert bool((lw < rwkv._LOG_DECAY_CLAMP).any()) == clamp_binds
    assert float(np.abs(args[4]).min()) > 0  # a non-zero bonus u
    want_s, want_out = jrwkv._wkv_chunked(*args)
    got_s, got_out = rwkv._wkv_chunked(*(torch.from_numpy(a) for a in args))
    _close(got_out, want_out, what="out")
    _close(got_s, want_s, what="state")


@pytest.mark.parametrize("l,w0", [(24, -1.0), (32, -1.0), (32, 1.0)],
                         ids=["naive", "chunked", "chunked-clamp-binds"])
def test_rwkv_time_mix_state_and_gradient_match_reference(l, w0):
    """The output on the reference's branch (chunked where 16 divides L),
    the WKV state after the sequence against the reference's re-scan
    (``_rwkv_final_state``), and the gradient of <out, cotangent> with
    respect to every parameter and the input."""
    jcfg, cfg = _cfgs()
    jp = _tm_params(w0)
    x = _normal(9, (B, l, 64))
    cot = _normal(10, (B, l, 64))

    def loss(p, x):
        return jnp.sum(jrwkv.rwkv_time_mix(p, x, jcfg, AX) * cot)

    want_out = jrwkv.rwkv_time_mix(jp, x, jcfg, AX)
    want_gp, want_gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, x)
    p = _torch_params(jp, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    out, s = rwkv.rwkv_time_mix_with_state(p, tx, cfg)
    _close(out, want_out, what="output")
    _close(s, jtf._rwkv_final_state(jp, x, jcfg), what="state")
    naive = rwkv.rwkv_time_mix(p, tx, cfg, chunked=False)
    _close(naive, jrwkv.rwkv_time_mix(jp, x, jcfg, AX, chunked=False), what="naive output")
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [tx, *p.values()])
    _grad_close(grads[0], want_gx, "input")
    for (name, _), g in zip(p.items(), grads[1:]):
        _grad_close(g, want_gp[name], name)


@pytest.mark.parametrize("with_prev", [False, True], ids=["shift-zeros", "x_prev"])
def test_rwkv_channel_mix_matches_reference(with_prev):
    jp = _cm_params()
    x = _normal(11, (B, 9, 64))
    prev = _normal(12, (B, 64)) if with_prev else None
    want = jrwkv.rwkv_channel_mix(jp, x, prev)
    got = rwkv.rwkv_channel_mix(_torch_params(jp), torch.from_numpy(x), None if prev is None else torch.from_numpy(prev))
    _close(got, want)


def test_rwkv_decode_matches_reference_over_three_steps():
    """Three time-mix steps from the state after a 5-token prefix: each
    output, and every field of the state (``x_prev_cm`` passes through)."""
    jcfg, cfg = _cfgs()
    jtm, jcm = _tm_params(), _cm_params()
    tm, cm = _torch_params(jtm), _torch_params(jcm)
    prefix = _normal(13, (B, 5, 64))
    jstate = jrwkv.RWKVState(x_prev_tm=prefix[:, -1], x_prev_cm=_normal(14, (B, 64)),
                             s=np.asarray(jtf._rwkv_final_state(jtm, prefix, jcfg)))
    state = rwkv.RWKVState(*(torch.from_numpy(np.array(a)) for a in jstate))
    for i in range(STEPS):
        x = _normal(15 + i, (B, 1, 64))
        want, jstate = jrwkv.rwkv_decode(jtm, jcm, x, jstate, jcfg)
        got, state = rwkv.rwkv_decode(tm, cm, torch.from_numpy(x), state, cfg)
        _close(got, want, what=f"step {i} output")
        for field in state._fields:
            _close(getattr(state, field), getattr(jstate, field), what=f"step {i} {field}")


# -----------------------------------------------------------------------------
# the reduced rwkv6: prefill, decode, states, against the reference
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


def _hold_caches(caches, want, m: tf.Model, what: str) -> None:
    """Every layer's RWKVState against the reference's (stacked on the
    repeat axis), field by field."""
    for _, _, si, r, name in m._layers():
        got, ref = caches[f"seg{si}"][r][name], want[f"seg{si}"][name]
        assert isinstance(got, rwkv.RWKVState) and got._fields == ref._fields
        for field in got._fields:
            _close(getattr(got, field), getattr(ref, field)[r], what=f"{what} seg{si}.{r}.{name}.{field}")


@pytest.mark.parametrize("l", [24, 32], ids=["prompt-24", "prompt-32"])
def test_rwkv6_prefill_and_decode_match_reference(l):
    """Prefill logits and every layer's state, then three teacher-forced
    decode steps: each step's logits and states (the channel mix's
    ``x_prev_cm`` is the previous token's input at every step)."""
    run = _reference_run(l)
    m = _port()
    logits, caches = m.prefill({"tokens": torch.from_numpy(run["prompt"])}, cache_len=CACHE_LEN)
    _close(logits, run["logits"][0], LOGIT_TOL, "prefill logits")
    _hold_caches(caches, run["caches"][0], m, "prefill")
    for i, tok in enumerate(run["tokens"]):
        logits, caches = m.decode_step(caches, torch.from_numpy(tok), l + i)
        _close(logits, run["logits"][i + 1], LOGIT_TOL, f"decode step {i} logits")
        _hold_caches(caches, run["caches"][i + 1], m, f"decode step {i}")


@pytest.mark.parametrize("l", [24, 32], ids=["prompt-24", "prompt-32"])
def test_rwkv6_prefill_states_are_the_rescanned_final_states(l):
    """The prefill takes each layer's WKV state from the forward's own scan;
    the reference scans again with r = 0 (``_rwkv_final_state``). r never
    enters the state update: the same bits. The token-shift states are the
    last positions' inputs to the time and channel mix."""
    m = _port()
    x = m.embed_input({"tokens": torch.from_numpy(_tokens(1, l))})
    with torch.inference_mode():
        for params, d, *_ in m._layers():
            h = rmsnorm(params["norm1"], x, m.cfg.norm_eps)
            x_mid = x + rwkv.rwkv_time_mix(params["mixer"], h, m.cfg)
            x, cache = tf.layer_prefill(params, x, m.cfg, d, l)
            assert torch.equal(cache.s, tf._rwkv_final_state(params["mixer"], h, m.cfg))
            assert torch.equal(cache.x_prev_tm, h[:, -1])
            assert torch.equal(cache.x_prev_cm, rmsnorm(params["norm2"], x_mid, m.cfg.norm_eps)[:, -1])


def test_rwkv6_decode_matches_full_forward():
    """The port's decode steps against its own full forward, teacher-forced,
    over three steps: passing the new ``x_prev_cm`` to the channel mix and
    the old one to the cache agrees at one step and fails at the second."""
    m = _port()
    l = 24
    seq = torch.from_numpy(_tokens(2, l + STEPS)).long()

    def full_logits(n):
        h, aux = m.backbone(m.embed_input({"tokens": seq[:, :n]}))
        assert float(aux) == 0.0
        return m.logits(h)[:, -1]

    lg, caches = m.prefill({"tokens": seq[:, :l]}, cache_len=l + STEPS)
    torch.testing.assert_close(lg[:, -1], full_logits(l), **LOGIT_TOL)
    for i in range(STEPS):
        lg, caches = m.decode_step(caches, seq[:, l + i : l + i + 1], l + i)
        torch.testing.assert_close(lg[:, -1], full_logits(l + i + 1), **LOGIT_TOL)


def test_rwkv6_has_the_reference_parameters():
    """Names and shapes of the reduced rwkv6's tree and of the converted
    reference tree; one segment of (time mix, channel mix) layers."""
    cfg = _cfgs()[1]
    params = tf.Model(cfg).init(torch.Generator().manual_seed(0))
    want = reference_shapes(_reference()[1])
    assert {k: tuple(v.shape) for k, v in params.state_dict().items()} == want
    assert {k: tuple(v.shape) for k, v in _port().params.state_dict().items()} == want
    segs = tf.build_segments(configs.get_config(ARCH))
    assert [(s.repeat, [(d.mixer, d.ffn) for d in s.layers]) for s in segs] == [(24, [("r", "rwkv")])]
