"""The port's LM serve path vs the JAX reference, on the CPU.

Inputs are drawn with numpy from fixed seeds and handed to both packages;
model weights are the reference's ``Model.init`` draws, carried into the
port by ``repro_torch.convert.model_params_from_reference``. On the CPU the
port's prefill attention is the plain ``_sdpa_auto`` and its
``ops.flash_attention`` is the plain ``ref.attention``; the reference's
Pallas flash kernel runs in interpret mode. Tolerances are the
reference's own: 3e-5 for the flash kernel (``tests/test_kernels.py``),
2e-3 for decode vs prefill logits (``tests/test_models.py``), and 1e-5 for
the attention building blocks (fp32, same algebra).

The port's temperature sampling draws from a ``torch.Generator`` with
``torch.multinomial``; it cannot reproduce ``jax.random.categorical``'s
bits, so sampled tokens are held to determinism, not to the reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import model_params_from_reference  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.layers import frozen  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serve.decode import generate  # noqa: E402

FLASH_TOL = dict(rtol=3e-5, atol=3e-5)  # tests/test_kernels.py::test_flash_attention
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)  # same fp32 algebra, other evaluation order
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_models.py decode vs full forward
KEY = jax.random.PRNGKey(7)


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params(jparams) -> torch.nn.ParameterDict:
    return frozen(**{k: torch.from_numpy(np.array(v)) for k, v in jparams.items()})


# -----------------------------------------------------------------------------
# flash attention: plain version and CPU wrapper vs the Pallas kernel
# -----------------------------------------------------------------------------
FLASH_SHAPES = [
    (1, 4, 2, 64, 16, None),   # GQA
    (2, 8, 8, 128, 64, None),  # MHA
    (1, 4, 1, 64, 32, 24),     # MQA + sliding window
    (1, 2, 2, 256, 128, None), # 128-aligned tiles
    (1, 14, 2, 64, 64, None),  # qwen-style 7x group
]


@pytest.mark.parametrize("b,hq,hk,l,d,window", FLASH_SHAPES)
def test_flash_attention_matches_reference(b, hq, hk, l, d, window):
    q = _normal(hq * l + d, (b, hq, l, d))
    k = _normal(hq * l + d + 1, (b, hk, l, d))
    v = _normal(hq * l + d + 2, (b, hk, l, d))
    want_kernel = np.asarray(jops.flash_attention(q, k, v, causal=True, window=window, interpret=True))
    want_oracle = np.asarray(jref.attention_ref(q, k, v, causal=True, window=window))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = ops.flash_attention.launches
    for got in (ref.attention(tq, tk, tv, causal=True, window=window),
                ops.flash_attention(tq, tk, tv, causal=True, window=window)):
        np.testing.assert_allclose(got.numpy(), want_kernel, **FLASH_TOL)
        np.testing.assert_allclose(got.numpy(), want_oracle, **FLASH_TOL)
    assert ops.flash_attention.launches == before  # the CPU path launches no kernel


@pytest.mark.parametrize("b,hq,hk,l,d,window", FLASH_SHAPES)
def test_flash_3xtf32_emulation_matches_reference(b, hq, hk, l, d, window):
    """The card's flash kernel computes both products in split TF32
    (x = hi + lo, three TF32 products each, ``ref.attention_3xtf32``
    emulates it); that arithmetic holds the reference's flash kernel
    (interpret mode) at the fp32 tolerance, while inputs rounded to TF32
    once do not."""
    q = _normal(hq * l + d, (b, hq, l, d))
    k = _normal(hq * l + d + 1, (b, hk, l, d))
    v = _normal(hq * l + d + 2, (b, hk, l, d))
    want = np.asarray(jops.flash_attention(q, k, v, causal=True, window=window, interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.attention_3xtf32(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)
    one_pass = ref.attention(ref.tf32_round(tq), ref.tf32_round(tk), ref.tf32_round(tv), causal=True, window=window)
    excess = np.abs(one_pass.numpy() - want) - (FLASH_TOL["atol"] + FLASH_TOL["rtol"] * np.abs(want))
    assert float(excess.max()) > 0  # inputs rounded to TF32 once already miss the fp32 tolerance


def test_flash_attention_non_causal_ragged_matches_oracle():
    q, k, v = _normal(1, (2, 6, 5, 24)), _normal(2, (2, 3, 9, 24)), _normal(3, (2, 3, 9, 24))
    want = np.asarray(jref.attention_ref(q, k, v, causal=False, scale=0.3))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=False, scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)


def test_flash_attention_wrapper_refuses_what_the_kernel_does_not_take():
    q, k = torch.zeros((1, 4, 8, 16)), torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="Lq == Lk"):
        ops.flash_attention(q[:, :, :5], k, k, causal=True)
    with pytest.raises(ValueError, match="Lq == Lk"):
        ops.flash_attention(q[:, :, :5], k, k, causal=False, window=4)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="do not match"):
        ops.flash_attention(q, torch.zeros((1, 3, 8, 16)), torch.zeros((1, 3, 8, 16)))
    with pytest.raises(ValueError, match="4-D"):
        ops.flash_attention(q[0], k[0], k[0])


def test_flash_matches_model_sdpa():
    """The plain flash version agrees with the model's einsum path, as the
    reference's ``test_flash_matches_model_sdpa``."""
    q, k, v = _normal(4, (2, 32, 8, 64)), _normal(5, (2, 32, 4, 64)), _normal(6, (2, 32, 4, 64))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = attn._sdpa(tq, tk, tv, causal=True, window=None)
    got = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(got, want, **FLASH_TOL)
    np.testing.assert_allclose(want.numpy(), np.asarray(jattn._sdpa(q, k, v, causal=True, window=None)),
                               **BLOCK_TOL)


# -----------------------------------------------------------------------------
# attention building blocks
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("theta,batched_pos", [(1_000_000.0, False), (10_000.0, True)])
def test_rope_matches_reference(theta, batched_pos):
    x = _normal(8, (2, 12, 3, 16))
    pos = np.arange(12, dtype=np.int32) + 5
    if batched_pos:
        pos = np.stack([pos, pos + 100])
    want = np.asarray(jattn.rope(x, pos, theta))
    got = attn.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), want, **BLOCK_TOL)


@pytest.mark.parametrize(
    "lq,lk,causal,window,q_offset,kv_len",
    [
        (10, 10, True, None, 0, None),  # prefill
        (10, 10, True, 4, 0, None),     # sliding window
        (1, 14, False, None, 12, 13),   # decode over a full cache
        (1, 8, False, None, 20, 8),     # decode over a wrapped ring
        (3, 14, True, None, 11, 14),    # offset query rows
    ],
)
def test_sdpa_matches_reference(lq, lk, causal, window, q_offset, kv_len):
    q, k, v = _normal(9, (2, lq, 4, 16)), _normal(10, (2, lk, 2, 16)), _normal(11, (2, lk, 2, 16))
    want = np.asarray(jattn._sdpa(q, k, v, causal, window, q_offset=q_offset, kv_len=kv_len))
    got = attn._sdpa(*(torch.from_numpy(a) for a in (q, k, v)), causal, window, q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), want, **BLOCK_TOL)


@pytest.mark.parametrize("window", [None, 300])
def test_sdpa_auto_q_chunked_matches_reference(window):
    q, k, v = _normal(12, (1, 3072, 2, 8)), _normal(13, (1, 3072, 1, 8)), _normal(14, (1, 3072, 1, 8))
    want = np.asarray(jattn._sdpa_auto(q, k, v, causal=True, window=window))
    got = attn._sdpa_auto(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want, **BLOCK_TOL)


def _gqa_cfg(cfgs, window):
    cfg = cfgs.reduced_config(cfgs.get_config("qwen2-0.5b"))
    return dataclasses.replace(cfg, num_heads=6, num_kv_heads=2, window=window)


@pytest.mark.parametrize(
    "window,l,cache_len",
    [(None, 11, 15), (16, 10, 20), (8, 21, 30)],
    ids=["full-cache", "ring-not-full", "ring-wrapped"],
)
def test_gqa_prefill_and_decode_match_reference(window, l, cache_len):
    jcfg, cfg = _gqa_cfg(jconfigs, window), _gqa_cfg(configs, window)
    jp = _np_tree(jattn.gqa_init(KEY, jcfg, jnp.float32))
    jp = {k: a + 0.1 * _normal(20 + i, a.shape) if k.startswith("b") else a for i, (k, a) in enumerate(jp.items())}
    p = _params(jp)
    ax = jattn.Axes(batch=("data",), model="model", model_size=1)
    x = _normal(15, (2, l, jcfg.d_model))
    want_y, want_cache = jattn.gqa_prefill(jp, x, jcfg, ax, cache_len)
    got_y, cache = attn.gqa_prefill(p, torch.from_numpy(x), cfg, cache_len)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **BLOCK_TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(want_cache.k), **BLOCK_TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(want_cache.v), **BLOCK_TOL)
    for i in range(4):
        xt = _normal(30 + i, (2, 1, jcfg.d_model))
        want_y, want_cache = jattn.gqa_decode(jp, xt, want_cache, jnp.asarray(l + i, jnp.int32), jcfg, ax)
        got_y, cache = attn.gqa_decode(p, torch.from_numpy(xt), cache, l + i, cfg)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **BLOCK_TOL)
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(want_cache.k), **BLOCK_TOL)


# -----------------------------------------------------------------------------
# configs
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(jconfigs.registry()))
def test_configs_are_the_reference_configs(name):
    got, want = configs.get_config(name), jconfigs.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(configs.reduced_config(got)) == dataclasses.asdict(jconfigs.reduced_config(want))
    assert got.param_count() == want.param_count()
    for shape in jconfigs.SHAPES:
        assert configs.shape_applicable(got, configs.SHAPES[shape]) == jconfigs.shape_applicable(
            want, jconfigs.SHAPES[shape])


# -----------------------------------------------------------------------------
# whole models: reduced configs, reference weights
# -----------------------------------------------------------------------------
def _qwen_14_2(cfgs):
    return dataclasses.replace(cfgs.reduced_config(cfgs.get_config("qwen2-0.5b")), num_heads=14, num_kv_heads=2)


MODEL_CASES = {
    "qwen2-0.5b": lambda c: c.reduced_config(c.get_config("qwen2-0.5b")),
    "h2o-danube-1.8b": lambda c: c.reduced_config(c.get_config("h2o-danube-1.8b")),
    "qwen2-0.5b-14/2-heads": _qwen_14_2,
    "internvl2-1b": lambda c: c.reduced_config(c.get_config("internvl2-1b")),
    "granite-moe-1b-a400m": lambda c: c.reduced_config(c.get_config("granite-moe-1b-a400m")),
    "deepseek-v2-236b": lambda c: c.reduced_config(c.get_config("deepseek-v2-236b")),
}
B, L, STEPS = 2, 24, 3
# the prompt's seed: 1, but granite's seed-1 prompt leaves both rows' top-2
# prefill logits within the greedy check's margin, where it says nothing
PROMPT_SEED = {"granite-moe-1b-a400m": 2}


def _align_cf(cfg):
    """The reference's ``align_cf``: an MoE config's capacity factor set to
    2.0, the prefill's and decode's, so the full forward routes as they do
    (at 4 experts, top-2, that is a slot for every token: none drops)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=2.0))


def _pair(case: str, align_cf: bool = False):
    """(reference model, its params, port model with the same weights)."""
    jcfg, cfg = MODEL_CASES[case](jconfigs), MODEL_CASES[case](configs)
    if align_cf:
        jcfg, cfg = _align_cf(jcfg), _align_cf(cfg)
    jm = JModel(jcfg, remat="none", dtype=jnp.float32)
    jp = jm.init(KEY)
    m = Model(cfg)
    m.params = model_params_from_reference(_np_tree(jp), cfg, "cpu")
    return jm, jp, m


def _batch(cfg, seed: int, n: int):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = (0.1 * rng.normal(size=(B, n, cfg.d_model))).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _argmax_where_decided(logits: np.ndarray, tokens: np.ndarray) -> None:
    """Greedy tokens agree wherever the top-2 margin exceeds the tolerance."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * (LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * np.abs(top2[..., 1]))
    assert decided.any()
    np.testing.assert_array_equal(np.argmax(logits, -1)[decided], tokens[decided])


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_prefill_and_decode_match_reference(case):
    jm, jp, m = _pair(case)
    cfg = m.cfg
    batch = _batch(cfg, PROMPT_SEED.get(case, 1), L)
    want_logits, jcaches = jm.prefill(jp, batch, cache_len=L + STEPS + 1)
    got_logits, caches = m.prefill(_torch_batch(batch), cache_len=L + STEPS + 1)
    assert got_logits.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), **LOGIT_TOL)
    tok = np.asarray(jnp.argmax(want_logits[:, -1], -1)).astype(np.int32)[:, None]
    _argmax_where_decided(got_logits[:, -1].numpy(), tok[:, 0])
    if cfg.input_mode == "embeddings":
        return  # decode feeds tokens; the stub's embeddings have no token ids
    for i in range(STEPS):  # teacher-forced with the reference's greedy tokens
        want_logits, jcaches = jm.decode_step(jp, jcaches, tok, jnp.asarray(L + i, jnp.int32))
        got_logits, caches = m.decode_step(caches, torch.from_numpy(tok), L + i)
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(want_logits[:, -1], -1)).astype(np.int32)[:, None]
        _argmax_where_decided(got_logits[:, -1].numpy(), tok[:, 0])


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_decode_matches_full_forward(case):
    """The port's own decode steps against its full forward, teacher-forced
    (the reference's ``test_decode_matches_full_forward``, with its
    ``align_cf``); the full forward's aux loss is the reference's (0 without
    an MoE layer)."""
    jm, jp, m = _pair(case, align_cf=True)
    cfg = m.cfg
    batch = _batch(cfg, 2, L + 2)
    full = _torch_batch(batch)

    def full_logits(n):
        x = m.embed_input({k: v[:, :n] for k, v in full.items()})
        h, aux = m.backbone(x)
        _, want_aux = jm.backbone(jp, jm.embed_input(jp, {k: v[:, :n] for k, v in batch.items()}))
        np.testing.assert_allclose(float(aux), float(want_aux), **BLOCK_TOL)
        assert (float(aux) > 0) == (cfg.moe is not None)
        return m.logits(h)[:, -1]

    lg, caches = m.prefill({k: v[:, :L] for k, v in full.items()}, cache_len=L + 4)
    torch.testing.assert_close(lg[:, -1], full_logits(L), **LOGIT_TOL)
    if cfg.input_mode == "embeddings":
        return
    for i in range(2):
        lg, caches = m.decode_step(caches, full["tokens"][:, L + i : L + i + 1], L + i)
        torch.testing.assert_close(lg[:, -1], full_logits(L + i + 1), **LOGIT_TOL)


def test_model_init_has_the_reference_parameters():
    """Same names and shapes as the reference's tree (stacked segments
    unstacked); ``param_count`` leaves out the QKV biases and the final norm."""
    cfg = configs.reduced_config(configs.get_config("qwen2-0.5b"))
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    extra = cfg.num_layers * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.resolved_head_dim() + cfg.d_model
    assert sum(p.numel() for p in params.parameters()) == cfg.param_count() + extra
    assert not any(p.requires_grad for p in params.parameters())
    jp = JModel(jconfigs.reduced_config(jconfigs.get_config("qwen2-0.5b")), remat="none", dtype=jnp.float32).init(KEY)
    got = {k: tuple(v.shape) for k, v in m.params.state_dict().items()}
    assert got == _reference_shapes(jp)


def _reference_shapes(jp) -> dict[str, tuple[int, ...]]:
    """The port's parameter names and shapes of a reference tree: key paths
    joined by dots, stacked segments unstacked into ``seg{i}.{r}``."""
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        if keys[0].startswith("seg"):
            for r in range(leaf.shape[0]):
                want[".".join([keys[0], str(r)] + keys[1:])] = tuple(leaf.shape[1:])
        else:
            want[".".join(keys)] = tuple(leaf.shape)
    return want


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "deepseek-v2-236b"])
def test_moe_model_init_has_the_reference_parameters(name):
    """Names, shapes and count of the MoE archs' trees, including the nodes
    that mix arrays and sub-dicts (MLA's ``q_norm`` / ``kv_norm``, the shared
    experts); ``param_count`` leaves out MLA's two norms and the final norm.
    The converted reference tree has the same names."""
    cfg = configs.reduced_config(configs.get_config(name))
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    jcfg = jconfigs.reduced_config(jconfigs.get_config(name))
    jp = JModel(jcfg, remat="none", dtype=jnp.float32).init(KEY)
    want = _reference_shapes(jp)
    assert {k: tuple(v.shape) for k, v in params.state_dict().items()} == want
    assert set(model_params_from_reference(_np_tree(jp), cfg, "cpu").state_dict()) == set(want)
    norms = cfg.num_layers * (cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank) if cfg.mla else 0
    assert sum(p.numel() for p in params.parameters()) == cfg.param_count() + norms + cfg.d_model


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_unported_mixers_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(configs.reduced_config(configs.get_config(name)))


# -----------------------------------------------------------------------------
# the serve entry point and generate
# -----------------------------------------------------------------------------
def test_serve_main_on_the_cpu_is_seeded():
    argv = ["--device", "cpu", "--batch", "3", "--prompt-len", "20", "--tokens", "5", "--quiet"]
    out = serve.main(argv)
    tokens = out["tokens"]
    assert tokens.shape == (3, 5) and tokens.dtype == torch.int32
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 512
    assert out["prefill_s"] > 0 and out["decode_s"] > 0 and out["seconds"] > 0
    assert torch.equal(serve.main(argv)["tokens"], tokens)
    windowed = serve.main(argv + ["--arch", "h2o-danube-1.8b", "--prompt-len", "40"])["tokens"]
    assert windowed.shape == (3, 5)


def test_serve_parser_reduced_flag():
    ap = serve._parser()
    assert ap.parse_args([]).reduced is True
    assert ap.parse_args(["--no-reduced"]).reduced is False
    assert ap.parse_args([]).device == "cuda"


def test_generate_greedy_matches_teacher_forced_argmax():
    cfg = configs.reduced_config(configs.get_config("h2o-danube-1.8b"))
    model, prompt, extra, _ = serve.setup(cfg, 2, 30, torch.device("cpu"), seed=3)
    tokens = generate(model, prompt, steps=6)
    assert tokens.shape == (2, 6) and extra is None
    seq = torch.cat([prompt, tokens.long()], dim=1)
    h, _ = model.backbone(model.embed_input({"tokens": seq}))
    _argmax_where_decided(model.logits(h)[:, 29:35].numpy(), tokens.numpy())


def test_temperature_sampling_is_seeded_by_the_generator():
    cfg = configs.reduced_config(configs.get_config("qwen2-0.5b"))
    model, prompt, _, _ = serve.setup(cfg, 2, 12, torch.device("cpu"), seed=0)
    runs = [generate(model, prompt, steps=8, temperature=40.0, generator=torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert int(runs[0].max()) < cfg.vocab_size and int(runs[0].min()) >= 0
    assert not torch.equal(runs[0][:, 1:], runs[2][:, 1:])  # the first token is always greedy
