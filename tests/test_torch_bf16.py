"""The port at bf16, the reference Model's own dtype, against the JAX
reference on the CPU.

- The flash wrapper's plain version at bf16 (``ref.attention``: fp32
  scores, softmax and sums, bf16 out) against the reference's Pallas
  kernel in interpret mode, at the reference's own bf16 tolerance, 3e-2
  (``tests/test_kernels.py::test_flash_attention_bf16``).
- The converter: the reference's default-dtype ``Model.init`` (bf16 but
  the norms and the MoE router, which are float32) crosses into the port
  and back bit for bit, every leaf's dtype kept, and the port's tensors
  have the dtypes of the port's own bf16 init.
- A bf16 prefill and 3 teacher-forced decode steps of the port's ``Model``
  against the reference's on the same bf16 weights. The bound is the
  reference's own: at each step the port's logits lie within twice the gap
  between the reference's bf16 logits and its fp32 logits of the same
  weights and tokens (bf16 rounds at other places in the two frameworks,
  so bit equality is not expected; the gap says how far bf16 rounding
  moves the logits). Greedy tokens agree wherever the reference's top-2
  margin exceeds twice that bound.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import model_params_from_reference, model_params_to_reference  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

from test_torch_models import FLASH_SHAPES, MODEL_CASES  # noqa: E402

BF16_FLASH_TOL = dict(rtol=3e-2, atol=3e-2)  # tests/test_kernels.py::test_flash_attention_bf16
KEY = jax.random.PRNGKey(7)
CASES = {
    **MODEL_CASES,
    "jamba-v0.1-52b": lambda c: c.reduced_config(c.get_config("jamba-v0.1-52b")),
    "rwkv6-1.6b": lambda c: c.reduced_config(c.get_config("rwkv6-1.6b")),
}
B, L, STEPS = 2, 24, 3


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these tiny CPU models (parallel test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -----------------------------------------------------------------------------
# flash attention's plain version at bf16
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("b,hq,hk,l,d,window", FLASH_SHAPES + [(1, 4, 2, 128, 64, None)])
def test_flash_plain_bf16_matches_the_reference_kernel(b, hq, hk, l, d, window):
    rng = np.random.default_rng(hq * l + d)
    q, k, v = (rng.normal(size=(b, h, l, d)).astype(np.float32) for h in (hq, hk, hk))
    want = jops.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True, window=window,
                                interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=True, window=window)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_FLASH_TOL)


# -----------------------------------------------------------------------------
# bf16 weights across
# -----------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference(case: str):
    """(reference config, reference model at its default dtype, its params as numpy)."""
    jcfg = CASES[case](jconfigs)
    jm = JModel(jcfg, remat="none")
    return jcfg, jm, jax.tree.map(np.asarray, jax.jit(jm.init)(KEY))


def _port(case: str) -> Model:
    cfg = CASES[case](configs)
    m = Model(cfg, dtype=torch.bfloat16)
    m.params = model_params_from_reference(_reference(case)[2], cfg, "cpu")
    return m


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_bf16_init_round_trips_through_the_converter(case):
    _, jm, tree = _reference(case)
    assert jm.dtype == jnp.bfloat16
    m = _port(case)
    own = dict(Model(m.cfg, dtype=torch.bfloat16).init(torch.Generator().manual_seed(0)).named_parameters())
    assert {n: p.dtype for n, p in m.params.named_parameters()} == {n: p.dtype for n, p in own.items()}
    assert {p.dtype for p in own.values()} == {torch.bfloat16, torch.float32}
    back = model_params_to_reference(m.params, m)
    want, tdef = jax.tree_util.tree_flatten_with_path(tree)
    got = jax.tree.leaves(back)
    assert jax.tree.structure(back) == tdef and len(got) == len(want)
    for (path, w), g in zip(want, got):
        assert g.dtype == w.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=jax.tree_util.keystr(path))


# -----------------------------------------------------------------------------
# the bf16 model path
# -----------------------------------------------------------------------------
def _decided_agree(port: np.ndarray, want: np.ndarray, bound: float) -> int:
    """Greedy tokens agree wherever the reference's top-2 margin exceeds
    twice ``bound``; returns how many rows were decided."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * bound
    np.testing.assert_array_equal(np.argmax(port, -1)[decided], np.argmax(want, -1)[decided])
    return int(decided.sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_prefill_and_decode_meet_the_reference_bf16_run(case):
    jcfg, jm, tree = _reference(case)
    m = _port(case)
    jm32 = JModel(jcfg, remat="none", dtype=jnp.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, L)).astype(np.int32)}
    if jcfg.input_mode == "embeddings":
        batch["embeds"] = (0.1 * rng.normal(size=(B, L, jcfg.d_model))).astype(np.float32)
    cache_len = L + STEPS + 1
    want, jc = jm.prefill(jp, batch, cache_len=cache_len)
    want32, jc32 = jm32.prefill(jp32, batch, cache_len=cache_len)
    got, caches = m.prefill({k: torch.from_numpy(v) for k, v in batch.items()}, cache_len=cache_len)
    assert {t.dtype for c in caches["seg0"][0].values() for t in c} <= {torch.bfloat16, torch.float32}
    steps = 0 if jcfg.input_mode == "embeddings" else STEPS  # decode feeds tokens
    decided = 0
    for i in range(steps + 1):
        want_np, got_np = np.asarray(want, np.float32), got.float().numpy()
        bound = 2 * float(np.abs(np.asarray(want32, np.float32) - want_np).max())
        gap = float(np.abs(got_np - want_np).max())
        assert 0 < gap <= bound, f"step {i}: port {gap} from the reference's bf16 logits, bound {bound}"
        decided += _decided_agree(got_np[:, -1], want_np[:, -1], bound)
        if i == steps:
            break
        tok = np.argmax(want_np[:, -1], -1).astype(np.int32)[:, None]
        want, jc = jm.decode_step(jp, jc, jnp.asarray(tok), L + i)
        want32, jc32 = jm32.decode_step(jp32, jc32, jnp.asarray(tok), L + i)
        got, caches = m.decode_step(caches, torch.from_numpy(tok), L + i)
    assert decided
