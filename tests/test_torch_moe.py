"""The port's MoE FFN (``repro_torch.models.moe``) and DeepSeek-V2's MLA
(``repro_torch.models.attention.mla_*``) against the JAX reference, on the
CPU.

Inputs are drawn with numpy from fixed seeds; parameters are the
reference's ``moe_init`` / ``mla_init`` draws at the reduced configs
(granite-MoE: 4 experts, top-2, expert width 32; DeepSeek: 4 experts, top-2,
2 shared, MLA ranks 32 / 48 / 16 / 8 / 16), carried across as arrays.
Routes (expert ids, queue positions, ``keep``) are held equal, exactly;
outputs, gates and aux losses at ``BLOCK_TOL`` (1e-5: fp32, the same
algebra in another evaluation order; the port's combine sums a token's
top-k outputs with ``.sum(1)``, the reference with a scatter-add).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import Axes  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import checkpointer as ck  # noqa: E402
from repro_torch.convert import _tree  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import Model, build_segments  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, init_opt_state  # noqa: E402

BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
KEY = jax.random.PRNGKey(3)
AX = Axes(batch=("data",), model="model", model_size=1)
MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]


def _cfgs(arch: str, **moe_changes):
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    cfg = configs.reduced_config(configs.get_config(arch))
    if moe_changes:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_changes))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_changes))
    return jcfg, cfg


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _skewed(seed: int, shape) -> np.ndarray:
    """Tokens sharing one direction, so the router sends most of them to the
    same experts and some expert queues overflow."""
    rng = np.random.default_rng(seed)
    common = rng.normal(size=shape[-1])
    return (rng.normal(size=shape) + 3.0 * common).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_params(jparams):
    return _tree(_np_tree(jparams), torch.device("cpu"))


# -----------------------------------------------------------------------------
# dispatch and routing
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("tk,num_experts,capacity", [(96, 4, 30), (96, 4, 8), (60, 7, 12), (16, 32, 8)])
def test_dispatch_indices_match_reference(tk, num_experts, capacity):
    rng = np.random.default_rng(tk + num_experts + capacity)
    # skewed ids: expert 0 takes about half the slots, so its queue overflows
    ids = np.where(rng.random(tk) < 0.5, 0, rng.integers(0, num_experts, tk)).astype(np.int32)
    want_idx, want_keep = jmoe._dispatch_indices(jnp.asarray(ids), num_experts, capacity)
    got_idx, got_keep = moe._dispatch_indices(torch.from_numpy(ids).long(), num_experts, capacity)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_keep.numpy(), np.asarray(want_keep))
    assert (~got_keep).any() == (np.bincount(ids, minlength=num_experts).max() > capacity)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_reference(arch):
    """``route`` against the reference's routing lines in ``moe_ffn``, on
    skewed tokens whose queues overflow at capacity factor 1.25."""
    jcfg, cfg = _cfgs(arch)
    jp = jmoe.moe_init(KEY, jcfg, jnp.float32)
    xt = _skewed(1, (48, jcfg.d_model))
    m = jcfg.moe
    capacity = max(int(48 * m.top_k * m.capacity_factor / m.num_experts), 8)
    assert capacity == moe.capacity_of(48, cfg.moe)
    logits = jnp.asarray(xt) @ jp["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    gates, idx = jax.lax.top_k(probs, m.top_k)
    gates = gates / jnp.maximum(jnp.sum(gates, axis=-1, keepdims=True), 1e-9)
    want_idx, want_keep = jmoe._dispatch_indices(idx.reshape(-1), m.num_experts, capacity)
    r = moe.route(_port_params(jp), torch.from_numpy(xt), cfg, capacity)
    np.testing.assert_array_equal(r.expert_ids.numpy(), np.asarray(idx).reshape(-1))
    np.testing.assert_array_equal(r.buf_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(want_keep))
    assert (~r.keep).any()  # the case drops slots
    np.testing.assert_allclose(r.gates.numpy(), np.asarray(gates), **BLOCK_TOL)
    np.testing.assert_allclose(r.probs.numpy(), np.asarray(probs), **BLOCK_TOL)
    sorted_probs = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    np.testing.assert_allclose(r.margin.numpy(), sorted_probs[:, m.top_k - 1] - sorted_probs[:, m.top_k], **BLOCK_TOL)


def test_route_margin_is_inf_when_every_expert_is_taken():
    _, cfg = _cfgs("granite-moe-1b-a400m", top_k=4)
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    r = moe.route(params, torch.from_numpy(_normal(2, (5, cfg.d_model))), cfg, 8)
    assert torch.isinf(r.margin).all() and r.keep.all()
    assert torch.equal(r.expert_ids.view(5, 4).sort(1).values, torch.arange(4).expand(5, 4))


# -----------------------------------------------------------------------------
# the MoE FFN
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor,skew", [(None, False), (None, True), (2.0, False)],
                         ids=["config-cf", "config-cf-drops", "cf-2.0"])
def test_moe_ffn_matches_reference(arch, capacity_factor, skew):
    """Output and aux losses at ``BLOCK_TOL``, routes exactly; the skewed case
    (4 experts, capacity factor 1.25, t = 48) drops slots."""
    jcfg, cfg = _cfgs(arch)
    jp = jmoe.moe_init(KEY, jcfg, jnp.float32)
    x = (_skewed if skew else _normal)(4, (2, 24, jcfg.d_model))
    want_y, want_aux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, AX, capacity_factor)
    params = _port_params(jp)
    y, aux = moe.moe_ffn(params, torch.from_numpy(x), cfg, capacity_factor)
    capacity = moe.capacity_of(48, cfg.moe, capacity_factor)
    r = moe.route(params, torch.from_numpy(x).reshape(48, -1), cfg, capacity)
    assert bool((~r.keep).any()) == skew
    assert y.shape == x.shape and isinstance(aux, moe.MoEAux)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **BLOCK_TOL)
    np.testing.assert_allclose(float(aux.load_balance), float(want_aux.load_balance), **BLOCK_TOL)
    np.testing.assert_allclose(float(aux.z_loss), float(want_aux.z_loss), **BLOCK_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_gradients_match_reference_with_drops(arch):
    """Gradients of a scalar of the output and the aux losses, with respect
    to every parameter and the input, on the skewed case that drops slots:
    relative norm error at 1e-4 (``tests/test_torch_train.py``'s gradient
    tolerance)."""
    jcfg, cfg = _cfgs(arch)
    jp = jmoe.moe_init(KEY, jcfg, jnp.float32)
    x = _skewed(4, (2, 24, jcfg.d_model))
    w = _normal(9, x.shape)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, x, jcfg, AX)
        return jnp.sum(y * w) + aux.load_balance + aux.z_loss

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    params = _port_params(jp)
    params.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_ffn(params, xt, cfg)
    (torch.sum(y * torch.from_numpy(w)) + aux.load_balance + aux.z_loss).backward()
    got = dict(params.named_parameters())
    for name, p in got.items():
        ref = np.asarray(jax.tree_util.tree_reduce(lambda a, k: a[k], name.split("."), want_p))
        assert np.linalg.norm(p.grad.numpy() - ref) <= 1e-4 * np.linalg.norm(ref), name
    assert np.linalg.norm(xt.grad.numpy() - np.asarray(want_x)) <= 1e-4 * np.linalg.norm(np.asarray(want_x))


def _direct_moe(params, xt: torch.Tensor, r: moe.Route, top_k: int) -> torch.Tensor:
    """Each token's kept slots, computed token by token: gate * expert FFN."""
    y = torch.zeros_like(xt)
    for slot, (e, g, kept) in enumerate(zip(r.expert_ids.tolist(), r.gates.reshape(-1).tolist(), r.keep.tolist())):
        if kept:
            t = slot // top_k
            h = torch.nn.functional.silu(xt[t] @ params["w_gate"][e]) * (xt[t] @ params["w_up"][e])
            y[t] += g * (h @ params["w_down"][e])
    return y


def test_a_dropped_slot_cannot_overwrite_the_kept_slot_it_aliases(monkeypatch):
    """Every token routes to experts 0 and 1, 48 tokens into 30 slots each:
    tokens 30..47 are dropped and alias slot 29, which token 29 keeps. The
    output holds each kept slot's own expert output (``_direct_moe``); the
    planted fault, dropped slots written at their aliased index, overwrites
    token 29's slot with token 47's, and the check catches it."""
    _, cfg = _cfgs("granite-moe-1b-a400m")
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    params["router"].data[:, :2] += 50.0 * torch.ones(cfg.d_model, 1) / cfg.d_model**0.5
    xt = torch.from_numpy(np.abs(_normal(5, (48, cfg.d_model))))  # positive: the router favours experts 0, 1
    r = moe.route(params, xt, cfg, moe.capacity_of(48, cfg.moe))
    assert set(r.expert_ids.tolist()) == {0, 1} and moe.capacity_of(48, cfg.moe) == 30
    assert r.keep.view(48, 2)[:30].all() and not r.keep.view(48, 2)[30:].any()
    want = _direct_moe(params, xt, r, 2)
    y, _ = moe.moe_ffn(params, xt[None], cfg)
    torch.testing.assert_close(y[0], want, **BLOCK_TOL)

    def unmasked(contrib, r, num_experts, capacity):
        buffers = contrib.new_zeros((num_experts * capacity, contrib.shape[1])).index_put((r.buf_idx,), contrib)
        return buffers.view(num_experts, capacity, -1)

    monkeypatch.setattr(moe, "_expert_buffers", unmasked)
    bad, _ = moe.moe_ffn(params, xt[None], cfg)
    torch.testing.assert_close(bad[0, :29], want[:29], **BLOCK_TOL)
    assert not torch.allclose(bad[0, 29], want[29], **BLOCK_TOL)


def test_moe_init_draws_in_the_reference_order():
    """router, w_gate, w_up, w_down, then shared.{w_gate, w_up, w_down}, each a
    fan-in-scaled normal from one generator; the router is fp32."""
    _, cfg = _cfgs("deepseek-v2-236b")
    m, d = cfg.moe, cfg.d_model
    params = moe.moe_init(torch.Generator().manual_seed(4), cfg, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(4)
    shapes = [("router", (d, m.num_experts), d), ("w_gate", (m.num_experts, d, m.d_expert), d),
              ("w_up", (m.num_experts, d, m.d_expert), d), ("w_down", (m.num_experts, m.d_expert, d), m.d_expert),
              ("shared.w_gate", (d, 2 * m.d_expert), d), ("shared.w_up", (d, 2 * m.d_expert), d),
              ("shared.w_down", (2 * m.d_expert, d), 2 * m.d_expert)]
    got = dict(params.named_parameters())
    assert sorted(got) == sorted(name for name, _, _ in shapes)
    for name, shape, fan_in in shapes:
        want = fan_in**-0.5 * torch.randn(shape, generator=gen)
        assert got[name].dtype == (torch.float32 if name == "router" else torch.bfloat16), name
        assert torch.equal(got[name], want if name == "router" else want.to(torch.bfloat16)), name
        assert not got[name].requires_grad


# -----------------------------------------------------------------------------
# MLA
# -----------------------------------------------------------------------------
def test_mla_forward_matches_reference():
    jcfg, cfg = _cfgs("deepseek-v2-236b")
    jp = jattn.mla_init(KEY, jcfg, jnp.float32)
    x = _normal(6, (2, 13, jcfg.d_model))
    want = jattn.mla_forward(jp, jnp.asarray(x), jcfg, AX)
    got = attn.mla_forward(_port_params(jp), torch.from_numpy(x), cfg)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


@pytest.mark.parametrize("l,cache_len", [(11, 16), (16, 16)], ids=["room", "full"])
def test_mla_prefill_and_decode_match_reference(l, cache_len):
    """Prefill (the expanded latent, cache of latents ‖ roped key) and the
    absorbed decode, which writes at ``pos`` (clamped to the last slot, as
    the reference's ``dynamic_update_slice``)."""
    jcfg, cfg = _cfgs("deepseek-v2-236b")
    jp = jattn.mla_init(KEY, jcfg, jnp.float32)
    p = _port_params(jp)
    x = _normal(7, (2, l, jcfg.d_model))
    want_y, want_cache = jattn.mla_prefill(jp, jnp.asarray(x), jcfg, AX, cache_len)
    got_y, cache = attn.mla_prefill(p, torch.from_numpy(x), cfg, cache_len)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **BLOCK_TOL)
    np.testing.assert_allclose(cache.ckv.numpy(), np.asarray(want_cache.ckv), **BLOCK_TOL)
    assert cache.ckv.shape == (2, cache_len, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)
    for i in range(3):
        xt = _normal(40 + i, (2, 1, jcfg.d_model))
        want_y, want_cache = jattn.mla_decode(jp, jnp.asarray(xt), want_cache, jnp.asarray(l + i, jnp.int32), jcfg, AX)
        got_y, cache = attn.mla_decode(p, torch.from_numpy(xt), cache, l + i, cfg)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **BLOCK_TOL)
        np.testing.assert_allclose(cache.ckv.numpy(), np.asarray(want_cache.ckv), **BLOCK_TOL)


def test_mla_absorbed_decode_matches_the_expanded_forward():
    """The port's own absorbed decode step against the last row of its
    expanded forward over the extended sequence."""
    _, cfg = _cfgs("deepseek-v2-236b")
    p = attn.mla_init(torch.Generator().manual_seed(1), cfg)
    x = torch.from_numpy(_normal(8, (2, 10, cfg.d_model)))
    _, cache = attn.mla_prefill(p, x[:, :9], cfg, 12)
    y, _ = attn.mla_decode(p, x[:, 9:], cache, 9, cfg)
    torch.testing.assert_close(y[:, 0], attn.mla_forward(p, x, cfg)[:, -1], **BLOCK_TOL)


# -----------------------------------------------------------------------------
# the model: segments, checkpoints
# -----------------------------------------------------------------------------
def test_deepseek_first_layer_dense():
    """Port of the reference's ``test_deepseek_first_layer_dense``."""
    segs = build_segments(configs.get_config("deepseek-v2-236b"))
    assert segs[0].repeat == 1 and segs[0].layers[0].ffn == "dense"
    assert segs[1].repeat == 59 and segs[1].layers[0].ffn == "moe"
    assert all(d.mixer == "a" for s in segs for d in s.layers)


def test_deepseek_params_and_opt_state_checkpoint_roundtrip(tmp_path):
    """A reduced DeepSeek's (params, AdamW state) round trip bit for bit; its
    key paths are the reference's, through the mixed nodes (MLA's norms
    beside its weights, the shared experts beside the routed ones)."""
    _, cfg = _cfgs("deepseek-v2-236b")
    params = Model(cfg).init(torch.Generator().manual_seed(1))
    opt = init_opt_state(params, AdamWConfig())
    opt = opt._replace(step=opt.step + 2, v={k: v + 0.5 for k, v in opt.v.items()})
    ck.save(str(tmp_path), 2, (params, opt))
    like = (Model(cfg).init(torch.Generator().manual_seed(2)), init_opt_state(params, AdamWConfig()))
    (got_p, got_opt), step = ck.restore(str(tmp_path), like)
    assert step == 2 and int(got_opt.step) == 2
    names = [n for n, _ in params.named_parameters()]
    assert "seg0.0.l0.mixer.q_norm.scale" in names and "seg1.0.l0.ffn.shared.w_gate" in names
    assert "seg1.0.l0.ffn.router" in names and "seg0.0.l0.ffn.router" not in names
    for a, b in zip(ck._flatten((params, opt)), ck._flatten((got_p, got_opt))):
        assert a[0] == b[0] and torch.equal(a[1], b[1])
