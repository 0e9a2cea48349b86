"""Port NMF fits vs ``repro.factorization.nmf`` with the reference's init draws."""
import importlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_reference import init_draws  # noqa: E402
from repro.factorization.synthetic import nmf_data as jnmf_data  # noqa: E402
from repro_torch.convert import factors_from_reference, to_tensor  # noqa: E402
from repro_torch.random import init_draws as port_init_draws  # noqa: E402
from repro_torch.random import lane_generator  # noqa: E402

# the packages re-export the function ``nmf``, which shadows the module name
jnmf = importlib.import_module("repro.factorization.nmf")
tnmf = importlib.import_module("repro_torch.factorization.nmf")

KEY = jax.random.PRNGKey(0)
FACTOR_TOL = dict(rtol=1e-4, atol=1e-6)  # W/H after a full fit, fp32


@pytest.fixture(scope="module")
def v_np():
    v, _, _ = jnmf_data(KEY, n=48, m=40, k_true=4)
    return np.array(v)


@pytest.mark.parametrize("k", [2, 4, 6])
def test_nmf_matches_reference(v_np, k):
    key = jax.random.fold_in(KEY, k)
    ref = jnmf.nmf(v_np, k, key, iters=60)
    w_draw, h_draw = init_draws(key, *v_np.shape, k)
    got = tnmf.nmf(torch.from_numpy(v_np), k, torch.from_numpy(w_draw), torch.from_numpy(h_draw), iters=60)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), **FACTOR_TOL)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(ref.h), **FACTOR_TOL)
    np.testing.assert_allclose(float(got.rel_error), float(ref.rel_error), rtol=1e-5)


def test_reference_factors_carry_across(v_np):
    """W/H of a reference fit, converted, give the reference's rel_error."""
    ref = jnmf.nmf(v_np, 4, KEY, iters=40)
    w, h = factors_from_reference(ref.w, ref.h, device="cpu")
    err = tnmf.reconstruction_error(to_tensor(v_np, "cpu"), w, h)
    np.testing.assert_allclose(float(err), float(ref.rel_error), rtol=1e-5)
    assert w.dtype == torch.float32 and tuple(h.shape) == (4, v_np.shape[1])


@pytest.mark.parametrize("k_eff,k_pad", [(3, 6), (6, 6), (1, 4)])
def test_masked_fit_matches_reference_and_keeps_zero_columns(v_np, k_eff, k_pad):
    key = jax.random.fold_in(KEY, 100 + k_eff)
    ref = jnmf._nmf_masked(v_np, k_eff, key, k_pad, iters=60)
    w_draw, h_draw = init_draws(key, *v_np.shape, k_pad)
    got = tnmf._nmf_masked(
        torch.from_numpy(v_np), k_eff, torch.from_numpy(w_draw), torch.from_numpy(h_draw), k_pad, iters=60
    )
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), **FACTOR_TOL)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(ref.h), **FACTOR_TOL)
    assert float(got.w[:, k_eff:].abs().sum()) == 0.0
    assert float(got.h[k_eff:, :].abs().sum()) == 0.0


def test_nmf_batched_matches_reference(v_np):
    ks, k_pad = [2, 3, 5], 5
    ref = jnmf.nmf_batched(v_np, ks, KEY, k_pad=k_pad, iters=50)
    parts = [init_draws(jax.random.fold_in(KEY, k), *v_np.shape, k_pad) for k in ks]
    draws = tuple(torch.from_numpy(np.stack(p)) for p in zip(*parts))
    got = tnmf.nmf_batched(torch.from_numpy(v_np), ks, k_pad=k_pad, iters=50, draws=draws)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), **FACTOR_TOL)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(ref.h), **FACTOR_TOL)
    for lane, k in enumerate(ks):
        assert float(got.w[lane, :, k:].abs().sum()) == 0.0


def test_nmf_batched_lane_at_k_pad_is_the_scalar_fit(v_np):
    """Own draws: the lane at k == k_pad reproduces the per-k fit."""
    v = torch.from_numpy(v_np)
    res = tnmf.nmf_batched(v, [2, 4], seed=3, k_pad=4, iters=30)
    w_draw, h_draw = port_init_draws(lane_generator(3, 4, "cpu"), *v_np.shape, 4)
    single = tnmf.nmf(v, 4, w_draw, h_draw, iters=30)
    torch.testing.assert_close(res.w[1], single.w, rtol=1e-5, atol=1e-7)


def test_steps_gate_advances_each_fit_exactly_its_steps(v_np):
    """A fit gated to s sweeps inside a longer call equals an s-sweep fit."""
    v = torch.from_numpy(v_np).expand(2, *v_np.shape).contiguous()
    w_draw, h_draw = (torch.from_numpy(np.stack([a, a])) for a in init_draws(KEY, *v_np.shape, 4))
    k_eff = torch.tensor([4, 3])
    w0, h0 = tnmf._masked_init(v, k_eff, w_draw, h_draw, 4)
    w, h, _ = tnmf._masked_sweeps(v, w0, h0, k_eff, 4, 10, steps=torch.tensor([10, 4]))
    w4, h4, _ = tnmf._masked_sweeps(v[1], w0[1], h0[1], 3, 4, 4)
    w10, _, _ = tnmf._masked_sweeps(v, w0, h0, k_eff, 4, 10)
    torch.testing.assert_close(w[1], w4, rtol=0, atol=0)
    torch.testing.assert_close(h[1], h4, rtol=0, atol=0)
    torch.testing.assert_close(w[0], w10[0], rtol=0, atol=0)
