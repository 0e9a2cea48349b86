"""The port's RESCALk at bf16 against the reference's bf16 run.

X 4 x 48 x 48 (the reference's ``rescal_data`` at bf16, k_true 4, noise
0.003: ``benchmarks/bench_distributed.py``'s RESCAL setup at 48 entities),
3 perturbations, 100 sweeps. The reference's fits stay bf16 when X is bf16:
it draws its perturbations and its A/R inits at X's dtype. Its RESCALk
score takes the silhouette without the kernel; here it is patched to
``use_kernel=True`` (the TPU kernel in interpret mode: fp32 sums of bf16
columns), the route the port computes on every device. So:

- a bf16 X is fitted at bf16 with draws at its dtype, and draws of another
  dtype raise, also in the distributed fits (float16 is queued: ROADMAP
  Queue 2 item 4);
- each k's silhouette is held to the reference's within twice the
  reference's own bf16-vs-fp32 gap (floor ``GAP_FLOOR``), its relative
  error likewise or within two bf16 ulps;
- Binary Bleed over ``make_rescalk_evaluator`` chooses the reference's k.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.scoring as jscoring  # noqa: E402
from _torch_reference import reference_rescal_draw_source  # noqa: E402
from repro.core import binary_bleed_search as j_binary_bleed_search  # noqa: E402
from repro.factorization.synthetic import rescal_data as jrescal_data  # noqa: E402
from repro_torch.convert import leaf_tensor  # noqa: E402
from repro_torch.core import binary_bleed_search  # noqa: E402
from repro_torch.factorization import distributed as tdist  # noqa: E402
from repro_torch.random import make_rescal_draws, rescal_init_draws, seeded_generator, seeded_rescal_draws  # noqa: E402

jr = importlib.import_module("repro.factorization.rescal")
tr = importlib.import_module("repro_torch.factorization.rescal")

KEY = jax.random.PRNGKey(0)
N, NR, K_TRUE, P, ITERS, EPS = 48, 4, 4, 3, 100, 0.015
KS, K_RANGE, SELECT, STOP = (3, 4, 5), (2, 7), 0.8, 0.25
BF16 = jnp.bfloat16
ERR_RTOL = 2.0**-6  # two bf16 ulps anywhere in a binade: rel_error is a bf16 norm ratio
GAP_RATIO, GAP_FLOOR = 2.0, 2e-2  # tests/test_torch_nmfk_bf16.py's rule
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    """The reference's bf16 X, its float32 copy, and the port's tensor of it."""
    x16, _, _ = jrescal_data(KEY, n_entities=N, n_relations=NR, k_true=K_TRUE, noise=0.003, dtype=BF16)
    return x16, x16.astype(jnp.float32), leaf_tensor(np.asarray(x16), CPU)


def _source(dtype=BF16):
    return reference_rescal_draw_source(KEY, N, NR, P, EPS, dtype)


@pytest.fixture(scope="module")
def reference(data):
    """The reference's kernel route (its silhouette at ``use_kernel=True``):
    {k: (sil, err)} at bf16 and at float32 for ``KS``, and its bf16 search.
    The jitted ``rescalk_score`` keeps a trace of the unpatched silhouette,
    so the caches are cleared on both sides of the patch."""
    x16, x32, _ = data
    kernel_sil = functools.partial(jscoring.silhouette_score, use_kernel=True)
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr, "silhouette_score", kernel_sil)
        scores = {}
        for k in KS:
            sub = jax.random.fold_in(KEY, k)
            scores[k] = tuple((float(s), float(e)) for s, e in (
                jr.rescalk_score(xx, k, sub, n_perturbs=P, iters=ITERS) for xx in (x16, x32)))
        search = j_binary_bleed_search(jr.make_rescalk_evaluator(x16, KEY, n_perturbs=P, iters=ITERS), K_RANGE,
                                       SELECT, STOP, num_resources=1)
    jax.clear_caches()
    return scores, search


# -----------------------------------------------------------------------------
# the fault: a bf16 X was perturbed by float32 noise and fitted at float32
# -----------------------------------------------------------------------------
def test_bf16_x_is_fitted_at_bf16_with_draws_at_its_dtype(data, monkeypatch):
    """The reference's bf16 X and draws, carried across: every sweep sees a
    bf16 perturbed X, A and R, the error is a bf16 norm ratio and the
    silhouette float32 (fp32 distance sums). The evaluator's own draws are
    at X's dtype too."""
    _, _, x = data
    seen = []
    step = tr.rescal_step

    def spy(xx, a, r):
        seen.append((xx.dtype, a.dtype, r.dtype))
        return step(xx, a, r)

    monkeypatch.setattr(tr, "rescal_step", spy)
    sil, err = tr.rescalk_score(x, K_TRUE, _source()(K_TRUE), iters=ITERS)
    assert len(seen) == ITERS and set(seen) == {(torch.bfloat16,) * 3}
    assert sil.dtype == torch.float32 and err.dtype == torch.bfloat16
    seen.clear()
    tr.make_rescalk_evaluator(x, n_perturbs=P, iters=ITERS)(K_TRUE)
    assert len(seen) == ITERS and set(seen) == {(torch.bfloat16,) * 3}
    assert {t.dtype for t in seeded_rescal_draws(0, N, NR, P, EPS, CPU, torch.bfloat16)(K_TRUE)} == {torch.bfloat16}


@pytest.mark.parametrize("entry", ["rescal", "rescalk_score", "evaluator"])
def test_draws_of_another_dtype_raise(data, entry):
    _, _, x = data
    fp32 = seeded_rescal_draws(0, N, NR, P, EPS, CPU)  # float32 draws against a bf16 X
    with pytest.raises(TypeError, match="dtype"):
        if entry == "rescal":
            d = fp32(K_TRUE)
            tr.rescal(x, K_TRUE, d.a[0], d.r[0], iters=2)
        elif entry == "rescalk_score":
            tr.rescalk_score(x, K_TRUE, fp32(K_TRUE), iters=2)
        else:
            tr.make_rescalk_evaluator(x, iters=2, draws=fp32)(K_TRUE)


@pytest.mark.parametrize("fit", ["distributed_rescal", "distributed_nmf"])
def test_distributed_fits_take_bf16_with_draws_at_its_dtype(fit):
    """The distributed fits run at bf16 on bf16 draws (ROADMAP Queue 1 item
    4); draws of another dtype raise instead of promoting the fit, and
    float16 raises, naming its queue item."""
    gen = seeded_generator(0, CPU)
    if fit == "distributed_rescal":
        x = torch.rand((2, 8, 8), generator=gen).bfloat16()
        a, r = rescal_init_draws(gen, 8, 2, 3, dtype=torch.bfloat16)

        def call(x, a, r):
            return tdist.distributed_rescal(x, 3, a, r, iters=2)
        operands = (x, a, r)
    else:
        v = torch.rand((8, 6), generator=gen).bfloat16()
        w, h = torch.rand((8, 3), generator=gen).bfloat16(), torch.rand((3, 6), generator=gen).bfloat16()

        def call(v, w, h):
            return tdist.distributed_nmf(v, 3, w, h, iters=2)
        operands = (v, w, h)
    assert {t.dtype for t in call(*operands)} == {torch.bfloat16}
    with pytest.raises(TypeError, match="dtype"):
        call(operands[0], *(t.float() for t in operands[1:]))
    with pytest.raises(TypeError, match="Queue 2 item 4"):
        call(*(t.half() for t in operands))


def test_float32_keeps_its_bits():
    """The fp32 draws and the fp32 relative error are their expressions
    before bf16, bit for bit."""
    got = make_rescal_draws(seeded_generator(3, CPU), 10, 2, 3, 2, EPS)
    g = seeded_generator(3, CPU)
    noise = torch.empty((2, 2, 10, 10)).uniform_(1.0 - EPS, 1.0 + EPS, generator=g)
    a = torch.empty((2, 10, 3)).uniform_(0.1, 1.0, generator=g)
    r = torch.empty((2, 2, 3, 3)).uniform_(0.1, 1.0, generator=g)
    assert all(torch.equal(u, w) and u.dtype == torch.float32 for u, w in zip(got, (noise, a, r)))
    x = torch.rand((2, 3, 10, 10), generator=g)
    at = a.transpose(-1, -2)
    sq = torch.zeros(2)
    for i in range(3):
        sq = sq + (x[:, i] - a @ r[:, i % 2] @ at).square().sum(dim=(-2, -1))
    want = torch.sqrt(sq) / torch.clamp(torch.sqrt(x.square().sum(dim=(-3, -2, -1))), min=1e-9)
    assert torch.equal(tr.reconstruction_error(x, a, r[:, [0, 1, 0]]), want)


# -----------------------------------------------------------------------------
# RESCALk scores and the search against the reference's kernel route
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("k", KS)  # below, at and above k_true
def test_rescalk_score_bf16_matches_the_reference_kernel_route(data, reference, k):
    _, _, x = data
    (sil16, err16), (sil32, err32) = reference[0][k]
    sil, err = tr.rescalk_score(x, k, _source()(k), iters=ITERS)
    assert sil.dtype == torch.float32 and err.dtype == torch.bfloat16
    assert abs(float(sil) - sil16) <= max(GAP_RATIO * abs(sil16 - sil32), GAP_FLOOR), (float(sil), sil16, sil32)
    assert abs(float(err) - err16) <= max(GAP_RATIO * abs(err16 - err32), ERR_RTOL * abs(err16)), (
        float(err), err16, err32)


def test_rescalk_bf16_search_k_optimal_is_the_reference(data, reference):
    """Binary Bleed over ``make_rescalk_evaluator`` on the bf16 X with the
    reference's draws (serial: the visits are deterministic)."""
    _, _, x = data
    want = reference[1]
    evaluate = tr.make_rescalk_evaluator(x, n_perturbs=P, iters=ITERS, epsilon=EPS, draws=_source())
    got = binary_bleed_search(evaluate, K_RANGE, SELECT, STOP, num_resources=1)
    assert got.k_optimal == want.k_optimal == K_TRUE
    assert got.visited_ks == want.visited_ks
