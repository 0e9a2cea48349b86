"""The port's distributed fits and sharded planes at bf16, at gloo world
sizes 1, 2 and 4 (ROADMAP Queue 1 item 4).

Five child launches start together: ``tests/_torch_dist_child.py`` at
worlds 2 and 4 and ``tests/_torch_sharded_child.py`` at worlds 1, 2 and 4,
each with DTYPE ``bfloat16``; the reference runs in this process while
their ranks work. V is the reference's ``nmf_data`` at bf16 (N 48, M 40,
k_true 4; ``tests/test_torch_sharded.py``'s sizes: 3 perturbations, 40
sweeps) and the draws are the reference's at bf16, handed over widened to
float32 (exact) and cast back by the children.

* ``distributed_nmf`` (sync, pipelined) and ``distributed_rescal`` at data
  2 and 4 against the reference's per-shard bodies at bf16, vmapped over a
  ``"s"`` axis (``tests/test_torch_distributed.py``'s way); the
  data-sharded ensemble (``_dist_fits``: ``_dnmf_masked_local`` over every
  perturbation at once) and ``_nmfk_score_masked_dist`` against the
  reference's ``_nmfk_score_masked_dist``, run as its two parts: its fits
  vmapped over ``"data"``, then its replicated tail (``_pooled_w_score``)
  once on the gathered W, on the kernel route (``use_kernel=True``, the
  Pallas silhouette kernel in interpret mode). Each field is held within
  twice the reference's own bf16-vs-float32 gap (the same body on V
  widened, with its own float32 draws), at least two bf16 ulps of its
  largest element (the silhouettes at least ``GAP_FLOOR``).
* The sums over ranks travel at float32: every all-reduce and
  reduce-scatter of a bf16 fit carries float32 (the children log them).
* The data-sharded planes (batched sync and pipelined, elastic at tol 0)
  against the unsharded bf16 port: the same ``k_optimal``, the elastic
  plane's sweep counts and warm-start hits, and scores within twice the
  unsharded port's own bf16-vs-float32 gap at each k (the same values and
  draws widened), at least ``GAP_FLOOR``.
* Two faults: ``nmfk_score_sharded`` returned ``rel_error`` at float32
  (lane-only scores must be the batched plane's bits and dtypes), and the
  bf16 elastic plane raised on one chunk of 257 sweeps (its report sent the
  sweep counts at bf16); here it drains, with the bits of one chunk of 300.
"""
import concurrent.futures
import contextlib
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_reference import dnmf_draws, drescal_draws, ensemble_draws, init_draws  # noqa: E402
from repro.factorization import distributed as jdist  # noqa: E402
from repro.factorization import nmfk as jnmfk  # noqa: E402
from repro.factorization.synthetic import nmf_data as jnmf_data  # noqa: E402
from repro.factorization.synthetic import rescal_data as jrescal_data  # noqa: E402
from repro_torch.factorization import distributed as tdist  # noqa: E402
from repro_torch.factorization import nmfk as tnmfk  # noqa: E402
from repro_torch.factorization import planes as tplanes  # noqa: E402
from repro_torch.factorization.synthetic import nmf_data  # noqa: E402
from repro_torch.launch import ksearch  # noqa: E402
from repro_torch.random import init_draws as t_init_draws  # noqa: E402
from repro_torch.random import seeded_draws, seeded_generator  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
KEY = jax.random.PRNGKey(3)
BF16, F32 = jnp.bfloat16, jnp.float32
N, M, P, ITERS, EPS, K_TRUE = 48, 40, 3, 40, 0.015, 4
KS, K_PAD = list(range(2, 10)), 9
NR, K_R = 3, 3  # RESCAL: X 3 x 48 x 48 at k 3
DATAS = (2, 4)
SHARDED_CFG = dict(k_pad=K_PAD, iters=ITERS, k_true=K_TRUE, k_min=2, k_max=9, el_k_max=8, el_chunk=10,
                   threshold=0.9, long_n=24, long_m=20, long_k_pad=4, long_iters=257, long_p=2)
DIST_CFG = dict(k=K_TRUE, iters=ITERS, k_r=K_R, iters_r=ITERS, k_eff=3, k_pad=5, iters_m=ITERS, chunk=10, steps=7)
GAP_RATIO, GAP_FLOOR = 2.0, 2e-2  # tests/test_torch_nmfk_bf16.py's rule
PIPELINED_ATOL = 5e-2  # the reference's conformance tolerance (tests/_conformance_child.py)
ULPS2 = 2.0**-6  # two bf16 ulps anywhere in a binade
SHARDED_WORLDS = (1, 2, 4)
REFERENCE_THREADS = 4


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


@functools.lru_cache(maxsize=None)
def _v16():
    return jnmf_data(KEY, n=N, m=M, k_true=K_TRUE, dtype=BF16)[0]


@functools.lru_cache(maxsize=None)
def _x16():
    return jrescal_data(KEY, n_entities=N, n_relations=NR, k_true=K_R, dtype=BF16)[0]


def _dist_inputs(world: int) -> dict:
    active = (np.arange(DIST_CFG["k_pad"]) < DIST_CFG["k_eff"]).astype(np.float32)
    w0, h0 = init_draws(jax.random.fold_in(KEY, 9), N, M, DIST_CFG["k_pad"], BF16)
    mw, mh = init_draws(jax.random.fold_in(KEY, 7), N, M, DIST_CFG["k_pad"], BF16)
    dnmf_w, dnmf_h = dnmf_draws(jax.random.fold_in(KEY, 5), N, M, K_TRUE, world, BF16)
    drescal_a, drescal_r = drescal_draws(jax.random.fold_in(KEY, 6), N, NR, K_R, world, BF16)
    rng = np.random.default_rng(world)
    return dict(
        ring_x=rng.standard_normal((world, 7, 5)).astype(np.float32),
        ring_xi=rng.integers(-9, 9, (world, 7, 5)).astype(np.int32),
        v=_f32(_v16()), x=_f32(_x16()), dnmf_w=_f32(dnmf_w), dnmf_h=_f32(dnmf_h), drescal_a=_f32(drescal_a),
        drescal_r=_f32(drescal_r), mw=_f32(mw), mh=_f32(mh), w0=_f32(w0) * active[None, :],
        h0=_f32(h0) * active[:, None], **{key: np.asarray(val) for key, val in DIST_CFG.items()},
    )


def _sharded_inputs() -> dict:
    draws = [ensemble_draws(jax.random.fold_in(KEY, k), N, M, K_PAD, P, EPS, BF16) for k in KS]
    v_long = nmf_data(SHARDED_CFG["long_n"], SHARDED_CFG["long_m"], 3, seed=0, device="cpu", dtype=torch.bfloat16)[0]
    return dict(v=_f32(_v16()), v_long=v_long.float().numpy(), ref_ks=np.asarray(KS),
                ref_noise=np.stack([_f32(d[0]) for d in draws]), ref_w=np.stack([_f32(d[1]) for d in draws]),
                ref_h=np.stack([_f32(d[2]) for d in draws]),
                **{key: np.asarray(val) for key, val in SHARDED_CFG.items()})


@contextlib.contextmanager
def _bf16_draws_at_float32():
    """``jax.random.uniform`` at float32 draws at bf16 and widens (exact):
    the reference's float32 twin of a bf16 run consumes the bf16 run's
    draws, so the gap between them is the dtype's alone. The jit caches are
    cleared on both sides of the patch."""
    uniform = jax.random.uniform

    def widened(key, shape=(), dtype=F32, minval=0.0, maxval=1.0):
        if dtype == F32:
            return uniform(key, shape, BF16, minval, maxval).astype(F32)
        return uniform(key, shape, dtype, minval, maxval)

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", widened)
        yield
    jax.clear_caches()


def _reference() -> dict:
    """The reference's bodies at bf16 and at float32 (V and X widened, the
    same draws widened: ``_bf16_draws_at_float32``) over 2 and 4 row
    blocks: ``_dnmf_local`` on both schedules, ``_drescal_local``, and
    ``_nmfk_score_masked_dist`` at k_true as its fits and its replicated
    tail."""
    with _bf16_draws_at_float32():
        return _reference_runs()


def _reference_runs() -> dict:
    """The bodies' runs, independent of each other, on ``REFERENCE_THREADS``
    threads (XLA compiles them concurrently)."""
    key = jax.random.fold_in(KEY, K_TRUE)
    kp, kf = jax.random.split(key)
    pkeys, fkeys = jax.random.split(kp, P), jax.random.split(kf, P)
    k_eff = jnp.asarray(K_TRUE)
    tails = {dt: jax.jit(functools.partial(jnmfk._pooled_w_score, k_pad=K_PAD, n_perturbs=P,
                                           use_kernel=dt == "16")) for dt in ("16", "32")}
    values = {dt: (_v16().astype(jdt), _x16().astype(jdt)) for dt, jdt in (("16", BF16), ("32", F32))}

    def fits(v_l, comm):  # the fits of _nmfk_score_masked_dist, as its body runs them
        idx = jax.lax.axis_index("data")

        def fit_one(pk, fk):
            noise = jax.random.uniform(pk, (N, M), v_l.dtype, 1.0 - EPS, 1.0 + EPS)
            vp_l = v_l * jax.lax.dynamic_slice_in_dim(noise, idx * v_l.shape[0], v_l.shape[0], axis=0)
            return jdist._dnmf_masked_local(vp_l, k_eff, fk, K_PAD, ITERS, "data", N, comm=comm)

        return jax.vmap(fit_one)(pkeys, fkeys)

    def nmf(dt, data, comm):
        v_sh = values[dt][0].reshape(data, N // data, M)
        w, h, err = jax.vmap(lambda vl: jdist._dnmf_local(
            vl, jax.random.fold_in(KEY, 5), K_TRUE, ITERS, "s", comm, axis_size=data), axis_name="s")(v_sh)
        out = {("nmf", data, comm, dt): [w.reshape(N, -1), h[0], err[0]]}
        w, errs = jax.vmap(lambda vl: fits(vl, comm), axis_name="data")(v_sh)
        w_all = w.transpose(1, 0, 2, 3).reshape(P, N, K_PAD)  # the body's all-gather
        out[("fits", data, comm, dt)] = [w_all, errs[0]]
        out[("score", data, comm, dt)] = list(tails[dt](w_all, errs[0], k_eff))
        return out

    def rescal(dt, data):
        x_sh = values[dt][1].reshape(NR, data, N // data, N).transpose(1, 0, 2, 3)
        a, r, err = jax.vmap(lambda xl: jdist._drescal_local(
            xl, jax.random.fold_in(KEY, 6), K_R, ITERS, "s"), axis_name="s")(x_sh)
        return {("rescal", data, dt): [a.reshape(N, -1), r[0], err[0]]}

    tasks = [functools.partial(nmf, dt, data, comm) for dt in values for data in DATAS for comm in jdist.COMM_MODES]
    tasks += [functools.partial(rescal, dt, data) for dt in values for data in DATAS]
    out = {}
    with concurrent.futures.ThreadPoolExecutor(REFERENCE_THREADS) as pool:
        for part in pool.map(lambda task: task(), tasks):
            out.update(part)
    return {key: [_f32(f) for f in fields] for key, fields in out.items()}


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (SRC, os.environ.get("PYTHONPATH")) if p))


def _launch_all(tmp: Path) -> tuple[dict, dict]:
    """Every child launch, started together; the reference computed while
    their ranks run. Returns {("dist" | "sharded", world): [(npz, json) per
    rank]} and the reference."""
    launches = {("dist", w): ("_torch_dist_child.py", _dist_inputs(w)) for w in DATAS}
    launches.update({("sharded", w): ("_torch_sharded_child.py", None) for w in SHARDED_WORLDS})
    np.savez(tmp / "sharded.npz", **_sharded_inputs())
    procs = {}
    for (kind, world), (script, inputs) in launches.items():
        outdir = tmp / f"{kind}{world}"
        outdir.mkdir()
        path = tmp / "sharded.npz"
        if inputs is not None:
            path = tmp / f"{kind}{world}.npz"
            np.savez(path, **inputs)
        procs[(kind, world)] = (outdir, subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / script), str(world), str(path), str(outdir), "bfloat16"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env()))
    try:
        reference = _reference()
    finally:
        results = {key: (outdir, proc, proc.communicate(timeout=300)) for key, (outdir, proc) in procs.items()}
    ranks = {}
    for (kind, world), (outdir, proc, (stdout, stderr)) in results.items():
        assert proc.returncode == 0, f"{kind} child at world {world} failed:\n{stdout}\n{stderr}"
        ranks[(kind, world)] = [(dict(np.load(outdir / f"rank{r}.npz")),
                                 json.loads((outdir / f"rank{r}.json").read_text())) for r in range(world)]
    return ranks, reference


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _launch_all(tmp_path_factory.mktemp("sharded_bf16"))


def _gap(got, want, want32, floor: float | None = None) -> tuple[float, float, float]:
    """(max abs diff of ``got`` from ``want``, its bound, the bf16-vs-float32
    gap of ``want`` against ``want32``)."""
    got, want, want32 = (np.asarray(a, np.float64) for a in (got, want, want32))
    gap = float(np.abs(want - want32).max())
    bound = max(GAP_RATIO * gap, floor if floor is not None else ULPS2 * float(np.abs(want).max()))
    return float(np.abs(got - want).max()), bound, gap


def _hold(got, want, want32, what: str, floor: float | None = None) -> None:
    """``got`` within twice the bf16-vs-float32 gap of ``want`` (max abs
    over elements), at least two bf16 ulps of its largest element or
    ``floor``."""
    diff, bound, gap = _gap(got, want, want32, floor)
    assert diff <= bound, (what, diff, bound, gap)


# ---------------------------------------------------------------------------
# the distributed fits against the reference's bodies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("data", DATAS)
@pytest.mark.parametrize("comm", ["sync", "pipelined"])
def test_distributed_nmf_bf16_matches_the_reference(runs, data, comm):
    ranks, reference = runs
    per_rank = ranks[("dist", data)]
    want, want32 = reference[("nmf", data, comm, "16")], reference[("nmf", data, comm, "32")]
    w = np.concatenate([arrays[f"nmf_{comm}_w"] for arrays, _ in per_rank])
    _hold(w, want[0], want32[0], f"W data {data} {comm}")
    for arrays, info in per_rank:  # H and the error are replicated
        _hold(arrays[f"nmf_{comm}_h"], want[1], want32[1], f"H data {data} {comm}")
        _hold(arrays[f"nmf_{comm}_err"], want[2], want32[2], f"err data {data} {comm}")
        assert {info["dtypes"][f"nmf_{comm}_{f}"] for f in ("w", "h", "err")} == {"torch.bfloat16"}


@pytest.mark.parametrize("data", DATAS)
def test_distributed_rescal_bf16_matches_the_reference(runs, data):
    ranks, reference = runs
    per_rank = ranks[("dist", data)]
    want, want32 = reference[("rescal", data, "16")], reference[("rescal", data, "32")]
    _hold(np.concatenate([arrays["rescal_a"] for arrays, _ in per_rank]), want[0], want32[0], f"A data {data}")
    for arrays, info in per_rank:
        _hold(arrays["rescal_r"], want[1], want32[1], f"R data {data}")
        _hold(arrays["rescal_err"], want[2], want32[2], f"err data {data}")
        assert {info["dtypes"][f"rescal_{f}"] for f in ("a", "r", "err")} == {"torch.bfloat16"}


@pytest.mark.parametrize("data", DATAS)
@pytest.mark.parametrize("comm", ["sync", "pipelined"])
def test_masked_fits_and_score_bf16_match_the_reference(runs, data, comm):
    """``_dist_fits`` (``_dnmf_masked_local`` over the ensemble) and
    ``_nmfk_score_masked_dist`` at k_true: W, the errors and the score."""
    ranks, reference = runs
    fits, fits32 = reference[("fits", data, comm, "16")], reference[("fits", data, comm, "32")]
    score, score32 = reference[("score", data, comm, "16")], reference[("score", data, comm, "32")]
    for arrays, info in ranks[("sharded", data)]:
        if f"dist{data}_{comm}_w" not in arrays:  # ranks of the (2, 2) mesh hold no data-4 body
            continue
        _hold(arrays[f"dist{data}_{comm}_w"], fits[0], fits32[0], f"W data {data} {comm}")
        _hold(arrays[f"dist{data}_{comm}_errs"], fits[1], fits32[1], f"errs data {data} {comm}")
        for i, floor in enumerate((GAP_FLOOR, GAP_FLOOR, None)):
            _hold(arrays[f"dist{data}_{comm}_{i}"], score[i], score32[i], f"score field {i}", floor)
        assert [info["dtypes"][f"dist{data}_{comm}_{i}"] for i in range(3)] == [
            "torch.float32", "torch.float32", "torch.bfloat16"]
        assert info["dtypes"][f"dist{data}_{comm}_w"] == "torch.bfloat16"


def test_masked_bodies_bf16_keep_masked_components_zero(runs):
    ranks, _ = runs
    for data in DATAS:
        for arrays, info in ranks[("dist", data)]:
            for key in ("masked_sync_w", "masked_pipelined_w", "chunk_sync_w", "chunk_pipelined_w"):
                assert not arrays[key][:, DIST_CFG["k_eff"]:].any() and info["dtypes"][key] == "torch.bfloat16"


@pytest.mark.parametrize("data", DATAS)
def test_sums_over_ranks_travel_at_float32(runs, data):
    """Every all-reduce and reduce-scatter of the bf16 fits (the Grams, both
    schedules, the residual pair, V's mean, RESCAL's) carries float32."""
    ranks, _ = runs
    for _, info in ranks[("dist", data)]:
        wire = {tuple(entry) for entry in info["wire"]}
        assert wire == {("all_reduce", "torch.float32"), ("reduce_scatter", "torch.float32")}, wire


# ---------------------------------------------------------------------------
# the sharded planes against the unsharded bf16 port
# ---------------------------------------------------------------------------
def _scores(arrays, prefix):
    return [arrays[f"{prefix}_{i}"] for i in range(3)]  # min, mean silhouette, rel_error


@pytest.mark.parametrize("world", SHARDED_WORLDS)
def test_lane_only_bf16_scores_are_the_batched_bits_and_dtypes(runs, world):
    """The fault: the lane gather stacked the three fields into one tensor
    and returned ``rel_error`` at float32."""
    ranks, _ = runs
    for arrays, info in ranks[("sharded", world)]:
        for i, (got, want) in enumerate(zip(_scores(arrays, f"sharded_{world}x1_sync"), _scores(arrays, "batched16"))):
            np.testing.assert_array_equal(got, want)
            assert info["dtypes"][f"sharded_{world}x1_sync_{i}"] == info["dtypes"][f"batched16_{i}"]
        assert [info["dtypes"][f"batched16_{i}"] for i in range(3)] == ["torch.float32", "torch.float32",
                                                                         "torch.bfloat16"]


@pytest.mark.parametrize("world,tag", [(2, "1x2"), (4, "2x2"), (4, "1x4")])
@pytest.mark.parametrize("comm", ["sync", "pipelined"])
def test_data_sharded_bf16_batched_plane_against_the_unsharded_port(runs, world, tag, comm):
    """Sync: every k's scores within the gap rule. Pipelined: its
    one-sweep-stale H moves an underfit k's score by more than any dtype
    gap (0.28 at k 3 here, and so at float32), so it is held as
    ``tests/test_torch_sharded.py`` holds it at float32: the same
    ``k_optimal``, the selected rank's score within ``PIPELINED_ATOL``."""
    ranks, _ = runs
    first = ranks[("sharded", world)][0]
    for arrays, info in ranks[("sharded", world)]:
        k_opt, _, scores = info[f"search_{tag}_{comm}"]
        want_k, _, want_scores = info["batched_search"]
        assert k_opt == want_k == K_TRUE
        b16, b32 = _scores(arrays, "batched16"), _scores(arrays, "batched32")
        if comm == "sync":
            for i in range(2):
                _hold(arrays[f"sharded_{tag}_{comm}_{i}"], b16[i], b32[i], f"field {i}", GAP_FLOOR)
            for k, score in scores.items():
                _hold(score, want_scores[k], b32[0][KS.index(int(k))], f"k {k}", GAP_FLOOR)
        else:
            assert abs(scores[str(k_opt)] - want_scores[str(k_opt)]) < PIPELINED_ATOL
        assert [info["dtypes"][f"sharded_{tag}_{comm}_{i}"] for i in range(3)] == [
            "torch.float32", "torch.float32", "torch.bfloat16"]
        # every rank took the same decisions from the same floats
        assert info[f"search_{tag}_{comm}"] == first[1][f"search_{tag}_{comm}"]
        for got, want in zip(_scores(arrays, f"sharded_{tag}_{comm}"), _scores(first[0], f"sharded_{tag}_{comm}")):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world,tag", [(2, "1x2"), (4, "2x2")])
def test_data_sharded_bf16_elastic_plane_against_the_unsharded_port(runs, world, tag):
    ranks, _ = runs
    for _, info in ranks[("sharded", world)]:
        want, want32, got = info["elastic16"], info["elastic32"], info[f"elastic_{tag}_sync"]
        assert got["sweeps"] == want["sweeps"] and got["warm_start_hits"] == want["warm_start_hits"] > 0
        assert sorted(got["scores"]) == sorted(want["scores"]) == [str(k) for k in range(2, 9)]
        for k in want["scores"]:
            _hold(got["scores"][k], want["scores"][k], want32["scores"][k], f"k {k}", GAP_FLOOR)
        assert got == ranks[("sharded", world)][0][1][f"elastic_{tag}_sync"]


# ---------------------------------------------------------------------------
# the bf16 elastic plane at 257 sweeps a chunk
# ---------------------------------------------------------------------------
def _long_plane(v, chunk: int):
    errs = []
    pooled = tplanes.elastic_pooled_score

    def keep(w_all, e, k_eff, k_pad):
        errs.append(e)
        return pooled(w_all, e, k_eff, k_pad)

    c = SHARDED_CFG
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tplanes, "elastic_pooled_score", keep)
        plane = tplanes.NMFkElasticPlane(v, n_perturbs=c["long_p"], nmf_iters=c["long_iters"], k_pad=c["long_k_pad"],
                                         tol=0.0, chunk=chunk)
        for k in range(2, c["long_k_pad"] + 1):
            plane.submit(k)
        scores = {}
        while not plane.idle:
            scores.update(plane.tick())
    return scores, torch.stack(errs), (plane.sweeps_run, plane.sweeps_saved, plane.sweeps_fixed_total)


def test_bf16_elastic_plane_drains_one_chunk_of_257_sweeps():
    """Without a mesh: the report carried the sweep counts at bf16, where
    257 rounds to 256, and the plan check raised. One chunk of 257 and one
    of 300 apply the same 257 sweeps: the same bits."""
    c = SHARDED_CFG
    v = nmf_data(c["long_n"], c["long_m"], 3, seed=0, device="cpu", dtype=torch.bfloat16)[0]
    got, want = _long_plane(v, 257), _long_plane(v, 300)
    assert got[0] == want[0] and sorted(got[0]) == [2, 3, 4]
    assert torch.equal(got[1], want[1]) and got[1].dtype == torch.bfloat16
    assert got[2] == want[2] == (3 * c["long_p"] * c["long_iters"], 0, 3 * c["long_p"] * c["long_iters"])


def test_bf16_elastic_plane_drains_one_chunk_of_257_sweeps_on_a_mesh(runs):
    ranks, _ = runs
    for arrays, info in ranks[("sharded", 2)]:
        got, want = info["long_1x2_257"], info["long_1x2_300"]
        assert got["scores"] == want["scores"] and sorted(got["scores"]) == ["2", "3", "4"]
        assert got["sweeps"] == want["sweeps"] and got["err_dtypes"] == want["err_dtypes"] == ["torch.bfloat16"]
        np.testing.assert_array_equal(arrays["long_1x2_257_errs"], arrays["long_1x2_300_errs"])


# ---------------------------------------------------------------------------
# dtypes: the draws at V's, float16 queued, the distributed-fit launcher
# ---------------------------------------------------------------------------
def _bf16_v(n: int = 8, m: int = 6) -> torch.Tensor:
    return torch.rand((n, m), generator=seeded_generator(0, "cpu")).bfloat16()


@pytest.mark.parametrize("body", ["masked", "chunk", "elastic_chunk_sharded", "nmfk_score_sharded"])
def test_the_bodies_take_bf16_and_refuse_draws_of_another_dtype(body):
    v = _bf16_v()
    w, h = t_init_draws(seeded_generator(1, "cpu"), 8, 6, 4, dtype=torch.bfloat16)
    k_eff, steps = torch.tensor(3), torch.tensor(4)
    if body == "masked":
        w_l, err = tdist._dnmf_masked_local(v, 3, w, h, 4, 5, None)
        assert w_l.dtype == err.dtype == torch.bfloat16
        call = functools.partial(tdist._dnmf_masked_local, v, 3, w.float(), h.float(), 4, 5, None)
    elif body == "chunk":
        assert {t.dtype for t in tdist._dnmf_masked_chunk_local(v, w, h, k_eff, 4, 5, None, steps=steps)} == {
            torch.bfloat16}
        call = functools.partial(tdist._dnmf_masked_chunk_local, v, w, h.float(), k_eff, 4, 5, None)
    elif body == "elastic_chunk_sharded":
        assert tnmfk.elastic_chunk_sharded(v[None], w[None], h[None], k_eff[None], steps[None], 4, 5)[0].dtype == (
            torch.bfloat16)
        call = functools.partial(tnmfk.elastic_chunk_sharded, v[None], w[None].float(), h[None], k_eff[None],
                                 steps[None], 4, 5)
    else:
        fp32 = seeded_draws(0, 8, 6, 2, EPS, "cpu")
        call = functools.partial(tnmfk.nmfk_score_sharded, v, [2, 3], k_pad=3, n_perturbs=2, nmf_iters=3, draws=fp32)
    with pytest.raises(TypeError, match="dtype"):
        call()


def test_float16_is_queued():
    v = _bf16_v().half()
    w, h = t_init_draws(seeded_generator(1, "cpu"), 8, 6, 3, dtype=torch.float16)
    with pytest.raises(TypeError, match="Queue 2 item 4"):
        tdist._dnmf_masked_local(v, 3, w, h, 3, 2, None)


def test_distributed_fit_launcher_draws_at_the_data_dtype(monkeypatch):
    """``ksearch._with_distributed_fit`` on a bf16 V: the distributed fit
    gets bf16 draws and runs at bf16 (it drew float32 and raised)."""
    v = nmf_data(24, 20, 3, seed=0, device="cpu", dtype=torch.bfloat16)[0]
    seen = []
    fit = ksearch.distributed_nmf

    def spy(v_l, k, w_draw, h_draw, group=None, iters=200, comm="sync"):
        res = fit(v_l, k, w_draw, h_draw, group, iters=iters, comm=comm)
        seen.append({t.dtype for t in (v_l, w_draw, h_draw, *res)})
        return res

    monkeypatch.setattr(ksearch, "distributed_nmf", spy)
    with tdist.local_groups("cpu", 1) as groups:
        evaluate = ksearch._with_distributed_fit(lambda k, should_abort=None: float(k), v, 0, 4,
                                                 ksearch.SubmeshPool(groups))
        assert evaluate(3) == 3.0
    assert seen == [{torch.bfloat16}]


def _report() -> None:
    """Print the distributed fits' distances from the reference's bf16 bodies
    beside the reference's own bf16-vs-float32 gap: one JSON line a field
    (``python tests/test_torch_sharded_bf16.py``)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ranks, reference = _launch_all(Path(tmp))
    for data in DATAS:
        per_rank = ranks[("dist", data)]
        for body, names in (("nmf_sync", "whe"), ("nmf_pipelined", "whe"), ("rescal", "are")):
            key = ("rescal", data) if body == "rescal" else ("nmf", data, body[4:])
            want, want32 = reference[(*key, "16")], reference[(*key, "32")]
            for i, name in enumerate(names):
                field = {"w": "w", "a": "a", "h": "h", "r": "r", "e": "err"}[name]
                got = (np.concatenate([a[f"{body}_{field}"] for a, _ in per_rank]) if name in "wa"
                       else per_rank[0][0][f"{body}_{field}"])
                print(json.dumps({"data": data, "body": body, "field": field,
                                  **dict(zip(("diff", "bound", "gap"), _gap(got, want[i], want32[i])))}))
        for comm in jdist.COMM_MODES:
            fits, fits32 = reference[("fits", data, comm, "16")], reference[("fits", data, comm, "32")]
            arrays = next(a for a, _ in ranks[("sharded", data)] if f"dist{data}_{comm}_w" in a)
            for i, field in enumerate(("w", "errs")):
                print(json.dumps({"data": data, "body": f"masked_{comm}", "field": field, **dict(zip(
                    ("diff", "bound", "gap"), _gap(arrays[f"dist{data}_{comm}_{field}"], fits[i], fits32[i])))}))


if __name__ == "__main__":
    _report()
