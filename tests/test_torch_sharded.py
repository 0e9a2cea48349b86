"""The port's sharded wavefront planes (``mesh=``) at gloo world sizes 1, 2 and 4.

Each world size is one launch of ``tests/_torch_sharded_child.py``; all
three start together, and the reference runs in this process while their
ranks work. Every rank runs the same search steps (SPMD) on ``(lane,
data)`` meshes of its world and on the unsharded port, with the
reference's draws handed over through ``repro_torch.convert``. What is
held, and how tightly:

* lane-only (``data == 1``) sharding is the batched plane's arithmetic
  lane for lane: scores, planes, K-Means labels and the elastic plane's
  scores, sweep counts and warm-start hits are the unsharded port's bits;
  the sharded scores are also held to the reference's ``nmfk_score_batched``
  at ``test_torch_nmfk.py``'s tolerances (silhouettes atol 2e-4,
  ``rel_error`` rtol 1e-5);
* the data-sharded body ``_nmfk_score_masked_dist`` at data 2 and 4 is held
  to the reference's, vmapped over a ``"data"`` axis in this process
  (``tests/test_torch_distributed.py``'s way), each schedule to the
  reference's same schedule: W and ``rel_error`` at that file's
  ``FIT_TOL`` / ``ERR_RTOL``, the silhouettes at ``DIST_SIL_ATOL``;
* data-sharded planes against the batched plane at the reference's
  conformance tolerances (``tests/_conformance_child.py``): sync 2e-3,
  pipelined the same ``k_optimal`` and the selected rank's score within 5e-2.

The reference's own sharded path (``shard_map``) fails under jax 0.9.0, so
it is not the yardstick here. In this process: ``make_wave_mesh``'s errors
at one rank, the k-search CLI (one rank, twice, then ``--distributed-fit``),
its parser, and the distributed example.
"""
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

from _torch_reference import ensemble_draws  # noqa: E402
from repro.factorization import distributed as jdist  # noqa: E402
from repro.factorization import nmfk as jnmfk  # noqa: E402
from repro.factorization.synthetic import nmf_data as jnmf_data  # noqa: E402
from repro_torch.launch import ksearch  # noqa: E402
from repro_torch.launch.mesh import make_wave_mesh  # noqa: E402
from test_torch_distributed import ERR_RTOL, FIT_TOL  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
KEY = jax.random.PRNGKey(3)
N, M, P, ITERS, EPS, K_TRUE = 48, 40, 3, 40, 0.015, 4
KS, K_PAD = list(range(2, 10)), 9  # 8 lanes: 1, 2 or 4 blocks
CFG = dict(k_pad=K_PAD, iters=ITERS, k_true=K_TRUE, k_min=2, k_max=9, el_k_max=8, el_chunk=10, threshold=0.9)
WORLDS = (1, 2, 4)
DATA_MESHES = {2: ["1x2"], 4: ["2x2", "1x4"]}
# the port's batched path against the reference's (tests/test_torch_nmfk.py)
SIL_ATOL, BATCHED_ERR_RTOL = 2e-4, 1e-5
# the reference's conformance tolerances (tests/_conformance_child.py:44-45)
SHARD_SYNC_ATOL, PIPELINED_ATOL = 2e-3, 5e-2
# _nmfk_score_masked_dist against the reference's at data 2 and 4: the W
# factors agree to FIT_TOL, but the pooled silhouettes of 40-sweep fits move
# by up to ~1e-4 with the order of the Gram sums (the reference's own data-2
# and data-4 scores differ from its batched score by 1.5e-4), so the scores
# are held at the sharded-sync tolerance, not at 1e-5.
DIST_SIL_ATOL = SHARD_SYNC_ATOL


def _v() -> np.ndarray:
    v, _, _ = jnmf_data(KEY, n=N, m=M, k_true=K_TRUE)
    return np.array(v)


def _inputs() -> dict:
    draws = [ensemble_draws(jax.random.fold_in(KEY, k), N, M, K_PAD, P, EPS) for k in KS]
    return dict(v=_v(), ref_ks=np.asarray(KS), ref_noise=np.stack([d[0] for d in draws]),
                ref_w=np.stack([d[1] for d in draws]), ref_h=np.stack([d[2] for d in draws]),
                **{key: np.asarray(val) for key, val in CFG.items()})


def _reference() -> dict:
    """The reference's batched scores, and its data-sharded body vmapped over
    2 and 4 row blocks at k_true: its fits' W and errors, and its score, on
    both schedules."""
    v = jnp.asarray(_v())
    out = {"batched": jnmfk.nmfk_score_batched(v, KS, KEY, k_pad=K_PAD, n_perturbs=P, nmf_iters=ITERS,
                                                 epsilon=EPS)}
    key = jax.random.fold_in(KEY, K_TRUE)
    kp, kf = jax.random.split(key)
    pkeys, fkeys = jax.random.split(kp, P), jax.random.split(kf, P)
    k_eff = jnp.asarray(K_TRUE)
    def fits(v_l, comm):  # the fits of _nmfk_score_masked_dist, W and errors kept
        idx = jax.lax.axis_index("data")

        def fit_one(pk, fk):
            noise = jax.random.uniform(pk, (N, M), v_l.dtype, 1.0 - EPS, 1.0 + EPS)
            vp_l = v_l * jax.lax.dynamic_slice_in_dim(noise, idx * v_l.shape[0], v_l.shape[0], axis=0)
            return jdist._dnmf_masked_local(vp_l, k_eff, fk, K_PAD, ITERS, "data", N, comm=comm)

        return jax.vmap(fit_one)(pkeys, fkeys)

    for data in (2, 4):
        v_sh = v.reshape(data, N // data, M)
        for comm in jdist.COMM_MODES:
            # (data, p, n_l, k_pad), (data, p)
            w, errs = jax.vmap(lambda v_l, comm=comm: fits(v_l, comm), axis_name="data")(v_sh)
            out[(data, comm, "fits")] = (np.asarray(w.transpose(1, 0, 2, 3).reshape(P, N, K_PAD)),
                                         np.asarray(errs[0]))
            score = jax.vmap(lambda v_l, comm=comm: jnmfk._nmfk_score_masked_dist(
                v_l, k_eff, key, K_PAD, "data", N, n_perturbs=P, nmf_iters=ITERS, epsilon=EPS, comm=comm),
                axis_name="data")(v_sh)
            out[(data, comm)] = [np.asarray(field[0]) for field in score]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """All three child launches, started together; the reference computed
    while their ranks run. {world: [(npz, json) per rank]}, reference."""
    tmp = tmp_path_factory.mktemp("sharded")
    np.savez(tmp / "inputs.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    procs = {}
    for world in WORLDS:
        (tmp / f"world{world}").mkdir()
        procs[world] = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_sharded_child.py"), str(world), str(tmp / "inputs.npz"),
             str(tmp / f"world{world}")], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        reference = _reference()
    finally:
        results = {world: proc.communicate(timeout=300) for world, proc in procs.items()}
    ranks = {}
    for world, (stdout, stderr) in results.items():
        assert procs[world].returncode == 0, f"world {world} child failed:\n{stdout}\n{stderr}"
        assert f"sharded child OK world={world}" in stdout
        ranks[world] = [(dict(np.load(tmp / f"world{world}" / f"rank{r}.npz")),
                         json.loads((tmp / f"world{world}" / f"rank{r}.json").read_text())) for r in range(world)]
    return ranks, reference


def _scores(arrays, prefix):
    return [arrays[f"{prefix}_{i}"] for i in range(3)]  # min, mean silhouette, rel_error


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
def test_wave_mesh_shapes_and_coordinates(runs, world):
    ranks, _ = runs
    want_shapes = {1: {"1x1": (1, 1), "Nonex1": (1, 1)},
                   2: {"2x1": (2, 1), "1x2": (1, 2), "Nonex2": (1, 2)},
                   4: {"4x1": (4, 1), "2x2": (2, 2), "1x4": (1, 4), "Nonex2": (2, 2)}}[world]
    for rank, (_, info) in enumerate(ranks[world]):
        assert set(info["meshes"]) == set(want_shapes)
        for tag, (lanes, data) in want_shapes.items():
            assert info["meshes"][tag] == [lanes, data, rank // data, rank % data, "cpu"]


@pytest.mark.parametrize("world", [2, 4])
def test_wave_mesh_raises_where_it_does_not_span_the_world(runs, world):
    ranks, _ = runs
    want = {2: {"1x1": "must span", "Nonex3": "do not split"},
            4: {"1x2": "must span", "3x1": "must span", "4x2": "needs 8 ranks", "Nonex3": "do not split"}}[world]
    for _, info in ranks[world]:
        assert set(info["bad_meshes"]) == set(want)
        for tag, words in want.items():
            assert words in info["bad_meshes"][tag]


@pytest.mark.parametrize("lanes,data,words", [(None, 0, "data must be >= 1"), (0, 1, "lanes must be >= 1"),
                                              (None, 2, "do not split"), (2, 1, "needs 2 ranks")])
def test_wave_mesh_raises_at_one_rank(lanes, data, words):
    import torch.distributed as dist

    with pytest.raises(ValueError, match=words):
        with make_wave_mesh(lanes, data, "cpu"):
            pass
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# nmfk_score_sharded and the NMFk plane
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
def test_lane_only_scores_are_the_batched_bits(runs, world):
    ranks, _ = runs
    tag = f"{world}x1"
    for arrays, info in ranks[world]:
        for got, want in zip(_scores(arrays, f"sharded_{tag}_sync"), _scores(arrays, "batched")):
            np.testing.assert_array_equal(got, want)
        assert info[f"search_{tag}_sync"] == info["batched_search"]


@pytest.mark.parametrize("world", WORLDS)
def test_lane_only_scores_match_the_reference_batched_path(runs, world):
    ranks, reference = runs
    want = reference["batched"]
    for arrays, _ in ranks[world]:
        got = _scores(arrays, f"sharded_{world}x1_sync")
        np.testing.assert_allclose(got[0], np.asarray(want.min_silhouette), rtol=0, atol=SIL_ATOL)
        np.testing.assert_allclose(got[1], np.asarray(want.mean_silhouette), rtol=0, atol=SIL_ATOL)
        np.testing.assert_allclose(got[2], np.asarray(want.rel_error), rtol=BATCHED_ERR_RTOL)


@pytest.mark.parametrize("world,data", [(2, 2), (4, 4)])
@pytest.mark.parametrize("comm", ["sync", "pipelined"])
def test_data_sharded_body_matches_the_reference_vmapped(runs, world, data, comm):
    """Each schedule against the reference's same schedule, at the tolerances
    of the per-rank bodies (pipelined is as deterministic as sync: the same
    one-sweep-stale H in both packages)."""
    ranks, reference = runs
    (w_ref, errs_ref), score_ref = reference[(data, comm, "fits")], reference[(data, comm)]
    for arrays, _ in ranks[world]:
        score = _scores(arrays, f"dist{data}_{comm}")
        assert arrays[f"dist{data}_{comm}_contiguous"]  # the card's silhouette kernel takes contiguous columns
        np.testing.assert_allclose(arrays[f"dist{data}_{comm}_w"], w_ref, **FIT_TOL)
        np.testing.assert_allclose(arrays[f"dist{data}_{comm}_errs"], errs_ref, rtol=ERR_RTOL)
        np.testing.assert_allclose(score[2], score_ref[2], rtol=ERR_RTOL)
        for got, want in zip(score[:2], score_ref[:2]):
            np.testing.assert_allclose(got, want, rtol=0, atol=DIST_SIL_ATOL)


@pytest.mark.parametrize("world,data", [(2, 2), (4, 4)])
@pytest.mark.parametrize("comm", ["sync", "pipelined"])
def test_data_sharded_chunk_of_many_lanes_is_each_lane_alone(runs, world, data, comm):
    """The elastic plane's data-sharded chunk runs its lanes as one batched
    fit (each sweep's collectives carry every lane): each lane's W, H and
    error are its own single-lane chunk's up to the order of the sums, and
    a lane given 0 sweeps comes back as it went in."""
    ranks, _ = runs
    for arrays, _ in ranks[world]:
        for name in ("w", "h"):
            np.testing.assert_allclose(arrays[f"chunk{data}_{comm}_together_{name}"],
                                       arrays[f"chunk{data}_{comm}_alone_{name}"], **FIT_TOL)
        np.testing.assert_allclose(arrays[f"chunk{data}_{comm}_together_err"],
                                   arrays[f"chunk{data}_{comm}_alone_err"], rtol=ERR_RTOL)
        np.testing.assert_array_equal(arrays[f"chunk{data}_{comm}_together_w"][1], arrays[f"chunk{data}_{comm}_w0"][1])


@pytest.mark.parametrize("world,tag", [(2, "1x2"), (4, "2x2"), (4, "1x4")])
@pytest.mark.parametrize("comm", ["sync", "pipelined"])
def test_data_sharded_planes_against_the_batched_plane(runs, world, tag, comm):
    ranks, _ = runs
    first = ranks[world][0]
    for arrays, info in ranks[world]:
        k_opt, visited, scores = info[f"search_{tag}_{comm}"]
        want_k, _, want_scores = info["batched_search"]
        assert k_opt == want_k == K_TRUE
        if comm == "sync":
            for got, want in zip(_scores(arrays, f"sharded_{tag}_sync")[:2], _scores(arrays, "batched")[:2]):
                np.testing.assert_allclose(got, want, rtol=0, atol=SHARD_SYNC_ATOL)
            assert visited == info["batched_search"][1]
            assert max(abs(scores[k] - want_scores[k]) for k in scores) <= SHARD_SYNC_ATOL
        else:
            assert abs(scores[str(k_opt)] - want_scores[str(k_opt)]) < PIPELINED_ATOL
        # every rank took the same decisions from the same floats
        assert info[f"search_{tag}_{comm}"] == first[1][f"search_{tag}_{comm}"]
        for got, want in zip(_scores(arrays, f"sharded_{tag}_{comm}"), _scores(first[0], f"sharded_{tag}_{comm}")):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# K-Means and the elastic plane
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", [2, 4])
def test_kmeans_plane_lane_sharded_is_the_unsharded_plane(runs, world):
    ranks, _ = runs
    tag = f"{world}x1"
    for rank, (arrays, info) in enumerate(ranks[world]):
        np.testing.assert_array_equal(arrays[f"km_scores_{tag}"], arrays["km_scores"])
        per = arrays["km_labels"].shape[0] // world
        np.testing.assert_array_equal(arrays[f"km_labels_{tag}"], arrays["km_labels"][rank * per:(rank + 1) * per])
        for data_tag in DATA_MESHES[world]:
            assert "lane-only" in info[f"km_data_{data_tag}"]


@pytest.mark.parametrize("world", WORLDS)
def test_elastic_plane_lane_sharded_is_the_unsharded_plane(runs, world):
    ranks, _ = runs
    for _, info in ranks[world]:
        got, want = info[f"elastic_{world}x1_sync"], info["elastic"]
        assert got["scores"] == want["scores"] and sorted(want["scores"]) == [str(k) for k in range(2, 9)]
        assert got["sweeps"] == want["sweeps"] and got["warm_start_hits"] == want["warm_start_hits"] > 0
        assert all(batch % world == 0 for batch, _ in got["shapes"])


@pytest.mark.parametrize("world,tag", [(2, "1x2"), (4, "2x2")])
def test_elastic_plane_data_sharded_against_the_unsharded_plane(runs, world, tag):
    ranks, _ = runs
    for _, info in ranks[world]:
        want, got = info["elastic"], info[f"elastic_{tag}_sync"]
        assert got["sweeps"] == want["sweeps"] and got["warm_start_hits"] == want["warm_start_hits"]
        assert set(got["scores"]) == set(want["scores"])
        assert max(abs(got["scores"][k] - want["scores"][k]) for k in want["scores"]) <= SHARD_SYNC_ATOL
        assert got == ranks[world][0][1][f"elastic_{tag}_sync"]


# ---------------------------------------------------------------------------
# the k-search CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
def test_ksearch_sharded_gives_every_rank_the_same_result(runs, world):
    ranks, _ = runs
    first = ranks[world][0][1]["ksearch"]
    assert first["k_optimal"] == K_TRUE and first["mesh"] == {"lanes": world, "data": 1}
    for rank, (_, info) in enumerate(ranks[world]):
        assert info["ksearch"] == first
        printed = info["ksearch_printed"]
        if rank == 0:
            assert json.loads(printed)["k_optimal"] == K_TRUE
        else:
            assert printed == ""


@pytest.fixture
def one_thread():
    """The in-process searches on one intra-op thread: at these sizes more
    threads only contend with the other test workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_ksearch_sharded_at_one_rank_twice_then_distributed_fit(one_thread):
    """In one process: the one-rank mesh's groups are made and destroyed by
    each run, so a second run and then ``--distributed-fit`` start clean.
    At one rank pipelined has nothing to overlap: the batched run's bits."""
    import torch.distributed as dist

    first = ksearch.main(["--device", "cpu", "--executor", "sharded", "--quiet"])
    assert first["k_optimal"] == first["k_true"] == 5
    assert first["mesh"] == {"lanes": 1, "data": 1} and first["comm"] == "sync"
    assert first["lane_utilization_last"] is not None and not dist.is_initialized()
    small = ["--device", "cpu", "--k-max", "8", "--nmf-iters", "40", "--quiet"]
    again = ksearch.main(small + ["--executor", "sharded", "--comm", "pipelined"])
    assert again["k_optimal"] == 5 and again["comm"] == "pipelined" and "overlap_fraction" not in again
    batched = ksearch.main(small + ["--executor", "batched"])
    assert again["scores"] == batched["scores"] and again["visited"] == batched["visited"]
    fit = ksearch.main(small + ["--distributed-fit", "--resources", "2"])
    assert fit["k_optimal"] == 5 and fit["distributed_fit"] and not dist.is_initialized()


def test_ksearch_elastic_on_a_one_rank_mesh(one_thread):
    out = ksearch.main(["--device", "cpu", "--executor", "elastic", "--lanes", "1", "--k-max", "8",
                        "--nmf-iters", "40", "--quiet"])
    assert out["k_optimal"] == 5 and out["mesh"] == {"lanes": 1, "data": 1}
    assert out["sweeps_run"] + out["sweeps_saved"] == out["sweeps_fixed_total"]


def test_parser_takes_the_mesh_flags_and_refuses_a_bad_comm(capsys):
    args = ksearch._parser().parse_args(["--executor", "sharded", "--lanes", "2", "--data-shards", "2",
                                         "--comm", "pipelined"])
    assert (args.executor, args.lanes, args.data_shards, args.comm) == ("sharded", 2, 2, "pipelined")
    args = ksearch._parser().parse_args(["--executor", "elastic", "--lanes", "4"])
    assert (args.lanes, args.data_shards, args.comm) == (4, 1, "sync")
    with pytest.raises(SystemExit):
        ksearch._parser().parse_args(["--executor", "sharded", "--comm", "async"])
    assert "invalid choice" in capsys.readouterr().err


def test_distributed_example_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_distributed_ksearch.py"), "--device", "cpu",
                          "--journal", str(tmp_path / "journal")], capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    assert "k_optimal=6" in out.stdout
