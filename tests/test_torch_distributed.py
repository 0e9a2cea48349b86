"""The port's distributed fits (``repro_torch.factorization.distributed``)
against the reference's per-shard bodies, at gloo world sizes 1, 2 and 4.

Each world size is one launch of ``tests/_torch_dist_child.py``, whose
ranks (separate processes, one gloo group) run every case on their row
blocks and write their results. The reference's values come from its
per-shard bodies under ``jax.vmap(..., axis_name="s")`` over the same
shard count in this process, where ``psum``, ``psum_scatter``,
``all_gather`` and ``axis_index`` take their collective meaning
(``tests/test_collectives.py``), with the reference's draws handed to the
ranks. The rest runs in this process: one rank (``group=None``), the
overlap model, the comm check and ``SubmeshPool``.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_reference import dnmf_draws, drescal_draws, init_draws  # noqa: E402
from repro.factorization import distributed as jdist  # noqa: E402
from repro.factorization.synthetic import nmf_data as jnmf_data  # noqa: E402
from repro.factorization.synthetic import rescal_data as jrescal_data  # noqa: E402
from repro_torch.factorization import distributed as tdist  # noqa: E402
from repro_torch.launch.mesh import SubmeshPool  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(4)
N, M, NR = 24, 20, 3  # rows split into 1, 2 and 4 blocks
CFG = dict(k=3, iters=60, k_r=3, iters_r=40, k_eff=3, k_pad=5, iters_m=40, chunk=10, steps=7)
RING_LEAD, RING_COLS = 7, 5  # 7 rows: padded at world 2 and 4
# 60 (40) MU sweeps, ranks' float32 Gram sums against XLA's: the two
# reduction orders drift apart over a fit (measured: factors <= 8.2e-6
# relative, errors <= 1.9e-6 at world 1, 2 and 4); the factors are held at
# 1e-4 relative, the errors at 1e-5.
FIT_TOL = dict(rtol=1e-4, atol=1e-6)
ERR_RTOL = 1e-5
# the float32 psum decomposed against all_reduce: only the order of the sum differs
RING_TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(world: int) -> dict:
    v, _, _ = jnmf_data(KEY, n=N, m=M, k_true=3)
    x, _, _ = jrescal_data(KEY, n_entities=N, n_relations=NR, k_true=3)
    rng = np.random.default_rng(world)
    w0, h0 = init_draws(jax.random.fold_in(KEY, 9), N, M, CFG["k_pad"])
    active = (np.arange(CFG["k_pad"]) < CFG["k_eff"]).astype(np.float32)
    mw, mh = init_draws(jax.random.fold_in(KEY, 7), N, M, CFG["k_pad"])
    dnmf_w, dnmf_h = dnmf_draws(jax.random.fold_in(KEY, 5), N, M, CFG["k"], world)
    drescal_a, drescal_r = drescal_draws(jax.random.fold_in(KEY, 6), N, NR, CFG["k_r"], world)
    return dict(
        ring_x=rng.standard_normal((world, RING_LEAD, RING_COLS)).astype(np.float32),
        ring_xi=rng.integers(-9, 9, (world, RING_LEAD, RING_COLS)).astype(np.int32),
        v=np.asarray(v), x=np.asarray(x), dnmf_w=dnmf_w, dnmf_h=dnmf_h, drescal_a=drescal_a, drescal_r=drescal_r,
        mw=mw, mh=mh, w0=0.3 * w0 * active[None, :], h0=0.3 * h0 * active[:, None],
        **{key: np.asarray(val) for key, val in CFG.items()},
    )


def _reference(world: int) -> dict:
    """The reference's per-shard bodies over ``world`` shards, same draws."""
    v, _, _ = jnmf_data(KEY, n=N, m=M, k_true=3)
    x, _, _ = jrescal_data(KEY, n_entities=N, n_relations=NR, k_true=3)
    inp = _inputs(world)
    v_sh = v.reshape(world, N // world, M)
    x_sh = x.reshape(NR, world, N // world, N).transpose(1, 0, 2, 3)
    w0_sh = jnp.asarray(inp["w0"]).reshape(world, N // world, CFG["k_pad"])
    out = {}
    for comm in jdist.COMM_MODES:
        w, h, err = jax.vmap(lambda vl, comm=comm: jdist._dnmf_local(
            vl, jax.random.fold_in(KEY, 5), CFG["k"], CFG["iters"], "s", comm, axis_size=world), axis_name="s")(v_sh)
        out.update({f"nmf_{comm}_w": w.reshape(N, -1), f"nmf_{comm}_h": h[0], f"nmf_{comm}_err": err[0]})
        w, err = jax.vmap(lambda vl, comm=comm: jdist._dnmf_masked_local(
            vl, jnp.asarray(CFG["k_eff"]), jax.random.fold_in(KEY, 7), CFG["k_pad"], CFG["iters_m"], "s", N,
            comm=comm), axis_name="s")(v_sh)
        out.update({f"masked_{comm}_w": w.reshape(N, -1), f"masked_{comm}_err": err[0]})
        w, h, err = jax.vmap(lambda vl, wl, comm=comm: jdist._dnmf_masked_chunk_local(
            vl, wl, jnp.asarray(inp["h0"]), jnp.asarray(CFG["k_eff"]), CFG["k_pad"], CFG["chunk"], "s", world,
            comm=comm, steps=jnp.asarray(CFG["steps"])), axis_name="s")(v_sh, w0_sh)
        out.update({f"chunk_{comm}_w": w.reshape(N, -1), f"chunk_{comm}_h": h[0], f"chunk_{comm}_err": err[0]})
    a, r, err = jax.vmap(lambda xl: jdist._drescal_local(
        xl, jax.random.fold_in(KEY, 6), CFG["k_r"], CFG["iters_r"], "s"), axis_name="s")(x_sh)
    out.update({"rescal_a": a.reshape(N, -1), "rescal_r": r[0], "rescal_err": err[0]})
    return {key: np.asarray(val) for key, val in out.items()}


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda w: f"world{w}")
def run(request, tmp_path_factory):
    """One child launch at this world size, the reference computed while its
    ranks run: (world, inputs, per-rank results, reference)."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"world{world}")
    inputs = _inputs(world)
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH"))
                                                      if p))
    with subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_child.py"), str(world),
                           str(tmp / "inputs.npz"), str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, env=env) as proc:
        try:
            reference = _reference(world)
        finally:
            stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"child failed:\n{stdout}\n{stderr}"
    assert f"dist child OK world={world}" in stdout
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
    return world, inputs, ranks, reference


def _rows(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def test_ring_collectives_match_all_reduce(run):
    world, inputs, ranks, _ = run
    for name in ("ring_x", "ring_xi"):
        total = inputs[name].sum(axis=0)
        for out in ranks:
            np.testing.assert_allclose(out[f"{name}_all_reduce"], total, **RING_TOL)
            for key in (f"{name}_psum_0", f"{name}_psum_1", f"{name}_psum_async_0", f"{name}_psum_async_1"):
                assert out[key].shape == total.shape
                if name == "ring_xi":
                    np.testing.assert_array_equal(out[key], total)
                else:
                    np.testing.assert_allclose(out[key], out[f"{name}_all_reduce"], **RING_TOL)
            for key in (f"{name}_gather_0", f"{name}_gather_1"):
                np.testing.assert_array_equal(out[key], inputs[name].reshape(world * RING_LEAD, RING_COLS))


@pytest.mark.parametrize("comm", ["sync", "pipelined"])
def test_distributed_nmf_matches_reference_shards(run, comm):
    _, _, ranks, reference = run
    np.testing.assert_allclose(_rows(ranks, f"nmf_{comm}_w"), reference[f"nmf_{comm}_w"], **FIT_TOL)
    for out in ranks:  # H and the error are replicated
        np.testing.assert_allclose(out[f"nmf_{comm}_h"], reference[f"nmf_{comm}_h"], **FIT_TOL)
        np.testing.assert_allclose(out[f"nmf_{comm}_err"], reference[f"nmf_{comm}_err"], rtol=ERR_RTOL)


def test_distributed_rescal_matches_reference_shards(run):
    _, _, ranks, reference = run
    np.testing.assert_allclose(_rows(ranks, "rescal_a"), reference["rescal_a"], **FIT_TOL)
    for out in ranks:
        np.testing.assert_allclose(out["rescal_r"], reference["rescal_r"], **FIT_TOL)
        np.testing.assert_allclose(out["rescal_err"], reference["rescal_err"], rtol=ERR_RTOL)


@pytest.mark.parametrize("comm", ["sync", "pipelined"])
def test_masked_bodies_match_reference_shards(run, comm):
    """``_dnmf_masked_local``, and ``_dnmf_masked_chunk_local`` gated to
    ``steps`` < ``chunk``; masked components exactly zero."""
    _, _, ranks, reference = run
    for body in ("masked", "chunk"):
        w = _rows(ranks, f"{body}_{comm}_w")
        np.testing.assert_allclose(w, reference[f"{body}_{comm}_w"], **FIT_TOL)
        assert not w[:, CFG["k_eff"]:].any()
        for out in ranks:
            np.testing.assert_allclose(out[f"{body}_{comm}_err"], reference[f"{body}_{comm}_err"], rtol=ERR_RTOL)
    for out in ranks:
        np.testing.assert_allclose(out[f"chunk_{comm}_h"], reference[f"chunk_{comm}_h"], **FIT_TOL)


def test_sync_masked_fit_matches_single_device_fit(run):
    """Sync over the ranks is the port's single-device ``_nmf_masked`` on the
    same draws, up to the order of the Gram sums."""
    _, _, ranks, _ = run
    np.testing.assert_allclose(_rows(ranks, "masked_sync_w"), ranks[0]["single_masked_w"], **FIT_TOL)
    np.testing.assert_allclose(ranks[0]["masked_sync_err"], ranks[0]["single_masked_err"], rtol=ERR_RTOL)


def test_pipelined_against_sync(run):
    """At world 1 there is nothing to overlap: pipelined is sync, bit for bit
    (the port of ``test_pipelined_single_shard_is_exactly_sync``). Above
    it, the whole fits' one-sweep-stale schedule stays within the
    reference's documented staleness bound of sync (5e-2 on the error); a
    chunk gated to ``steps`` < ``chunk`` skips its closing sync sweep, so
    it has no such bound (it is held to the reference above)."""
    world, _, ranks, _ = run
    for body, fields in (("nmf", ("w", "h", "err")), ("masked", ("w", "err")), ("chunk", ("w", "h", "err"))):
        for out in ranks:
            if world == 1:
                for field in fields:
                    np.testing.assert_array_equal(out[f"{body}_pipelined_{field}"], out[f"{body}_sync_{field}"])
            elif body != "chunk":
                assert abs(float(out[f"{body}_pipelined_err"]) - float(out[f"{body}_sync_err"])) < 5e-2


# ---------------------------------------------------------------------------
# in this process: one rank, the overlap model, the comm check, the pool
# ---------------------------------------------------------------------------
def test_one_rank_without_a_group_is_the_reference_at_one_shard():
    v, _, _ = jnmf_data(KEY, n=12, m=10, k_true=3)
    w_draw, h_draw = (torch.from_numpy(a) for a in dnmf_draws(KEY, 12, 10, 3, 1))
    mesh = jdist.make_local_mesh(1)
    vt = torch.from_numpy(np.array(v))
    a = tdist.distributed_nmf(vt, 3, w_draw, h_draw, iters=40, comm="sync")
    b = tdist.distributed_nmf(vt, 3, w_draw, h_draw, iters=40, comm="pipelined")
    assert torch.equal(a.w, b.w) and torch.equal(a.h, b.h) and torch.equal(a.rel_error, b.rel_error)
    want = jdist.distributed_nmf(v, 3, KEY, mesh, iters=40)
    np.testing.assert_allclose(a.w.numpy(), np.asarray(want.w), **FIT_TOL)
    np.testing.assert_allclose(float(a.rel_error), float(want.rel_error), rtol=ERR_RTOL)


def test_overlap_model_equals_reference():
    for n_total, m, k_pad in ((512, 128, 8), (4096, 512, 8), (1000, 1100, 16), (96, 104, 13)):
        for data in (1, 2, 3, 4, 8):
            for balance in (1.0, 8.0, 64.0):
                assert tdist.overlap_model(n_total, m, k_pad, data, balance) == jdist.overlap_model(
                    n_total, m, k_pad, data, balance)


def test_unknown_comm_raises():
    with pytest.raises(ValueError, match="comm"):
        tdist._mu_sweeps(torch.ones(4, 3), torch.ones(4, 2), torch.ones(2, 3), None, 5, None, "async")


def test_unequal_row_blocks_raise():
    with pytest.raises(ValueError, match="rows"):
        tdist.distributed_nmf(torch.ones(4, 3), 2, torch.ones(5, 2), torch.ones(2, 3))


def test_submesh_pool_keys_on_worker_not_k():
    """Regression (the reference's ``test_submesh_pool_keys_on_worker_not_k``):
    keying on ``k % n`` put two concurrent workers on one group; the pool
    leases per worker thread."""
    subs = [object(), object()]  # the pool never touches the group itself
    pool = SubmeshPool(subs)
    leases = {}
    barrier = threading.Barrier(2)

    def worker(name, ks):
        barrier.wait(timeout=30)
        got = {id(pool.acquire()) for _ in ks}  # every k, same worker
        assert len(got) == 1
        leases[name] = got.pop()

    threads = [threading.Thread(target=worker, args=("a", [2, 4, 8])),
               threading.Thread(target=worker, args=("b", [6, 10, 12]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert leases["a"] != leases["b"]
    assert set(pool.assignments().values()) == {0, 1}
    with pytest.raises(ValueError):
        SubmeshPool([])
