"""Shared helpers of the port's parity tests: the JAX reference's draws,
the names of its parameter trees, and its greedy serve runs.

The port never imports JAX; these helpers run the reference's random
schedule (``nmfk.py`` / ``nmf.py`` / ``kmeans.py`` / ``rescal.py`` /
``distributed.py`` key splits) here, in the test process, and hand the
draws to the port as numpy arrays through ``repro_torch.convert``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro_torch.convert import draws_from_reference, kmeans_draws_from_reference, rescal_draws_from_reference


def uniform(key, shape, lo, hi, dtype=jnp.float32) -> np.ndarray:
    """The reference's uniform draw at ``dtype`` (bf16: an ``ml_dtypes`` array)."""
    return np.array(jax.random.uniform(key, shape, dtype, lo, hi))


def init_draws(key, n: int, m: int, k_draw: int, dtype=jnp.float32) -> tuple[np.ndarray, np.ndarray]:
    """Unscaled W/H draws of ``nmf_init`` / ``_masked_init`` for ``key``, at V's dtype."""
    kw, kh = jax.random.split(key)
    return uniform(kw, (n, k_draw), 0.1, 1.0, dtype), uniform(kh, (k_draw, m), 0.1, 1.0, dtype)


def ensemble_draws(key, n: int, m: int, k_draw: int, n_perturbs: int, epsilon: float, dtype=jnp.float32):
    """(noise, w, h) numpy draws of one NMFk ensemble at ``key`` (already
    folded with k), as ``nmfk_score`` / ``_nmfk_score_masked`` make them
    for a V of ``dtype``."""
    kp, kf = jax.random.split(key)
    pkeys = jax.random.split(kp, n_perturbs)
    fkeys = jax.random.split(kf, n_perturbs)
    noise = np.stack([uniform(pk, (n, m), 1.0 - epsilon, 1.0 + epsilon, dtype) for pk in pkeys])
    inits = [init_draws(fk, n, m, k_draw, dtype) for fk in fkeys]
    return noise, np.stack([w for w, _ in inits]), np.stack([h for _, h in inits])


def kmeans_draws(key, n: int, k_draw: int) -> tuple[int, np.ndarray]:
    """(first, u) of ``_kmeanspp_init`` / ``_masked_kmeanspp_init`` at
    ``key``, k_draw slots: ``k0, key = split(key)``, ``first = randint(k0,
    (), 0, n)``, then per slot ``key, sub = split(key)`` and the uniform that
    ``jax.random.choice(sub, n, p=p)`` draws (``uniform(sub, ())``)."""
    k0, key = jax.random.split(key)
    first = int(jax.random.randint(k0, (), 0, n))
    u = []
    for _ in range(1, k_draw):
        key, sub = jax.random.split(key)
        u.append(float(jax.random.uniform(sub, (), jnp.float32)))
    return first, np.asarray(u, np.float32)


def reference_kmeans_draw_source(key, n: int):
    """A port K-Means draw source ``(k, k_draw) -> KMeansDraws`` yielding the
    reference's draws of k under ``fold_in(key, k)`` (the evaluators' and
    ``kmeans_batched``'s schedule)."""

    def draw(k: int, k_draw: int):
        return kmeans_draws_from_reference(*kmeans_draws(jax.random.fold_in(key, k), n, k_draw), device="cpu")

    return draw


def reference_draw_source(key, n: int, m: int, n_perturbs: int, epsilon: float = 0.015, dtype=jnp.float32):
    """A port draw source ``(k, k_draw) -> Draws`` yielding the reference's
    draws of rank k under ``fold_in(key, k)`` (the evaluators' schedule)
    for a V of ``dtype``."""

    def draw(k: int, k_draw: int):
        arrays = ensemble_draws(jax.random.fold_in(key, k), n, m, k_draw, n_perturbs, epsilon, dtype)
        return draws_from_reference(*arrays, device="cpu")

    return draw


def rescal_init_draws(key, n: int, nr: int, k: int, dtype=jnp.float32) -> tuple[np.ndarray, np.ndarray]:
    """Unscaled A/R draws of ``rescal._init`` for ``key``, at X's dtype."""
    ka, kr = jax.random.split(key)
    return uniform(ka, (n, k), 0.1, 1.0, dtype), uniform(kr, (nr, k, k), 0.1, 1.0, dtype)


def rescal_ensemble_draws(key, n: int, nr: int, k: int, n_perturbs: int, epsilon: float, dtype=jnp.float32):
    """(noise, a, r) numpy draws of one RESCALk ensemble at ``key`` (already
    folded with k), as ``rescalk_score`` makes them for an X of ``dtype``."""
    kp, kf = jax.random.split(key)
    pkeys = jax.random.split(kp, n_perturbs)
    fkeys = jax.random.split(kf, n_perturbs)
    noise = np.stack([uniform(pk, (nr, n, n), 1.0 - epsilon, 1.0 + epsilon, dtype) for pk in pkeys])
    inits = [rescal_init_draws(fk, n, nr, k, dtype) for fk in fkeys]
    return noise, np.stack([a for a, _ in inits]), np.stack([r for _, r in inits])


def reference_rescal_draw_source(key, n: int, nr: int, n_perturbs: int, epsilon: float = 0.015, dtype=jnp.float32):
    """A port RESCAL draw source ``k -> RESCALDraws`` yielding the reference's
    draws of rank k under ``fold_in(key, k)`` (``make_rescalk_evaluator``'s
    schedule) for an X of ``dtype``."""

    def draw(k: int):
        arrays = rescal_ensemble_draws(jax.random.fold_in(key, k), n, nr, k, n_perturbs, epsilon, dtype)
        return rescal_draws_from_reference(*arrays, device="cpu")

    return draw


def dnmf_draws(key, n: int, m: int, k: int, shards: int, dtype=jnp.float32) -> tuple[np.ndarray, np.ndarray]:
    """Full-shape unscaled W (n, k) / H (k, m) of ``_dnmf_local`` over
    ``shards`` row blocks, at V's dtype: shard i draws its rows from
    ``fold_in(kw, i)``, so the full W is their concatenation; H is ``kh``'s,
    on every shard."""
    kw, kh = jax.random.split(key)
    rows = n // shards
    w = np.concatenate([uniform(jax.random.fold_in(kw, i), (rows, k), 0.1, 1.0, dtype) for i in range(shards)])
    return w, uniform(kh, (k, m), 0.1, 1.0, dtype)


def drescal_draws(key, n: int, nr: int, k: int, shards: int, dtype=jnp.float32) -> tuple[np.ndarray, np.ndarray]:
    """Full-shape unscaled A (n, k) / R (nr, k, k) of ``_drescal_local`` over
    ``shards`` entity-row blocks (A's rows from ``fold_in(ka, i)``), at X's
    dtype."""
    ka, kr = jax.random.split(key)
    rows = n // shards
    a = np.concatenate([uniform(jax.random.fold_in(ka, i), (rows, k), 0.1, 1.0, dtype) for i in range(shards)])
    return a, uniform(kr, (nr, k, k), 0.1, 1.0, dtype)


def reference_shapes(jp) -> dict[str, tuple[int, ...]]:
    """The port's parameter names and shapes of a reference ``Model.init``
    tree: key paths joined by dots, stacked segments unstacked into
    ``seg{i}.{r}``."""
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        if keys[0].startswith("seg"):
            for r in range(leaf.shape[0]):
                want[".".join([keys[0], str(r)] + keys[1:])] = tuple(leaf.shape[1:])
        else:
            want[".".join(keys)] = tuple(leaf.shape)
    return want


def reference_greedy_run(jm, jp, decode, prompt: np.ndarray, steps: int, cache_len: int) -> dict:
    """The reference model ``jm``'s jitted prefill of ``prompt`` and ``steps``
    greedy decode steps after it (``decode``: its jitted ``decode_step``,
    which compiles once for every prompt of one ``cache_len``): each step's
    logits and caches as numpy, and the tokens fed."""
    logits, caches = jax.jit(jm.prefill, static_argnames="cache_len")(jp, {"tokens": prompt}, cache_len=cache_len)
    run = {"prompt": prompt, "logits": [np.asarray(logits)], "caches": [jax.tree.map(np.asarray, caches)], "tokens": []}
    l = prompt.shape[1]
    for i in range(steps):
        tok = np.argmax(run["logits"][-1][:, -1], -1).astype(np.int32)[:, None]
        logits, caches = decode(jp, caches, tok, jnp.asarray(l + i, jnp.int32))
        run["tokens"].append(tok)
        run["logits"].append(np.asarray(logits))
        run["caches"].append(jax.tree.map(np.asarray, caches))
    return run
