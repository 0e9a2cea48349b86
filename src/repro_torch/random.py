"""Explicit randomness for NMFk, K-Means and RESCALk.

Randomness enters an NMFk score only through a ``Draws`` value: the
multiplicative perturbation noise of each resampled copy of V and the
unscaled uniform W/H inits of each perturbation fit, drawn at V's dtype
as the reference draws them (a bf16 V takes bf16 draws). A K-Means fit
takes it only through a ``KMeansDraws`` value: the first center's index
and one float32 uniform per further k-means++ slot, at any data dtype (the
reference's kernel route draws its choice against float32 distances). A
RESCALk score takes a ``RESCALDraws`` value: the noise of each resampled
copy of X and the unscaled A/R inits, at X's dtype likewise. The
distributed fits take full-shape init draws and keep their own rank's
rows. Fit and score functions take their draws explicitly, so a test can hand them the JAX reference's draws; by
default they come from a ``torch.Generator`` seeded from ``(seed, k)`` (the
counterpart of the reference's ``fold_in(key, k)``). The port's own draws
are not the reference's bits.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

_MASK63 = (1 << 63) - 1


class Draws(NamedTuple):
    """The random inputs of one k's perturbation ensemble.

    noise (p, n, m): multiplicative factors in [1 - eps, 1 + eps);
    w (p, n, k_draw) and h (p, k_draw, m): unscaled init draws in [0.1, 1).
    ``k_draw`` is k on the scalar path and k_pad on the batched path, so
    a batched lane at k == k_pad starts from the scalar fit's draws.
    """

    noise: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor


def lane_seed(seed: int, k: int) -> int:
    """Seed of lane k: a fixed mix of (seed, k), the port's ``fold_in``."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(k) * 0xBF58476D1CE4E5B9 + 1) & _MASK63


def seeded_generator(seed: int, device: str | torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def lane_generator(seed: int, k: int, device: str | torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, k)``."""
    return seeded_generator(lane_seed(seed, k), device)


def init_draws(
    generator: torch.Generator,
    n: int,
    m: int,
    k_draw: int,
    lead: tuple[int, ...] = (),
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unscaled U[0.1, 1) W (lead..., n, k_draw) and H (lead..., k_draw, m)
    draws, drawn at ``dtype`` (the data's, as the reference draws)."""
    dev = generator.device
    w = torch.empty(lead + (n, k_draw), device=dev, dtype=dtype).uniform_(0.1, 1.0, generator=generator)
    h = torch.empty(lead + (k_draw, m), device=dev, dtype=dtype).uniform_(0.1, 1.0, generator=generator)
    return w, h


def make_draws(
    generator: torch.Generator,
    n: int,
    m: int,
    k_draw: int,
    n_perturbs: int,
    epsilon: float,
    dtype: torch.dtype = torch.float32,
) -> Draws:
    """Perturbation noise then W/H inits for ``n_perturbs`` fits at ``k_draw``,
    all at ``dtype``."""
    dev = generator.device
    noise = torch.empty((n_perturbs, n, m), device=dev, dtype=dtype).uniform_(
        1.0 - epsilon, 1.0 + epsilon, generator=generator
    )
    w, h = init_draws(generator, n, m, k_draw, (n_perturbs,), dtype)
    return Draws(noise, w, h)


def check_draws(v: torch.Tensor, draws, name: str = "V") -> None:
    """Raise unless every draw (a ``Draws`` or ``RESCALDraws``, or a tuple of
    tensors) has the data's dtype: a perturbation or init at another dtype
    would promote the fit (a bf16 V or X fitted at float32)."""
    got = {t.dtype for t in draws}
    if got != {v.dtype}:
        raise TypeError(f"the draws must have {name}'s dtype {v.dtype}, got {sorted(str(d) for d in got)}; "
                        f"draw them with dtype={name.lower()}.dtype")


DrawSource = Callable[[int, int], Draws]  # (k, k_draw) -> the draws of rank k


def seeded_draws(
    seed: int,
    n: int,
    m: int,
    n_perturbs: int,
    epsilon: float,
    device: str | torch.device,
    dtype: torch.dtype = torch.float32,
) -> DrawSource:
    """The default draw source: rank k draws from ``lane_generator(seed, k)``
    at ``dtype``."""

    def draw(k: int, k_draw: int) -> Draws:
        return make_draws(lane_generator(seed, k, device), n, m, k_draw, n_perturbs, epsilon, dtype)

    return draw


def stack_draws(draws: list):
    """Per-lane ``Draws`` or ``KMeansDraws`` stacked on a leading lane axis
    (all at one k_draw)."""
    return type(draws[0])(*(torch.stack(parts) for parts in zip(*draws)))


# -----------------------------------------------------------------------------
# K-Means
# -----------------------------------------------------------------------------
KMEANS_DRAW_SLOTS = 128  # k-means++ slots one block serves: the first index and 127 uniforms


class KMeansDraws(NamedTuple):
    """The random inputs of one k-means++ init.

    first (): index of the first center; u (k_draw - 1,): one uniform in
    [0, 1) per further slot, consumed as ``jax.random.choice`` consumes
    its uniform (``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u))``). A
    fit at k_eff <= k_draw uses the first k_eff - 1 of them, so the draws at
    k_pad start with the draws at k.
    """

    first: torch.Tensor
    u: torch.Tensor


def kmeans_draws(generator: torch.Generator, n: int, k_draw: int) -> KMeansDraws:
    """``first`` in [0, n) then uniforms in blocks of ``KMEANS_DRAW_SLOTS - 1``,
    cut to k_draw - 1.

    Each block is one ``torch.rand`` call of a fixed length, and as many
    blocks are drawn as k_draw - 1 needs: a draw of length k_pad - 1 need not
    begin with the draw of length k - 1 on the card, but a later block never
    changes an earlier one, so a padded lane's draws start with those of its
    per-k fit at any k and k_pad. Up to k_draw = ``KMEANS_DRAW_SLOTS`` one
    block is drawn.
    """
    if k_draw < 1:
        raise ValueError(f"k-means++ draws take k_draw >= 1, got {k_draw}")
    dev = generator.device
    first = torch.randint(0, n, (), device=dev, generator=generator)
    block = KMEANS_DRAW_SLOTS - 1
    blocks = max(1, -(-(k_draw - 1) // block))
    u = torch.cat([torch.rand((block,), device=dev, generator=generator) for _ in range(blocks)])
    return KMeansDraws(first, u[: k_draw - 1])


KMeansDrawSource = Callable[[int, int], KMeansDraws]  # (k, k_draw) -> the draws of k


def seeded_kmeans_draws(seed: int, n: int, device: str | torch.device) -> KMeansDrawSource:
    """The default K-Means draw source: k draws from ``lane_generator(seed, k)``."""

    def draw(k: int, k_draw: int) -> KMeansDraws:
        return kmeans_draws(lane_generator(seed, k, device), n, k_draw)

    return draw


# -----------------------------------------------------------------------------
# RESCAL
# -----------------------------------------------------------------------------
class RESCALDraws(NamedTuple):
    """The random inputs of one k's RESCALk perturbation ensemble, at X's dtype.

    noise (p, nr, n, n): multiplicative factors in [1 - eps, 1 + eps);
    a (p, n, k) and r (p, nr, k, k): unscaled init draws in [0.1, 1).
    """

    noise: torch.Tensor
    a: torch.Tensor
    r: torch.Tensor


def rescal_init_draws(
    generator: torch.Generator,
    n: int,
    nr: int,
    k: int,
    lead: tuple[int, ...] = (),
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unscaled U[0.1, 1) A (lead..., n, k) and R (lead..., nr, k, k) draws at
    ``dtype`` (X's, as the reference draws them).

    A distributed RESCAL fit takes the full (n, k) A draw and keeps its own
    rank's rows, so every world size starts from the same factors.
    """
    dev = generator.device
    a = torch.empty(lead + (n, k), device=dev, dtype=dtype).uniform_(0.1, 1.0, generator=generator)
    r = torch.empty(lead + (nr, k, k), device=dev, dtype=dtype).uniform_(0.1, 1.0, generator=generator)
    return a, r


def make_rescal_draws(
    generator: torch.Generator,
    n: int,
    nr: int,
    k: int,
    n_perturbs: int,
    epsilon: float,
    dtype: torch.dtype = torch.float32,
) -> RESCALDraws:
    """Perturbation noise then A/R inits for ``n_perturbs`` RESCAL fits at k,
    all at ``dtype``."""
    noise = torch.empty((n_perturbs, nr, n, n), device=generator.device, dtype=dtype).uniform_(
        1.0 - epsilon, 1.0 + epsilon, generator=generator
    )
    a, r = rescal_init_draws(generator, n, nr, k, (n_perturbs,), dtype)
    return RESCALDraws(noise, a, r)


RESCALDrawSource = Callable[[int], RESCALDraws]  # k -> the draws of rank k


def seeded_rescal_draws(
    seed: int,
    n: int,
    nr: int,
    n_perturbs: int,
    epsilon: float,
    device: str | torch.device,
    dtype: torch.dtype = torch.float32,
) -> RESCALDrawSource:
    """The default RESCAL draw source: rank k draws from ``lane_generator(seed, k)``
    at ``dtype``."""

    def draw(k: int) -> RESCALDraws:
        return make_rescal_draws(lane_generator(seed, k, device), n, nr, k, n_perturbs, epsilon, dtype)

    return draw
