"""Carry the reference's arrays across into port tensors.

NMF and K-Means have no trained weights; what crosses from the JAX
reference to the port is data: the matrix V or the points x (``to_tensor``),
the random draws of an NMFk ensemble or of a k-means++ init, and W/H
factors. Each comes in as a numpy-convertible array (never a JAX object:
the port imports no JAX) and leaves as a tensor on ``device`` (default:
the card), float32 except for indices.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.random import Draws, KMeansDraws


def to_tensor(array, device: str | torch.device | None = None) -> torch.Tensor:
    """A float32 tensor on ``device`` holding a copy of ``array``."""
    return torch.tensor(np.asarray(array, dtype=np.float32), device=resolve(device))


def draws_from_reference(noise, w, h, device: str | torch.device | None = None) -> Draws:
    """``Draws`` from the reference's perturbation noise and unscaled init draws.

    noise (..., p, n, m) is the reference's ``uniform(pkey, v.shape, 1-eps,
    1+eps)`` per perturbation; w (..., p, n, k_draw) and h (..., p, k_draw, m)
    are its ``uniform(kw/kh, ..., 0.1, 1.0)`` init draws before scaling.
    """
    return Draws(to_tensor(noise, device), to_tensor(w, device), to_tensor(h, device))


def kmeans_draws_from_reference(first, u, device: str | torch.device | None = None) -> KMeansDraws:
    """``KMeansDraws`` from the reference's k-means++ draws.

    first (...): the reference's ``randint(k0, (), 0, n)`` first center; u
    (..., k_draw - 1): the uniform that ``jax.random.choice`` draws from each
    later slot's subkey. A leading lane axis is kept.
    """
    first = torch.as_tensor(np.asarray(first, dtype=np.int64), device=resolve(device))
    return KMeansDraws(first, to_tensor(u, device))


def factors_from_reference(w, h, device: str | torch.device | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """W and H factors of a reference fit as port tensors."""
    return to_tensor(w, device), to_tensor(h, device)
