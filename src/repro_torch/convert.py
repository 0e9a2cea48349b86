"""Carry the reference's arrays across into port tensors.

NMF and K-Means have no trained weights; what crosses from the JAX
reference to the port is data: the matrix V or the points x (``to_tensor``),
the random draws of an NMFk ensemble or of a k-means++ init, and W/H
factors. The LM's parameter tree crosses whole
(``model_params_from_reference``). Each comes in as a numpy-convertible
array (never a JAX object: the port imports no JAX) and leaves as a tensor
on ``device`` (default: the card), float32 except for indices.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve
from repro_torch.models.layers import frozen
from repro_torch.models.transformer import build_segments
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


def _tree(node, device: torch.device, index: int | None = None) -> nn.Module:
    """A ModuleDict / ParameterDict of a nested dict of arrays, taking
    ``[index]`` of every array when given (one repeat of a stacked segment)."""
    if all(isinstance(v, dict) for v in node.values()):
        return nn.ModuleDict({k: _tree(v, device, index) for k, v in node.items()})
    arrays = {k: np.asarray(v) if index is None else np.asarray(v)[index] for k, v in node.items()}
    return frozen(**{k: to_tensor(a, device) for k, a in arrays.items()})


def model_params_from_reference(params, cfg: ArchConfig, device: str | torch.device | None = None) -> nn.ModuleDict:
    """The port's ``Model.params`` from the reference's parameter tree.

    ``params`` is the reference's ``Model.init`` pytree as nested dicts of
    numpy arrays: ``embed`` (``table``, ``lm_head`` unless tied),
    ``final_norm.scale``, and ``seg{i}.l{j}.*`` stacked on a leading repeat
    axis. Layouts are kept (``wq`` (d, h, hd), ``wo`` (h, hd, d), ...), so
    the conversion is a copy and an unstack of the repeat axis.
    """
    dev = resolve(device)
    out: dict[str, nn.Module] = {"embed": _tree(params["embed"], dev),
                                 "final_norm": _tree(params["final_norm"], dev)}
    for si, seg in enumerate(build_segments(cfg)):
        stacked = params[f"seg{si}"]
        out[f"seg{si}"] = nn.ModuleList(_tree(stacked, dev, r) for r in range(seg.repeat))
    return nn.ModuleDict(out)
