"""Carry the reference's arrays across into port tensors.

NMF, RESCAL and K-Means have no trained weights; what crosses from the
JAX reference to the port is data: the matrix V, the tensor X or the points
x (``to_tensor``), the random draws of an NMFk or RESCALk ensemble or of a
k-means++ init, and W/H factors. The LM's parameter tree crosses whole
(``model_params_from_reference``), and so does an AdamW state
(``opt_state_from_reference``). Each comes in as a numpy-convertible
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
from repro_torch.random import Draws, KMeansDraws, RESCALDraws
from repro_torch.train.optimizer import OptState


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


def rescal_draws_from_reference(noise, a, r, device: str | torch.device | None = None) -> RESCALDraws:
    """``RESCALDraws`` from the reference's RESCALk ensemble draws.

    noise (p, nr, n, n) is ``uniform(pk, x.shape, 1-eps, 1+eps)`` per
    perturbation; a (p, n, k) and r (p, nr, k, k) are ``rescal._init``'s
    ``uniform(ka/kr, ..., 0.1, 1.0)`` draws before scaling.
    """
    return RESCALDraws(to_tensor(noise, device), to_tensor(a, device), to_tensor(r, device))


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
    ``[index]`` of every array when given (one repeat of a stacked segment).
    A node of sub-dicts only is a ModuleDict; a node holding arrays is a
    ParameterDict, with any sub-dicts beside them (MLA's ``q_norm``, the MoE
    FFN's ``shared``) as submodules."""
    if all(isinstance(v, dict) for v in node.values()):
        return nn.ModuleDict({k: _tree(v, device, index) for k, v in node.items()})

    def entry(v):
        if isinstance(v, dict):
            return _tree(v, device, index)
        return to_tensor(np.asarray(v) if index is None else np.asarray(v)[index], device)

    return frozen(**{k: entry(v) for k, v in node.items()})


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


def reference_leaf(tree, name: str):
    """The array of the reference's parameter-shaped tree (parameters,
    gradients, AdamW moments) at the port's parameter name:
    ``seg{i}.{r}.l{j}.mixer.wq`` is ``tree["seg{i}"]["l{j}"]["mixer"]["wq"][r]``."""
    parts = name.split(".")
    if parts[0].startswith("seg"):
        node = tree[parts[0]]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node)[int(parts[1])]
    node = tree
    for p in parts:
        node = node[p]
    return np.asarray(node)


def opt_state_from_reference(opt_state, names, device: str | torch.device | None = None) -> OptState:
    """The port's ``OptState`` from the reference's ``(step, m, v)``: the moments
    of each parameter in ``names`` (the port's ``named_parameters()`` names),
    in their stored dtype (float32 or bfloat16), and the step as int32."""
    dev = resolve(device)

    def tensor(a) -> torch.Tensor:
        t = torch.tensor(np.asarray(a, dtype=np.float32), device=dev)
        return t.to(torch.bfloat16) if str(np.asarray(a).dtype) == "bfloat16" else t

    step, m, v = opt_state
    return OptState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
        m={n: tensor(reference_leaf(m, n)) for n in names},
        v={n: tensor(reference_leaf(v, n)) for n in names},
    )
