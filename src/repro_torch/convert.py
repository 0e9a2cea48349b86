"""Carry the reference's arrays across into port tensors.

NMF, RESCAL and K-Means have no trained weights; what crosses from the
JAX reference to the port is data: the matrix V, the tensor X or the points
x (``to_tensor``), the random draws of an NMFk or RESCALk ensemble or of a
k-means++ init, and W/H factors. The LM's parameter tree crosses whole
(``model_params_from_reference``; on a ``(data, model)`` mesh each rank
keeps its blocks, and ``model_params_to_reference`` joins them back), and
so does an AdamW state
(``opt_state_from_reference``). Each comes in as a numpy-convertible
array (never a JAX object: the port imports no JAX) and leaves as a tensor
on ``device`` (default: the card): data float32, indices int64, and a
parameter or moment in its own dtype, bfloat16 (``ml_dtypes``' numpy
dtype, what ``np.asarray`` gives of a JAX bf16 array) or float32. A
bfloat16 tensor goes back as an ``ml_dtypes.bfloat16`` array: numpy has no
bfloat16 of its own. Both ways are exact.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve
from repro_torch.models.layers import frozen
from repro_torch.models.transformer import Model, build_segments
from repro_torch.random import Draws, KMeansDraws, RESCALDraws
from repro_torch.train.optimizer import OptState


def to_tensor(array, device: str | torch.device | None = None) -> torch.Tensor:
    """A float32 tensor on ``device`` holding a copy of ``array``."""
    return torch.tensor(np.asarray(array, dtype=np.float32), device=resolve(device))


def leaf_tensor(array, device: torch.device) -> torch.Tensor:
    """A parameter-shaped array as a tensor of its own dtype: bfloat16 for
    an ``ml_dtypes.bfloat16`` array (through float32, which holds every
    bfloat16 value exactly), else float32."""
    t = torch.tensor(np.asarray(array, dtype=np.float32), device=device)
    return t.to(torch.bfloat16) if str(np.asarray(array).dtype) == "bfloat16" else t


def leaf_array(t: torch.Tensor) -> np.ndarray:
    """``leaf_tensor``'s inverse: a host numpy array, ``ml_dtypes.bfloat16``
    for a bfloat16 tensor."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    import ml_dtypes  # only the tests carry bf16 trees to the reference

    return t.float().numpy().astype(ml_dtypes.bfloat16)


def draws_from_reference(noise, w, h, device: str | torch.device | None = None) -> Draws:
    """``Draws`` from the reference's perturbation noise and unscaled init draws.

    noise (..., p, n, m) is the reference's ``uniform(pkey, v.shape, 1-eps,
    1+eps)`` per perturbation; w (..., p, n, k_draw) and h (..., p, k_draw, m)
    are its ``uniform(kw/kh, ..., 0.1, 1.0)`` init draws before scaling. The
    reference draws at V's dtype: bfloat16 arrays stay bfloat16
    (``leaf_tensor``), others become float32.
    """
    dev = resolve(device)
    return Draws(leaf_tensor(noise, dev), leaf_tensor(w, dev), leaf_tensor(h, dev))


def rescal_draws_from_reference(noise, a, r, device: str | torch.device | None = None) -> RESCALDraws:
    """``RESCALDraws`` from the reference's RESCALk ensemble draws.

    noise (p, nr, n, n) is ``uniform(pk, x.shape, 1-eps, 1+eps)`` per
    perturbation; a (p, n, k) and r (p, nr, k, k) are ``rescal._init``'s
    ``uniform(ka/kr, ..., 0.1, 1.0)`` draws before scaling. The reference
    draws at X's dtype: bfloat16 arrays stay bfloat16 (``leaf_tensor``),
    others become float32.
    """
    dev = resolve(device)
    return RESCALDraws(leaf_tensor(noise, dev), leaf_tensor(a, dev), leaf_tensor(r, dev))


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
        return leaf_tensor(np.asarray(v) if index is None else np.asarray(v)[index], device)

    return frozen(**{k: entry(v) for k, v in node.items()})


def model_params_from_reference(params, cfg: ArchConfig, device: str | torch.device | None = None,
                                mesh=None, model: Model | None = None) -> nn.ModuleDict:
    """The port's ``Model.params`` from the reference's parameter tree.

    ``params`` is the reference's ``Model.init`` pytree as nested dicts of
    numpy arrays: ``embed`` (``table``, ``lm_head`` unless tied),
    ``final_norm.scale``, and ``seg{i}.l{j}.*`` stacked on a leading repeat
    axis. Layouts are kept (``wq`` (d, h, hd), ``wo`` (h, hd, d), ...), so
    the conversion is a copy and an unstack of the repeat axis. With a
    ``mesh`` (``launch.mesh.LMMesh``) it returns this rank's blocks,
    placed as ``model`` places them (``Model.place``; default ``Model(cfg,
    mesh=mesh)``: pass the training model to carry its FSDP widening).
    """
    dev = resolve(device)
    out: dict[str, nn.Module] = {"embed": _tree(params["embed"], dev),
                                 "final_norm": _tree(params["final_norm"], dev)}
    for si, seg in enumerate(build_segments(cfg)):
        stacked = params[f"seg{si}"]
        out[f"seg{si}"] = nn.ModuleList(_tree(stacked, dev, r) for r in range(seg.repeat))
    return (model or Model(cfg, mesh=mesh)).place(nn.ModuleDict(out))


def model_params_to_reference(params: nn.Module | Mapping[str, torch.Tensor], model: Model) -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays, each
    segment's leaves stacked on a leading repeat axis) of the port's
    ``params``: ``model_params_from_reference``'s inverse. ``params`` may
    also be any mapping of parameter name to tensor: gradients or AdamW
    moments (``grads_to_reference``). On a mesh they are this rank's
    blocks, joined over the mesh's groups (``Model.gather``), so every rank
    of the mesh must call it."""
    tree: dict = {}
    for name, whole in model.gather(params).items():
        path = name.split(".")
        if path[0].startswith("seg"):  # seg{i}.{r}.l{j}...: one repeat of a stacked leaf
            path = [path[0]] + path[2:]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        leaf = leaf_array(whole)
        if name.startswith("seg"):
            node.setdefault(path[-1], []).append(leaf)  # repeats come in order
        else:
            node[path[-1]] = leaf

    def stack(node):
        return {k: stack(v) if isinstance(v, dict) else np.stack(v) if isinstance(v, list) else v
                for k, v in node.items()}

    return stack(tree)


def grads_to_reference(grads: Mapping[str, torch.Tensor], model: Model) -> dict:
    """A rank's gradients (``train_step.accumulate_grads``), joined to whole
    tensors in the reference's tree (``jax.grad(Model.loss_fn)``'s layout)."""
    return model_params_to_reference(grads, model)


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
    step, m, v = opt_state
    return OptState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
        m={n: leaf_tensor(reference_leaf(m, n), dev) for n in names},
        v={n: leaf_tensor(reference_leaf(v, n), dev) for n in names},
    )
