"""Fault-tolerant checkpointing: atomic, manifest-verified, async-capable.

Layout per step, the reference's:
    <root>/step_00000123.tmp/...   (write)
    <root>/step_00000123/          (atomic rename on completion)
        manifest.json            {step, keys, leaves: file, shape, dtype, bytes}
        arr_00000.npy ...        one file per leaf: its raw bytes as uint8

A tree is nested ``nn.Module``s (their ``named_parameters()``), mappings,
tuples, lists and ``OptState``-like named tuples over tensor leaves. The
reference's manifest records a jax ``treedef`` string; the port records
``keys``, the flattened key paths of its tree (``0.embed.table``,
``1.m.embed.table``, ...), and ``restore`` checks them as well as the byte
counts.

Restore picks the newest COMPLETE checkpoint (manifest present and every
leaf file there), so a writer killed mid-save never corrupts restart
state. ``AsyncCheckpointer`` saves on a worker thread from host copies
made at submit, with a queue of depth 1 (the latest state wins).

On a mesh (``placement``: ``train.train_step.StatePlacement``) a
checkpoint is the one-card checkpoint of the whole tree, as the
reference's ``np.asarray`` of a sharded leaf is the whole leaf: the same
manifest, key paths and one file a whole leaf. Every rank joins each leaf
in turn (collectives, on the leaves' device); the writer (global rank 0)
alone keeps the host copies, writes and publishes. ``restore`` reads each
whole leaf's file mapped (``mmap_mode``) and copies only this rank's block
of it to the device, so a checkpoint of one mesh shape restores at
another, or on one card.
"""
from __future__ import annotations

import copy
import json
import os
import queue
import shutil
import threading
import warnings
from typing import Any, Protocol

import numpy as np
import torch
from torch import nn

Tree = Any


def _items(tree: Tree) -> list[tuple[str, Any]]:
    """A container's children by key, or [] for a leaf."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return []


def _flatten(tree: Tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(key path, tensor) of every leaf, depth first in container order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    children = _items(tree)
    if not children and not isinstance(tree, (nn.Module, dict, tuple, list)):
        raise TypeError(f"checkpoint leaf {prefix or '<root>'} is a {type(tree).__name__}, not a tensor")
    out = []
    for k, v in children:
        out.extend(_flatten(v, f"{prefix}.{k}" if prefix else k))
    return out


def _rebuild(tree: Tree, leaves: dict[str, torch.Tensor], prefix: str = "") -> Tree:
    """``tree``'s structure over the tensors of ``leaves`` (by key path). A
    module comes back as a copy whose parameters hold the new tensors."""
    if isinstance(tree, torch.Tensor):
        return leaves[prefix]
    if isinstance(tree, nn.Module):
        memo = {id(p): nn.Parameter(leaves[f"{prefix}.{k}" if prefix else k], requires_grad=p.requires_grad)
                for k, p in tree.named_parameters()}
        return copy.deepcopy(tree, memo)
    kids = {k: _rebuild(v, leaves, f"{prefix}.{k}" if prefix else k) for k, v in _items(tree)}
    if isinstance(tree, dict):
        return type(tree)((k, kids[str(k)]) for k in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**kids)
    return type(tree)(kids[str(i)] for i in range(len(tree)))


class Placement(Protocol):
    """How a tree's leaves lie on a mesh, by key path: ``join`` (a collective
    every rank calls in the same order) gives the whole tensor of a rank's
    block, ``cut`` the rank's block of a whole one, ``whole_shape`` the
    shape of the whole; ``writer`` is the one rank that writes."""

    writer: bool

    def join(self, key: str, block: torch.Tensor) -> torch.Tensor: ...

    def cut(self, key: str, whole: torch.Tensor) -> torch.Tensor: ...

    def whole_shape(self, key: str, block: torch.Tensor) -> tuple[int, ...]: ...

    def barrier(self) -> None: ...


def _raw(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes on the host, as a flat uint8 array."""
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()


def _joined(tree: Tree, placement: Placement | None):
    """(key path, whole leaf) of every leaf of ``tree``, in order: with a
    ``placement`` each joined in turn, when it is reached (on every rank)."""
    for key, leaf in _flatten(tree):
        yield key, leaf.detach() if placement is None else placement.join(key, leaf.detach())


def _host_leaves(tree: Tree, placement: Placement | None) -> list[tuple[str, torch.Tensor]] | None:
    """(key path, host copy of the whole leaf) of every leaf of ``tree``, kept
    by the writer alone (None elsewhere, after the same joins). Never an
    alias: training updates its tensors in place."""
    keep = placement is None or placement.writer
    out = [(key, whole.to("cpu", copy=True)) for key, whole in _joined(tree, placement) if keep]
    return out if keep else None


def _write(root: str, step: int, leaves) -> str:
    """Write ``leaves`` ((key path, tensor), in order) as step ``step`` and publish it atomically."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "keys": [], "leaves": []}
    for i, (key, leaf) in enumerate(leaves):
        # raw bytes: numpy has no bfloat16
        np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), _raw(leaf))
        manifest["keys"].append(key)
        manifest["leaves"].append(
            {"file": f"arr_{i:05d}.npy", "shape": list(leaf.shape), "dtype": str(leaf.dtype).removeprefix("torch."),
             "bytes": leaf.numel() * leaf.element_size()}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    return final


def save(root: str, step: int, tree: Tree, placement: Placement | None = None) -> str:
    """Blocking atomic save, one leaf at a time. Returns the final directory.
    ``placement``: the tree holds this rank's blocks of a mesh; every rank
    calls it, the writer writes the whole leaves, and all return once they
    are published."""
    leaves = _joined(tree, placement)
    if placement is None or placement.writer:
        final = _write(root, step, leaves)
    else:
        final = os.path.join(root, f"step_{step:08d}")
        for _ in leaves:  # this rank's part of each join
            pass
    if placement is not None:
        placement.barrier()
    return final


def _is_complete(d: str) -> bool:
    man = os.path.join(d, "manifest.json")
    if not os.path.exists(man):
        return False
    try:
        with open(man) as f:
            m = json.load(f)
        return all(os.path.exists(os.path.join(d, leaf["file"])) for leaf in m["leaves"])
    except (json.JSONDecodeError, KeyError, OSError):
        return False


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if _is_complete(os.path.join(root, name)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(root: str, like: Tree, step: int | None = None,
            placement: Placement | None = None) -> tuple[Tree, int]:
    """Restore into the structure of ``like``: the same key paths, and each
    leaf's bytes for its shape and dtype; the tensors land on the devices of
    ``like``'s leaves. ``like`` itself is left as it was. ``placement``:
    ``like`` holds this rank's blocks of a mesh; each file holds the whole
    leaf (its bytes checked against the whole shape), and only the rank's
    block of it is read and copied."""
    step = step if step is not None else latest_step(root)
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(like)
    keys = [k for k, _ in flat]
    if manifest["keys"] != keys:
        missing = sorted(set(keys) - set(manifest["keys"]))
        extra = sorted(set(manifest["keys"]) - set(keys))
        raise ValueError(f"checkpoint key paths differ from the tree's: missing {missing[:5]}, "
                         f"unexpected {extra[:5]} ({len(missing)} and {len(extra)} in all)")
    out = {}
    for i, (key, want) in enumerate(flat):
        raw = np.load(os.path.join(d, f"arr_{i:05d}.npy"), mmap_mode="r")
        shape = tuple(want.shape) if placement is None else placement.whole_shape(key, want)
        n_bytes = int(np.prod(shape, dtype=np.int64)) * want.element_size()
        if raw.nbytes != n_bytes:
            raise ValueError(
                f"leaf {key}: checkpoint has {raw.nbytes} bytes, expected "
                f"{n_bytes} for shape {shape} {want.dtype}"
            )
        with warnings.catch_warnings():  # the mapping is read-only, and only read
            warnings.simplefilter("ignore", UserWarning)
            whole = torch.from_numpy(raw).view(want.dtype).reshape(shape)
        block = whole if placement is None else placement.cut(key, whole)
        out[key] = torch.empty(want.shape, dtype=want.dtype, device=want.device).copy_(block)
    return _rebuild(like, out), step


def prune_old(root: str, keep: int = 3) -> None:
    if not os.path.isdir(root):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(root)
        if n.startswith("step_") and not n.endswith(".tmp")
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread saver with a bounded queue (depth 1: latest wins).
    A save's error is raised on the next ``submit`` or on ``close``.
    ``placement``: the trees hold this rank's blocks of a mesh (``save``);
    every rank submits at the same steps and closes, and ``close`` ends in
    a barrier, after the writer's last save is published."""

    def __init__(self, root: str, keep: int = 3, placement: Placement | None = None):
        self.root = root
        self.keep = keep
        self.placement = placement
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, flat = item
            try:
                _write(self.root, step, flat)
                prune_old(self.root, self.keep)
            except Exception as e:  # surfaced on the next submit/close
                self._err = e

    def submit(self, step: int, tree: Tree) -> None:
        if self._err:
            raise self._err
        # copy every leaf to the host BEFORE queuing
        flat = _host_leaves(tree, self.placement)
        if flat is None:  # not the writer
            return
        try:
            self._q.put_nowait((step, flat))
        except queue.Full:
            # drop the older pending save — latest state wins
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._q.put_nowait((step, flat))

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=60)
        if self.placement is not None:
            self.placement.barrier()
        if self._err:
            raise self._err
