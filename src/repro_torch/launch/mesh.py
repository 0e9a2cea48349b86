"""Process meshes: the k-search's sharded planes' ``(lane, data)`` mesh,
the distributed-fit executor's per-worker groups, and the LM's ``(data,
model)`` mesh with its axis environment (``make_lm_mesh``, ``make_axes``,
``dp_size``).

``make_wave_mesh`` builds the 2-D ``(lane, data)`` ``DeviceMesh`` the
sharded wavefront planes run on. The port is SPMD over processes: one
process per rank (``torchrun``), every rank running the whole search, each
computing only its own lane block of a dispatch and, with ``data > 1``, its
own row block of V. The mesh spans the whole world (``lanes × data ==
world size``): a rank left out of it would wait forever on the scheduler's
collectives.

``SubmeshPool`` leases per-worker process groups to the threaded
distributed-fit executor: each worker keeps ONE group for its lifetime —
a group is a worker-identity resource, not a function of the k being
evaluated.

``make_lm_mesh`` builds the LM's ``(data, model)`` mesh the same way, over
the whole world, or with ``pod`` above 1 the reference's multi-pod ``(pod,
data, model)`` mesh: each rank holds a block of the batch (over ``data``,
or the pod × data ranks) and of the parameters and caches (``model``;
``models.layers`` says how). ``apply_fsdp`` widens the parameter specs
over ``data`` as the reference's does (``models.transformer.Model`` places
and gathers by the widened specs). ``make_production_mesh`` is the
reference's 16 × 16 or 2 × 16 × 16 mesh, and ``named`` pairs a spec tree
with a mesh, for the dry run (``launch.dryrun``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import threading
from pathlib import Path
from typing import Any, Iterator, Sequence

import torch
import torch.distributed as dist

from repro_torch.factorization.distributed import backend_for
from repro_torch.models.layers import P, Axes, block_shape

LANE, POD, DATA, MODEL = "lane", "pod", "data", "model"

# default groups made from torchrun's environment in this process: each gets
# its own key space in the launcher's store, which outlives the groups it
# served (a second group under the first one's keys would meet its stale
# addresses). Every rank makes its meshes in the same order, so the counts agree.
_env_groups = 0


@dataclasses.dataclass(frozen=True)
class WaveMesh:
    """This rank's view of a ``(lane, data)`` mesh.

    ``lane_group`` holds the ranks that share this rank's data index (one
    per lane block: scores and retired factors are gathered over it);
    ``data_group`` holds the ranks that share its lane block (one per row
    block of V: the fits' Gram sums are reduced over it). ``lane_index`` /
    ``data_index`` are this rank's coordinates, which are also its ranks
    within those two groups.
    """

    mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    lane_group: Any
    data_group: Any
    lane_index: int
    data_index: int
    lane_count: int
    data_count: int
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return {LANE: self.lane_count, DATA: self.data_count}


def _mesh_device(device: torch.device | str) -> torch.device:
    """The device this rank runs on: the CPU, or ``cuda:{LOCAL_RANK}`` for a
    ``cuda`` device without an index (``torchrun`` sets ``LOCAL_RANK``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def _mesh_shape(world: int, lanes: int | None, data: int) -> tuple[int, int]:
    if data < 1:
        raise ValueError(f"data must be >= 1, got {data}")
    if lanes is None:
        if world % data:
            raise ValueError(f"{world} ranks do not split into data={data} shards")
        lanes = world // data
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    need = lanes * data
    if need > world:
        raise ValueError(f"mesh ({lanes} lanes x {data} data) needs {need} ranks, have {world}")
    if need != world:
        raise ValueError(f"mesh ({lanes} lanes x {data} data) must span all {world} ranks: "
                         "a rank outside it would wait on the search's collectives")
    return lanes, data


def _check_group(group, size: int, dev: torch.device) -> None:
    """One all-reduce over ``group``, which must sum ``size`` ones (skipped
    on a ``fake`` group, whose collectives move nothing)."""
    if str(dist.get_backend()) == "fake":
        return
    probe = torch.ones((), device=dev)
    dist.all_reduce(probe, group=group)
    if int(probe.item()) != size or dist.get_world_size(group) != size:
        raise RuntimeError(f"mesh group of {dist.get_world_size(group)} ranks summed {probe.item()}, want {size}")


@contextlib.contextmanager
def _process_mesh(names: tuple[str, ...], shape, device: torch.device | str):
    """(DeviceMesh, its groups, this rank's coordinates, the shape, device)
    of a mesh over the ranks of the default process group, one group and
    coordinate a name of ``names``; ``shape(world)`` returns the mesh's
    shape or raises. Makes the default group if there is none (see
    ``make_wave_mesh``), checks each group with one all-reduce (not on a
    ``fake`` group, whose collectives move nothing), and destroys what it
    made on exit."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = _mesh_device(device)
    backend = backend_for(dev)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))
        if cards < ranks_here or dev.index >= cards:
            raise RuntimeError(f"a mesh on cuda needs a card for each of the {ranks_here} ranks on this host "
                               f"(rank on {dev}); {cards} visible")
        torch.cuda.set_device(dev)
    store = None
    made_default = not dist.is_initialized()
    if made_default:
        if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
            global _env_groups
            _env_groups += 1
            env_store, rank, world = next(dist.rendezvous("env://"))
            dist.init_process_group(backend, store=dist.PrefixStore(f"repro_torch_mesh_{_env_groups}", env_store),
                                    rank=rank, world_size=world)
        else:
            store = tempfile.TemporaryDirectory(prefix="repro_torch_pg_")
            dist.init_process_group(backend, init_method=(Path(store.name) / "store").as_uri(),
                                    world_size=1, rank=0)
    made: list = []
    try:
        fake = str(dist.get_backend()) == "fake"
        if str(dist.get_backend()) != backend and not fake:
            raise ValueError(f"a mesh on {dev} needs a {backend} default group, got {dist.get_backend()}")
        dims = shape(dist.get_world_size())
        mesh = init_device_mesh(dev.type, dims, mesh_dim_names=names)
        groups = [mesh.get_group(n) for n in names]
        made = [g for g in groups if g is not dist.group.WORLD]
        coords = [mesh.get_local_rank(n) for n in names]
        for group, size in zip(groups, dims):
            _check_group(group, size, dev)
        if [dist.get_rank(g) for g in groups] != coords:
            raise RuntimeError("mesh coordinates differ from the ranks within the mesh's groups")
        yield mesh, groups, coords, dims, dev, made
    finally:
        if made_default:
            dist.destroy_process_group()
            if store is not None:
                store.cleanup()
        else:
            for group in {id(g): g for g in made}.values():
                dist.destroy_process_group(group)


@contextlib.contextmanager
def make_wave_mesh(
    lanes: int | None = None, data: int = 1, device: torch.device | str = "cuda"
) -> Iterator[WaveMesh]:
    """2-D ``(lane, data)`` mesh over the ranks of the default process group.

    ``lanes`` parallel k-fits, each distributed over ``data`` ranks; with
    ``lanes=None`` every rank not taken by ``data`` becomes a lane. Raises
    if ``data`` or ``lanes`` is below 1, the world does not split into
    ``data``, or ``lanes × data`` is not the world size, and on ``cuda``
    when fewer cards are visible than ranks on this host.

    Without a default group one is made here: from ``torchrun``'s
    environment (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) if it is set,
    else a one-rank group on a ``file://`` store in a temporary directory.
    The backend is the device's (NCCL on CUDA, gloo on the CPU). On exit the
    context destroys what it made and nothing else: the default group if it
    made it (with every subgroup), else the mesh's own subgroups. Before
    yielding, one all-reduce over each of the two groups checks their sizes.
    """
    with _process_mesh((LANE, DATA), lambda world: _mesh_shape(world, lanes, data), device) as made:
        mesh, (lane_group, data_group), (lane_index, data_index), (n_lanes, n_data), dev, _ = made
        yield WaveMesh(mesh, lane_group, data_group, lane_index, data_index, n_lanes, n_data, dev)


@dataclasses.dataclass(frozen=True)
class LMMesh:
    """This rank's view of the LM's ``(data, model)`` mesh, or with ``pod``
    ranks above 1 its ``(pod, data, model)`` mesh.

    ``model_group`` holds the ranks that share this rank's pod and data
    indices (they hold the blocks of one copy of the model and sum their
    partial products); ``data_group`` holds the ranks that share its pod and
    model indices (FSDP cuts the parameters over them); ``pod_group`` those
    that share its data and model indices (None on one pod); ``dp_group``
    those that share its model index, pod-major (the batch is cut over
    them; the data group on one pod). ``pod_index`` / ``data_index`` /
    ``model_index`` are this rank's coordinates, which are also its ranks
    within the pod, data and model groups.
    """

    mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    data_group: Any
    model_group: Any
    data_index: int
    model_index: int
    data_count: int
    model_count: int
    device: torch.device
    dp_group: Any
    pod_group: Any = None
    pod_index: int = 0
    pod_count: int = 1

    @property
    def shape(self) -> dict[str, int]:
        pod = {POD: self.pod_count} if self.pod_count > 1 else {}
        return {**pod, DATA: self.data_count, MODEL: self.model_count}


def _lm_shape(world: int, data: int, model: int, pod: int = 1) -> tuple[int, ...]:
    if data < 1 or model < 1 or pod < 1:
        raise ValueError(f"pod, data and model must be >= 1, got {pod}, {data} and {model}")
    if pod * data * model != world:
        raise ValueError(f"mesh ({pod} pod x {data} data x {model} model) needs {pod * data * model} ranks and "
                         f"must span all {world}: a rank outside it would wait on the model's collectives")
    return (pod, data, model) if pod > 1 else (data, model)


@contextlib.contextmanager
def make_lm_mesh(data: int = 1, model: int = 1, device: torch.device | str = "cuda", pod: int = 1
                 ) -> Iterator[LMMesh]:
    """``(data, model)`` mesh over the ranks of the default process group, or
    ``(pod, data, model)`` with ``pod`` above 1, as ``make_wave_mesh`` makes
    its mesh (the default group made here if there is none, checked,
    destroyed on exit). ``pod × data × model`` must be the world size; on
    ``cuda`` each rank on this host needs its own card. Over a ``fake``
    default group (``torch.testing._internal.distributed.fake_pg``) the
    mesh is this rank's coordinates and groups, whose collectives move
    nothing: what the dry run (``launch.dryrun``) places a step on."""
    names = (POD, DATA, MODEL) if pod > 1 else (DATA, MODEL)
    with _process_mesh(names, lambda world: _lm_shape(world, data, model, pod), device) as made:
        mesh, groups, coords, dims, dev, subgroups = made
        if pod == 1:
            (data_group, model_group), (data_index, model_index) = groups, coords
            yield LMMesh(mesh, data_group, model_group, data_index, model_index, data, model, dev, data_group)
            return
        (pod_group, data_group, model_group), (pod_index, data_index, model_index) = groups, coords
        # the pod x data ranks of each model index, pod-major: every rank makes every group
        ranks = mesh.mesh.reshape(pod * data, model).T.tolist()
        dp_group, _ = dist.new_subgroups_by_enumeration(ranks)
        subgroups.append(dp_group)
        _check_group(dp_group, pod * data, dev)
        yield LMMesh(mesh, data_group, model_group, data_index, model_index, data, model, dev, dp_group,
                     pod_group=pod_group, pod_index=pod_index, pod_count=pod)


def make_production_mesh(multi_pod: bool = False, device: torch.device | str = "cuda"):
    """The reference's production mesh, by way of ``make_lm_mesh``: ``(data
    16, model 16)``, or ``(pod 2, data 16, model 16)`` with ``multi_pod``.
    Over real ranks it needs 256 or 512 processes; the dry run makes it
    over a ``fake`` default group of that many ranks, at rank 0."""
    return make_lm_mesh(16, 16, device, pod=2 if multi_pod else 1)


def make_axes(mesh: LMMesh, global_batch: int | None = None) -> Axes:
    """Axis environment for a mesh; drops batch sharding when the global
    batch can't shard evenly (long_500k's batch=1)."""
    batch_axes = tuple(n for n in (POD, DATA) if n in mesh.shape)
    if global_batch is not None and global_batch % dp_size(mesh) != 0:
        batch_axes = ()
    return Axes(batch=batch_axes, model=MODEL, model_size=mesh.shape[MODEL])


def dp_size(mesh: LMMesh) -> int:
    dp = 1
    for n in (POD, DATA):
        dp *= mesh.shape.get(n, 1)
    return dp


def apply_fsdp(specs, shapes, fsdp_axis: str = DATA, fsdp_size: int = 16, min_elems: int = 1 << 22):
    """Widen param specs with FSDP sharding over ``fsdp_axis``, the
    reference's rule: a leaf of at least ``min_elems`` elements takes the
    axis on its largest dimension whose spec entry is ``None`` and whose
    size ``fsdp_size`` divides, never dimension 0 of a leaf of three or more
    dimensions (a stacked segment's repeat axis). ``specs`` is a nested dict
    of ``P``; ``shapes`` the same tree of shapes (the reference's stacked
    shapes: ``Model.param_shapes``)."""

    def widen(spec: P, shape) -> P:
        shape = tuple(shape)
        if len(shape) != len(spec):
            return spec
        n = 1
        for size in shape:
            n *= size
        if n < min_elems:
            return spec
        entries = list(spec)
        start = 1 if len(shape) >= 3 else 0
        for i in sorted(range(start, len(shape)), key=lambda i: -shape[i]):
            if entries[i] is None and shape[i] % fsdp_size == 0:
                entries[i] = fsdp_axis
                return P(*entries)
        return spec

    if isinstance(specs, P):
        return widen(specs, shapes)
    return {k: apply_fsdp(v, shapes[k], fsdp_axis, fsdp_size, min_elems) for k, v in specs.items()}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's spec paired with an LM mesh: the port's counterpart of
    ``jax.sharding.NamedSharding``, for what the dry run asks of one."""

    mesh: LMMesh
    spec: P

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        """The shape of the block a rank holds of a leaf of ``global_shape``
        (``layers.block_shape``, the rule ``Shard.cut`` cuts by)."""
        return block_shape(global_shape, self.spec, self.mesh.shape)


def named(mesh: LMMesh, specs):
    """``specs`` (a nested dict, list or NamedTuple of ``P``) with each spec
    paired with ``mesh`` as a ``NamedSharding``."""
    if isinstance(specs, P):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: named(mesh, v) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(named(mesh, v) for v in specs))
    return type(specs)(named(mesh, v) for v in specs)


class SubmeshPool:
    """Lease one process group per *worker* for the threaded distributed-fit path.

    The executor's workers are threads that each run one k-evaluation at a
    time on a dedicated group; the evaluate closure only sees the k, so the
    pool keys the lease on ``threading.get_ident()``. First touch assigns
    the next group round-robin; every later call from the same worker
    returns the same group. (Keying on k instead — e.g. ``groups[k % n]`` —
    lands two concurrent workers on the same group whenever their ks
    collide mod n, serializing the fits the groups exist to parallelize.)
    """

    def __init__(self, submeshes: Sequence[Any]):
        if not submeshes:
            raise ValueError("SubmeshPool needs at least one group")
        self.submeshes = list(submeshes)
        self._lock = threading.Lock()
        self._assign: dict[int, Any] = {}

    def acquire(self) -> Any:
        """The calling worker's group (assigned on first touch)."""
        ident = threading.get_ident()
        with self._lock:
            group = self._assign.get(ident)
            if group is None:
                group = self.submeshes[len(self._assign) % len(self.submeshes)]
                self._assign[ident] = group
            return group

    def assignments(self) -> dict[int, int]:
        """thread ident -> group index (introspection for tests/traces)."""
        with self._lock:
            index = {id(g): i for i, g in enumerate(self.submeshes)}
            return {t: index[id(g)] for t, g in self._assign.items()}
