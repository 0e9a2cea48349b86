"""Wrappers around the hand-written CUDA kernels.

The device decides the path: tensors on the CPU go to the plain PyTorch
version in ``ref``; tensors on one CUDA device go to the kernel, and
anything the kernel does not take raises. There is no fallback from the
kernel to the plain version. Each wrapper counts its kernel launches in a
plain int attribute, ``<wrapper>.launches``, so a run can show that its
main path went through the kernels (``reset_launch_counts`` zeroes them).

Unlike the TPU wrappers, nothing is padded here: the kernels mask ragged
edges themselves.
"""
from __future__ import annotations

import threading

import torch

from . import build, ref

MAX_RANK = 128  # largest k the MU kernels take (nmf_update.cu kMaxRank)
MAX_CLUSTERS = 128  # largest k the distance-sum kernel takes (silhouette_sums.cu)
MAX_LANES = 65535  # grid limit on the lane axis (pairwise_dist.cu)
MAX_PAIRWISE_COLS = 65535 * 32  # grid limit on m (pairwise_dist.cu: 32 y rows per block)

_count_lock = threading.Lock()


def _on_card(*tensors: torch.Tensor) -> bool:
    """False for all-CPU tensors (plain path); True for one CUDA device after
    checking what the kernels take; raises for anything else."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"tensors must all lie on the CPU or all on one CUDA device, got {devices}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    return True


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _lead3(*tensors: torch.Tensor) -> tuple[bool, list[torch.Tensor]]:
    """2-D operands become one-lane 3-D ones; returns (was_2d, operands)."""
    ndims = {t.dim() for t in tensors}
    if ndims == {2}:
        return True, [t.unsqueeze(0) for t in tensors]
    if ndims == {3}:
        return False, list(tensors)
    raise ValueError(f"expected all 2-D or all 3-D operands, got dims {sorted(ndims)}")


def _mu_shapes(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> tuple[int, int, int, int]:
    lanes, n, m = v.shape
    k = w.shape[-1]
    if w.shape != (lanes, n, k) or h.shape != (lanes, k, m):
        raise ValueError(f"MU shapes v {tuple(v.shape)}, w {tuple(w.shape)}, h {tuple(h.shape)} do not match")
    if not 1 <= k <= MAX_RANK:
        raise ValueError(f"the MU kernels take 1 <= k <= {MAX_RANK}, got k={k}")
    return lanes, n, m, k


# -----------------------------------------------------------------------------
# NMF multiplicative updates (csrc/nmf_update.cu)
# -----------------------------------------------------------------------------
def mu_update_h(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """H <- H * (W^T V) / (G H + 1e-9), G = W^T W; v (L, n, m) or (n, m)."""
    if not _on_card(v, w, h):
        return ref.mu_update_h(v, w, h)
    was_2d, (v3, w3, h3) = _lead3(v, w, h)
    lanes, n, m, k = _mu_shapes(v3, w3, h3)
    g = torch.bmm(w3.transpose(1, 2), w3)
    out = torch.empty_like(h3)
    lib = build.load("nmf_update")
    rc = lib.mu_update_h(
        v3.data_ptr(), w3.data_ptr(), h3.data_ptr(), g.data_ptr(), out.data_ptr(),
        lanes, n, m, k, _stream(v3),
    )
    _check(rc, "mu_update_h")
    _count(mu_update_h)
    return out[0] if was_2d else out


def mu_update_w(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """W <- W * (V H^T) / (W Q + 1e-9), Q = H H^T; v (L, n, m) or (n, m)."""
    if not _on_card(v, w, h):
        return ref.mu_update_w(v, w, h)
    was_2d, (v3, w3, h3) = _lead3(v, w, h)
    lanes, n, m, k = _mu_shapes(v3, w3, h3)
    q = torch.bmm(h3, h3.transpose(1, 2))
    out = torch.empty_like(w3)
    lib = build.load("nmf_update")
    rc = lib.mu_update_w(
        v3.data_ptr(), h3.data_ptr(), w3.data_ptr(), q.data_ptr(), out.data_ptr(),
        lanes, n, m, k, _stream(v3),
    )
    _check(rc, "mu_update_w")
    _count(mu_update_w)
    return out[0] if was_2d else out


# -----------------------------------------------------------------------------
# Streaming silhouette distance sums (csrc/silhouette_sums.cu)
# -----------------------------------------------------------------------------
def _dist_sums_launch(x: torch.Tensor, y: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    b, n, d = x.shape
    _, m, k = onehot.shape
    if y.shape != (b, m, d) or onehot.shape[0] != b:
        raise ValueError(
            f"dist-sum shapes x {tuple(x.shape)}, y {tuple(y.shape)}, onehot {tuple(onehot.shape)} do not match"
        )
    if not 1 <= k <= MAX_CLUSTERS:
        raise ValueError(f"the distance-sum kernel takes 1 <= k <= {MAX_CLUSTERS}, got k={k}")
    out = torch.empty((b, n, k), device=x.device, dtype=torch.float32)
    lib = build.load("silhouette_sums")
    rc = lib.silhouette_dist_sums(
        x.data_ptr(), y.data_ptr(), onehot.data_ptr(), out.data_ptr(),
        b, n, m, d, k, _stream(x),
    )
    _check(rc, "silhouette_dist_sums")
    return out


def silhouette_dist_sums(
    x: torch.Tensor, onehot: torch.Tensor, y: torch.Tensor | None = None
) -> torch.Tensor:
    """(n, k) sums ``sqrt(pairwise(x, y)) @ onehot``; x (n, d), y (m, d) (default x), onehot (m, k)."""
    y = x if y is None else y
    if not _on_card(x, y, onehot):
        return ref.silhouette_dist_sums(x, onehot, y)
    if not x.dim() == y.dim() == onehot.dim() == 2:
        raise ValueError("silhouette_dist_sums takes 2-D operands; use the _batched entry for 3-D")
    out = _dist_sums_launch(x.unsqueeze(0), y.unsqueeze(0), onehot.unsqueeze(0))
    _count(silhouette_dist_sums)
    return out[0]


def silhouette_dist_sums_batched(
    x: torch.Tensor, onehot: torch.Tensor, y: torch.Tensor | None = None
) -> torch.Tensor:
    """Leading-lane form: x (b, n, d), y (b, m, d) (default x), onehot (b, m, k) -> (b, n, k)."""
    y = x if y is None else y
    if not _on_card(x, y, onehot):
        return ref.silhouette_dist_sums(x, onehot, y)
    if not x.dim() == y.dim() == onehot.dim() == 3:
        raise ValueError("silhouette_dist_sums_batched takes 3-D operands")
    out = _dist_sums_launch(x, y, onehot)
    _count(silhouette_dist_sums_batched)
    return out


# -----------------------------------------------------------------------------
# Pairwise squared distances (csrc/pairwise_dist.cu)
# -----------------------------------------------------------------------------
def _pairwise_launch(x: torch.Tensor, y: torch.Tensor, lanes: int) -> torch.Tensor:
    """out (lanes, n, m); a 2-D operand is shared by every lane (lane stride 0)."""
    n, d = x.shape[-2:]
    m = y.shape[-2]
    if y.shape[-1] != d or min(n, m, d) < 1:
        raise ValueError(f"pairwise shapes x {tuple(x.shape)}, y {tuple(y.shape)} do not match")
    if not 1 <= lanes <= MAX_LANES or m > MAX_PAIRWISE_COLS:
        raise ValueError(f"the pairwise kernel takes <= {MAX_LANES} lanes and m <= {MAX_PAIRWISE_COLS}")
    out = torch.empty((lanes, n, m), device=x.device, dtype=torch.float32)
    lib = build.load("pairwise_dist")
    rc = lib.pairwise_sq_dists(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), lanes, n, m, d,
        n * d if x.dim() == 3 else 0, m * d if y.dim() == 3 else 0, _stream(x),
    )
    _check(rc, "pairwise_sq_dists")
    return out


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """(n, m) ``max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0)``; x (n, d), y (m, d) (default x)."""
    y = x if y is None else y
    if not _on_card(x, y):
        return ref.pairwise_sq_dists(x, y)
    if not x.dim() == y.dim() == 2:
        raise ValueError("pairwise_sq_dists takes 2-D operands; use the _batched entry for 3-D")
    out = _pairwise_launch(x, y, 1)
    _count(pairwise_sq_dists)
    return out[0]


def pairwise_sq_dists_batched(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """Leading-lane form -> (b, n, m): x (b, n, d), y (b, m, d) (default x).

    One operand may be 2-D, (n, d) or (m, d): it is shared by every lane and
    read once, never copied per lane.
    """
    y = x if y is None else y
    if not _on_card(x, y):
        return ref.pairwise_sq_dists(x, y)
    dims = (x.dim(), y.dim())
    if dims not in ((3, 3), (2, 3), (3, 2)) or (dims == (3, 3) and x.shape[0] != y.shape[0]):
        raise ValueError(
            f"pairwise_sq_dists_batched takes 3-D operands with one lane count (one may be 2-D), "
            f"got x {tuple(x.shape)}, y {tuple(y.shape)}"
        )
    out = _pairwise_launch(x, y, (x if x.dim() == 3 else y).shape[0])
    _count(pairwise_sq_dists_batched)
    return out


KERNEL_WRAPPERS = (
    mu_update_h, mu_update_w, silhouette_dist_sums, silhouette_dist_sums_batched,
    pairwise_sq_dists, pairwise_sq_dists_batched,
)
for _wrapper in KERNEL_WRAPPERS:
    _wrapper.launches = 0


def reset_launch_counts() -> None:
    with _count_lock:
        for wrapper in KERNEL_WRAPPERS:
            wrapper.launches = 0


def launch_counts() -> dict[str, int]:
    with _count_lock:
        return {wrapper.__name__: wrapper.launches for wrapper in KERNEL_WRAPPERS}
