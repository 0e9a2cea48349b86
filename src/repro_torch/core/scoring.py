"""Cluster-quality scoring in PyTorch.

The paper pairs Binary Bleed with:
  * silhouette score (maximize) — NMFk stability scoring,
  * Davies-Bouldin index (minimize) — K-Means.

Both reduce all-pairs distances, the T_scorer hot spot. On the card the
distances are hand-written CUDA kernels (``repro_torch.kernels.ops``); on
the CPU they are the kernels' plain versions:

  * ``pairwise_sq_dists``: a 2-D pair goes to the 2-D kernel, a 3-D pair or
    a 2-D operand shared against a 3-D one to the batched kernel, which
    reads the shared operand once.
  * ``cluster_dist_sums``: the silhouette only ever consumes the (n, n)
    distance matrix through one contraction, ``sqrt(D2) @ onehot``. On the
    card that is the streaming kernel, which never writes the distance
    matrix. On the CPU small problems take the dense tier and anything past
    ``_DENSE_MAX_ELEMENTS`` per lane the row-blocked tier.

``square_wave_score``, ``laplacian_score`` and ``noisy`` are the §III-D
synthetic score models the search-layer tests drive.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as kernel_ref
from repro_torch.random import lane_generator


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """Squared euclidean distances between rows of x (..., n, d) and y (..., m, d).

    On the CPU leading batch axes broadcast through the plain version. On
    the card a 2-D pair goes to the 2-D kernel; a 3-D pair, or a 2-D operand
    shared against a 3-D one, to the batched kernel.
    """
    y = x if y is None else y
    if _on_cpu(x, y):
        return kernel_ref.pairwise_sq_dists(x, y)
    if x.dim() == y.dim() == 2:
        return kernel_ops.pairwise_sq_dists(x, y)
    if {x.dim(), y.dim()} <= {2, 3}:
        return kernel_ops.pairwise_sq_dists_batched(x, y)
    raise ValueError(f"the kernel path takes 2-D or 3-D operands, got {x.dim()}-D and {y.dim()}-D")


# Dense-tier ceiling on the CPU: largest per-lane (n, n) distance block the
# dense tier may materialize (fp32 elements; 2048^2 = 16 MiB). Above it,
# row-blocking.
_DENSE_MAX_ELEMENTS = 2048 * 2048
_DEFAULT_BLOCK_ROWS = 512


def _cluster_dist_sums_blocked(x: torch.Tensor, onehot: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Row-blocked ``sqrt(pairwise) @ onehot``: each (block_rows, n) distance
    strip is contracted to (block_rows, k) and freed, so the peak footprint
    is O(block_rows * n) whatever n. x (..., n, d), onehot (..., n, k)."""
    n = x.shape[-2]
    strips = [
        torch.matmul(torch.sqrt(pairwise_sq_dists(x[..., i : i + block_rows, :], x)), onehot)
        for i in range(0, n, block_rows)
    ]
    return torch.cat(strips, dim=-2)


def cluster_dist_sums(
    x: torch.Tensor, onehot: torch.Tensor, block_rows: int | None = None
) -> torch.Tensor:
    """(…, n, k) sums of sqrt distances from every point to every cluster.

    ``out[..., i, c] = sum_j sqrt(||x_i - x_j||^2) * onehot[..., j, c]``.
    Masked points carry zero one-hot rows and contract to nothing.

    On the card a 2-D problem goes to the 2-D streaming kernel and a 3-D one
    to its batched entry; an unbatched x against a batched one-hot is
    broadcast first, and ``block_rows`` is not read. On the CPU the dense
    tier serves n * n <= ``_DENSE_MAX_ELEMENTS`` and the blocked tier the
    rest; passing ``block_rows`` forces the blocked tier at that strip height.

    bf16 inputs give fp32 sums on every route, as the TPU kernel writes
    them: on the card through the kernels' bf16 half, on the CPU from the
    upcast operands.
    """
    if _on_cpu(x, onehot):
        ct = torch.promote_types(x.dtype, torch.float32)
        x, onehot = x.to(ct), onehot.to(ct)
        n = x.shape[-2]
        if block_rows is None and n * n <= _DENSE_MAX_ELEMENTS:
            return torch.matmul(torch.sqrt(pairwise_sq_dists(x)), onehot)
        return _cluster_dist_sums_blocked(x, onehot, block_rows or _DEFAULT_BLOCK_ROWS)
    if x.dim() == onehot.dim() - 1:
        x = x.expand(onehot.shape[:-2] + x.shape[-2:]).contiguous()
    elif onehot.dim() == x.dim() - 1:
        onehot = onehot.expand(x.shape[:-2] + onehot.shape[-2:]).contiguous()
    if x.dim() == 2:
        return kernel_ops.silhouette_dist_sums(x, onehot)
    if x.dim() == 3:
        return kernel_ops.silhouette_dist_sums_batched(x, onehot)
    raise ValueError(f"cluster_dist_sums takes 2-D or 3-D inputs, got {x.dim()}-D")


def _one_hot(labels: torch.Tensor, num_clusters: int, dtype) -> torch.Tensor:
    """(..., num_clusters) one-hot rows of ``dtype``, written once."""
    out = torch.zeros(labels.shape + (num_clusters,), dtype=dtype, device=labels.device)
    return out.scatter_(-1, labels.long().unsqueeze(-1), 1.0)


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the per-cluster sums are taken in: float32, or wider."""
    return torch.promote_types(dtype, torch.float32)


def _cluster_sums(onehot: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., k, d) sums ``onehot^T x`` over the n points, rounded once to x's
    dtype. onehot (..., n, k) is at ``_sum_dtype(x.dtype)``, and x is widened
    to it: at bf16 the products are exact and the sums float32, as the
    reference's dot accumulates a bf16 product. No bf16 GEMM reduces these
    10^6-long sums, so cuBLAS's split-K partials are never rounded to bf16
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    does not apply): the card sums as the CPU does. float32 keeps its bits."""
    return torch.matmul(onehot.transpose(-1, -2), x.to(onehot.dtype)).to(x.dtype)


def silhouette_score(x: torch.Tensor, labels: torch.Tensor, num_clusters: int) -> torch.Tensor:
    """Mean silhouette coefficient (sklearn semantics: singletons get s(i)=0)."""
    n = x.shape[0]
    labels = labels.long()
    onehot = _one_hot(labels, num_clusters, x.dtype)  # (n, k)
    sizes = onehot.sum(dim=0)  # (k,)
    dist_sums = cluster_dist_sums(x, onehot)
    own_size = sizes[labels]
    a = dist_sums[torch.arange(n, device=x.device), labels] / torch.clamp(own_size - 1.0, min=1.0)
    mean_to = dist_sums / torch.clamp(sizes[None, :], min=1.0)
    mask_own = onehot.bool()
    empty = sizes[None, :] == 0
    b = torch.where(mask_own | empty, torch.full_like(mean_to, math.inf), mean_to).amin(dim=1)
    s = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-12)
    s = torch.where(own_size <= 1.0, torch.zeros_like(s), s)
    return s.mean()


def silhouette_samples_masked(
    x: torch.Tensor,
    labels: torch.Tensor,
    num_clusters: int,
    point_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-point silhouette values; padding points and clusters are zeroed.

    x (..., n, d), labels (..., n) int, point_mask (..., n) bool (False =
    padding point, excluded from every cluster; its s(i) is 0). Clusters
    that are empty after masking — in particular the padded slots >= k_eff
    of a mask-padded fit — never appear in b(i). Returns s (..., n).
    """
    labels = labels.long()
    lead = torch.broadcast_shapes(x.shape[:-1], labels.shape)
    mask = torch.ones(lead, dtype=torch.bool, device=x.device)
    if point_mask is not None:
        mask = mask & point_mask
    onehot = _one_hot(labels, num_clusters, x.dtype) * mask[..., None]
    sizes = onehot.sum(dim=-2)  # (..., k) active members only
    dist_sums = cluster_dist_sums(x, onehot)  # (..., n, k)
    own_size = torch.gather(sizes[..., None, :].expand(dist_sums.shape), -1, labels[..., None])[..., 0]
    own_sum = torch.gather(dist_sums, -1, labels[..., None])[..., 0]
    a = own_sum / torch.clamp(own_size - 1.0, min=1.0)
    mean_to = dist_sums / torch.clamp(sizes[..., None, :], min=1.0)
    mask_own = F.one_hot(labels, num_clusters).bool()
    empty = sizes[..., None, :] == 0
    b = torch.where(mask_own | empty, torch.full_like(mean_to, math.inf), mean_to).amin(dim=-1)
    s = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-12)
    s = torch.where(own_size <= 1.0, torch.zeros_like(s), s)
    return torch.where(mask, s, torch.zeros_like(s))


def silhouette_score_masked(
    x: torch.Tensor,
    labels: torch.Tensor,
    num_clusters: int,
    point_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean silhouette over active points only; padded clusters are ignored."""
    s = silhouette_samples_masked(x, labels, num_clusters, point_mask)
    if point_mask is None:
        return s.mean(dim=-1)
    n_active = torch.broadcast_to(point_mask, s.shape).sum(dim=-1).to(s.dtype)
    return s.sum(dim=-1) / torch.clamp(n_active, min=1.0)


def davies_bouldin_score(x: torch.Tensor, labels: torch.Tensor, num_clusters: int) -> torch.Tensor:
    """Davies-Bouldin index (lower = better separated clusters).

    x (n, d), labels (n,); empty clusters contribute nothing. On the card
    both distance passes are the 2-D pairwise kernel. At bf16 x the
    centroids are bf16 and the distances and the index float32, as on the
    reference's kernel route.
    """
    return davies_bouldin_score_masked(x, labels, num_clusters)


def davies_bouldin_score_masked(
    x: torch.Tensor,
    labels: torch.Tensor,
    num_clusters: int,
    cluster_mask: torch.Tensor | None = None,
    point_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Davies-Bouldin index ignoring padded clusters (and padding points).

    Axis-agnostic over leading batch dims like ``silhouette_score_masked``:
    x (..., n, d) may be one (n, d) shared by batched labels (b, n), which
    on the card sends both distance passes to the batched pairwise kernel
    with x read once. ``cluster_mask`` (..., k) marks the active centroid
    slots of a mask-padded fit; inactive or empty clusters are excluded from
    both the pairwise-worst max and the final mean.
    """
    labels = labels.long()
    onehot = _one_hot(labels, num_clusters, _sum_dtype(x.dtype))
    if point_mask is not None:
        onehot = onehot * torch.broadcast_to(point_mask, x.shape[:-1])[..., None].to(onehot.dtype)
    if cluster_mask is not None:
        onehot = onehot * cluster_mask[..., None, :].to(onehot.dtype)
    counts = onehot.sum(dim=-2).to(x.dtype)  # (..., k), at x's dtype as the reference's
    sizes = torch.clamp(counts, min=1.0)
    centroids = _cluster_sums(onehot, x) / sizes[..., None]
    # intra-cluster scatter S_i: mean distance to the own centroid. A point
    # whose one-hot row is zero contributes nothing to the contraction, so
    # reading its own-label distance (instead of the reference's row sum of
    # d_to_c * onehot, equal wherever the row is not zero) changes nothing.
    d_to_c = torch.sqrt_(pairwise_sq_dists(x, centroids))  # (..., n, k)
    own_d = torch.gather(d_to_c, -1, torch.broadcast_to(labels, d_to_c.shape[:-1])[..., None])
    del d_to_c
    # float32 distances at bf16 x: the float32 one-hot meets them, as the
    # reference's bf16 one-hot promotes to float32 there
    scatter = torch.matmul(onehot.transpose(-1, -2), own_d)[..., 0] / sizes
    m = torch.sqrt(pairwise_sq_dists(centroids))  # (..., k, k) centroid separation
    r = (scatter[..., :, None] + scatter[..., None, :]) / torch.clamp(m, min=1e-12)
    eye = torch.eye(num_clusters, dtype=torch.bool, device=x.device)
    r = r.masked_fill(eye, -math.inf)
    present = counts > 0
    if cluster_mask is not None:
        present = present & cluster_mask
    r = r.masked_fill(~present[..., None, :], -math.inf)
    worst = torch.where(present, r.amax(dim=-1), torch.zeros_like(scatter))
    return worst.sum(dim=-1) / torch.clamp(present.sum(dim=-1).to(x.dtype), min=1.0)


# --------------------------------------------------------------------------
# §III-D synthetic score distributions
# --------------------------------------------------------------------------
def square_wave_score(k, k_optimal: int, hi: float = 1.0, lo: float = 0.0) -> torch.Tensor:
    """S(k) = (sgn(k0 - k + 1/2) + 1)/2 scaled to [lo, hi]: high up to k0, a cliff after."""
    k = torch.as_tensor(k, dtype=torch.float32)
    s01 = (torch.sign(k_optimal - k + 0.5) + 1.0) / 2.0
    return lo + (hi - lo) * s01


def laplacian_score(k, k_optimal: int, width: float = 2.0, hi: float = 1.0) -> torch.Tensor:
    """Worst-case §III-D distribution: a Laplacian peak at k0."""
    k = torch.as_tensor(k, dtype=torch.float32)
    return hi * torch.exp(-torch.abs(k - k_optimal) / width)


def noisy(score_fn, seed: int, sigma: float = 0.02):
    """Wrap a synthetic score with Gaussian observation noise.

    The noise of k is one normal draw from the explicit generator
    ``lane_generator(seed, k)`` (the port's ``fold_in(key, k)``) on the
    score's device: a fixed function of (seed, k), whatever the call order.
    """

    def f(k):
        score = torch.as_tensor(score_fn(k))
        gen = lane_generator(seed, int(k), score.device)
        return score + sigma * torch.randn((), device=score.device, generator=gen)

    return f
