"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its kernel computes, in fp32, with the
reference's algebra. ``ops`` runs them for tensors on the CPU; the CPU
tests hold them against the JAX reference, and ``chip_smoke.py`` holds
each kernel against them on the card. All are axis-agnostic over leading
batch dims.

At bfloat16 each computes the TPU kernel's bf16 arithmetic, not a bf16
rounding of every op: the MU updates take the k x k Gram product in bf16
(the reference's wrapper forms it outside its kernel), everything else in
fp32 from the upcast inputs, and round once to bf16; the pairwise
distances and the silhouette sums upcast and return fp32.
"""
from __future__ import annotations

import torch

_EPS = 1e-9


def _mu_update(x: torch.Tensor, num_a, num_b, gram: torch.Tensor, gram_left: bool) -> torch.Tensor:
    """x * (num_a @ num_b) / (den + eps), den = gram @ x or x @ gram, in
    x's dtype promoted to at least fp32 (the float32 and float64 bits of
    the plain expression), rounded once to x's dtype (bf16 half)."""
    f = torch.promote_types(x.dtype, torch.float32)
    num = num_a.to(f) @ num_b.to(f)
    den = (gram.to(f) @ x.to(f) if gram_left else x.to(f) @ gram.to(f)) + _EPS
    return (x.to(f) * num / den).to(x.dtype)


def mu_update_h(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """H <- H * (W^T V) / (W^T W H + eps), G = W^T W in H's dtype."""
    wt = w.transpose(-1, -2)
    return _mu_update(h, wt, v, wt @ w, gram_left=True)


def mu_update_w(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """W <- W * (V H^T) / (W H H^T + eps), Q = H H^T in W's dtype."""
    ht = h.transpose(-1, -2)
    return _mu_update(w, v, ht, h @ ht, gram_left=False)


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) over rows of x (..., n, d), y (..., m, d),
    in their dtype promoted to at least fp32: bf16 operands give fp32
    distances, as the TPU kernel writes them; fp32 and float64 keep their bits."""
    y = x if y is None else y
    f = torch.promote_types(torch.promote_types(x.dtype, y.dtype), torch.float32)
    x, y = x.to(f), y.to(f)
    xx = torch.sum(x * x, dim=-1)[..., :, None]
    yy = torch.sum(y * y, dim=-1)[..., None, :]
    d2 = xx + yy - 2.0 * torch.matmul(x, y.transpose(-1, -2))
    return torch.clamp(d2, min=0.0)


def silhouette_dist_sums(
    x: torch.Tensor, onehot: torch.Tensor, y: torch.Tensor | None = None
) -> torch.Tensor:
    """Dense: materialize sqrt distances, contract with the one-hot; bf16
    operands are upcast and the sums are fp32, as the kernel writes them."""
    y = x if y is None else y
    ct = torch.promote_types(x.dtype, torch.float32)
    return torch.matmul(torch.sqrt(pairwise_sq_dists(x.to(ct), y.to(ct))), onehot.to(ct))


def query_offset(lq: int, lk: int, causal: bool, window: int | None, q_offset: int | None) -> int:
    """``q_offset``, which causal or windowed attention with Lq != Lk must
    name (where the rows sit is ambiguous there: the reference oracle puts
    them at Lk - Lq, a query block of a sequence-parallel prefill at its
    rank's offset); 0 when it is None and nothing depends on it."""
    if q_offset is None:
        if (causal or window is not None) and lq != lk:
            raise ValueError(f"causal or windowed attention with Lq != Lk takes an explicit q_offset, got "
                             f"Lq={lq}, Lk={lk}")
        return 0
    return q_offset


def _mask(lq: int, lk: int, causal: bool, window: int | None, device, q_offset: int | None = None) -> torch.Tensor:
    """(Lq, Lk) live pairs; query row i at position ``q_offset + i``."""
    q_offset = query_offset(lq, lk, causal, window, q_offset)
    q_idx = torch.arange(lq, device=device)[:, None] + q_offset
    k_idx = torch.arange(lk, device=device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_idx <= q_idx
    if window is not None:
        mask &= k_idx > q_idx - window
    return mask


def attention(
    q: torch.Tensor,  # (B, Hq, Lq, D)
    k: torch.Tensor,  # (B, Hk, Lk, D)
    v: torch.Tensor,  # (B, Hk, Lk, D)
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int | None = None,
) -> torch.Tensor:
    """Dense softmax attention with GQA/causal/sliding-window, in fp32 math
    (float64 inputs stay float64).

    Query head h reads kv head ``h // (Hq // Hk)``. Query row i is position
    ``q_offset + i`` for the causal and window masks, as in the kernel;
    causal or windowed attention with Lq != Lk must name it (the reference
    oracle offsets the rows by Lk - Lq: the same masks at Lq == Lk), and
    raises without it.
    """
    lq, d = q.shape[-2:]
    lk = k.shape[-2]
    group = q.shape[1] // k.shape[1]
    scale = float(scale if scale is not None else d**-0.5)
    ct = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(ct).repeat_interleave(group, dim=1)
    vf = v.to(ct).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), kf) * scale
    s = torch.where(_mask(lq, lk, causal, window, q.device, q_offset), s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


# -----------------------------------------------------------------------------
# Split TF32: the arithmetic of the flash kernel on the card. Used by the
# tests only; the wrappers' plain path is ``attention``.
# -----------------------------------------------------------------------------
def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 to the nearest TF32 value (10 stored mantissa bits), ties away
    from zero, as ``cvt.rna.tf32.f32``. Zeros, infinities and NaN pass
    through, subnormals round on the same grid, and a value past the largest
    TF32 rounds to infinity."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    # add half of the 13 dropped bits' range to the magnitude, then drop them;
    # only NaN bit patterns can carry out of the int32 range
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), x = hi + lo both TF32:
    each product of two TF32 values is exact in float32, the sums are not."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def attention_3xtf32(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int | None = None,
) -> torch.Tensor:
    """``attention`` in float32 with both products in split TF32, as the
    flash kernel computes them on the card: S = Q K^T in three TF32
    passes, then the unnormalized P = exp(S - max) times V in three passes,
    divided by the row sum."""
    lq, d = q.shape[-2:]
    lk = k.shape[-2]
    group = q.shape[1] // k.shape[1]
    scale = float(scale if scale is not None else d**-0.5)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = _mm3(q.float(), kf.transpose(-1, -2)) * scale
    s = torch.where(_mask(lq, lk, causal, window, q.device, q_offset), s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return _mm3(p, vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
