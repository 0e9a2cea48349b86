"""Mixture-of-Experts FFN with shared experts and top-k routing.

Dispatch is the reference's static-shape sort/scatter formulation
(capacity-bounded): each routed (token, slot) gets a position in its
expert's queue, in token order, and the slots past an expert's capacity are
dropped, so a later token drops first. Only the (E, C, d) expert buffers
are materialized; the expert products are batched matmuls over E.

``route`` is the routing alone (fp32 router logits, softmax, top-k gates
renormalized, queue positions, ``keep``) and ``moe_ffn`` applies it. Two
writes differ from the reference's on purpose (ROADMAP, Deliberate
divergences):

- the expert buffers receive only the kept slots: a dropped slot's index
  is sent to a discard row past the buffers before the scatter. The
  reference adds a zero at the dropped slot's aliased index; on a CUDA
  tensor an ``index_put_`` with that duplicate index would race with the
  kept slot it aliases and could overwrite it;
- the combine sums each token's ``top_k`` routed outputs with
  ``.sum(1)`` over a (T, top_k, d) view instead of the reference's
  scatter-add over ``token_of``: the same terms, with no atomics (whose
  order varies from run to run on a card), in torch's reduction order.

The backward stays free of float atomics too: the gradient of the scatter
is a gather, and a token's ``top_k`` copies are an ``expand``, whose
gradient is a sum.

Aux losses: Switch-style load-balance + router z-loss, returned to the
caller for accumulation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, MoEConfig

from .layers import dense_init, frozen


class MoEAux(NamedTuple):
    load_balance: torch.Tensor
    z_loss: torch.Tensor


class Route(NamedTuple):
    """What ``route`` decides for T tokens and ``top_k`` slots a token."""

    logits: torch.Tensor  # (T, E) fp32 router logits
    probs: torch.Tensor  # (T, E) their softmax
    expert_ids: torch.Tensor  # (T * top_k,) each slot's expert, token-major
    gates: torch.Tensor  # (T, top_k) renormalized top-k probabilities
    buf_idx: torch.Tensor  # (T * top_k,) row of the (E * C, d) buffers; dropped slots alias C - 1
    keep: torch.Tensor  # (T * top_k,) bool: the slot is inside its expert's capacity
    # (T,) k-th probability less the (k+1)-th (inf when top_k == E); read only
    # by the checks that hold one device's routes to another's at near-ties
    margin: torch.Tensor


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> nn.ParameterDict:
    """Drawn in the reference's order: router (fp32), w_gate, w_up, w_down,
    then the shared experts' w_gate, w_up, w_down."""
    m = cfg.moe
    d, de, e = cfg.d_model, m.d_expert, m.num_experts
    p = {
        "router": dense_init(gen, (d, e), d, torch.float32),
        "w_gate": dense_init(gen, (e, d, de), d, dtype),
        "w_up": dense_init(gen, (e, d, de), d, dtype),
        "w_down": dense_init(gen, (e, de, d), de, dtype),
    }
    if m.num_shared:
        ds = m.num_shared * de
        p["shared"] = frozen(
            w_gate=dense_init(gen, (d, ds), d, dtype),
            w_up=dense_init(gen, (d, ds), d, dtype),
            w_down=dense_init(gen, (ds, d), ds, dtype),
        )
    return frozen(**p)


def capacity_of(t: int, m: MoEConfig, capacity_factor: float | None = None) -> int:
    """Slots an expert takes for ``t`` tokens: the reference's formula, in Python floats."""
    cf = capacity_factor or m.capacity_factor
    return max(int(t * m.top_k * cf / m.num_experts), 8)


def _counts(expert_ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """``bincount(expert_ids, length=num_experts)``, as an integer scatter-add:
    ``torch.bincount`` on a CUDA tensor reads the largest id back to the host."""
    counts = torch.zeros(num_experts, dtype=expert_ids.dtype, device=expert_ids.device)
    return counts.scatter_add_(0, expert_ids, torch.ones_like(expert_ids))


def _dispatch_indices(expert_ids: torch.Tensor, num_experts: int, capacity: int):
    """Static-shape positions: for each routed (token-slot), its slot within
    its expert's capacity buffer; overflow slots are dropped (keep=False)."""
    tk = expert_ids.shape[0]
    order = torch.argsort(expert_ids, stable=True)  # (T*k,)
    sorted_eids = expert_ids[order]
    counts = _counts(expert_ids, num_experts)
    starts = torch.cumsum(counts, 0) - counts  # exclusive prefix
    pos_sorted = torch.arange(tk, device=expert_ids.device) - starts[sorted_eids]
    # undo the sort: order is a permutation, so every index is written once
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < capacity
    buf_idx = expert_ids * capacity + torch.clamp(pos, max=capacity - 1)
    return buf_idx, keep


def route(params, xt: torch.Tensor, cfg: ArchConfig, capacity: int) -> Route:
    """Route T tokens xt (T, d) to their top-k experts, ``capacity`` slots an expert."""
    m: MoEConfig = cfg.moe
    logits = xt.float() @ params["router"]  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    n_top = min(m.top_k + 1, m.num_experts)
    vals, idx = torch.topk(probs, n_top, dim=-1)  # sorted, descending
    if n_top > m.top_k:
        margin = vals[:, m.top_k - 1] - vals[:, m.top_k]
    else:
        margin = torch.full_like(vals[:, 0], float("inf"))
    gates, idx = vals[:, : m.top_k], idx[:, : m.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    expert_ids = idx.reshape(-1)
    buf_idx, keep = _dispatch_indices(expert_ids, m.num_experts, capacity)
    return Route(logits, probs, expert_ids, gates, buf_idx, keep, margin)


def _expert_buffers(contrib: torch.Tensor, r: Route, num_experts: int, capacity: int) -> torch.Tensor:
    """The (E, C, d) expert buffers holding each kept slot's token, zeros
    elsewhere. Only kept slots are written: a dropped slot's aliased index
    goes to a discard row past the buffers, so it cannot overwrite the kept
    slot it aliases (kept indices are unique, so the write has no race)."""
    e, d = num_experts, contrib.shape[1]
    dest = torch.where(r.keep, r.buf_idx, e * capacity)
    buffers = contrib.new_zeros((e * capacity + 1, d)).index_put((dest,), contrib)
    return buffers[: e * capacity].view(e, capacity, d)


def moe_ffn(params, x: torch.Tensor, cfg: ArchConfig,
            capacity_factor: float | None = None) -> tuple[torch.Tensor, MoEAux]:
    """x: (B, L, d) -> (B, L, d), plus router aux losses."""
    m: MoEConfig = cfg.moe
    b, l, d = x.shape
    t, e = b * l, m.num_experts
    xt = x.reshape(t, d)
    capacity = capacity_of(t, m, capacity_factor)
    r = route(params, xt, cfg, capacity)

    # each token's top_k copies, token-major as expert_ids (token_of = repeat(arange(t), top_k))
    contrib = xt[:, None, :].expand(t, m.top_k, d).reshape(t * m.top_k, d)
    buffers = _expert_buffers(contrib, r, e, capacity)

    h = F.silu(torch.bmm(buffers, params["w_gate"])) * torch.bmm(buffers, params["w_up"])
    out_buf = torch.bmm(h, params["w_down"]).reshape(e * capacity, d)
    routed = out_buf[r.buf_idx] * (r.gates.reshape(-1)[:, None] * r.keep[:, None]).to(x.dtype)
    y = routed.view(t, m.top_k, d).sum(1)

    if m.num_shared:
        s = params["shared"]
        hs = F.silu(xt @ s["w_gate"]) * (xt @ s["w_up"])
        y = y + hs @ s["w_down"]

    # Switch load-balance loss: E * sum_e f_e * p_e (f = fraction routed,
    # p = mean router prob); z-loss: mean logsumexp^2.
    f = _counts(r.expert_ids, e).float() / (t * m.top_k)
    pmean = torch.mean(r.probs, dim=0)
    lb = e * torch.sum(f * pmean)
    z = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
    return y.reshape(b, l, d), MoEAux(lb, z)
