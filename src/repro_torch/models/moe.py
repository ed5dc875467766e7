"""Mixture-of-experts FFN with capacity-based token dispatch (port of
``repro/models/moe.py``).

Routing: softmax router -> top-k experts per token (renormalised weights;
ties go to the lower expert index, as ``lax.top_k`` does).  Dispatch: each
(token, k) slot gets a position inside its expert's buffer of capacity
``C = max(int(ceil(N*k/E) * capacity_factor), 1)`` from a k-major one-hot
cumsum; slots at or past C are dropped with their combine weight.  The
experts run as two batched products over the ``(E, C, d)`` buffer.  The
combine adds each token's at most k terms in k order, with no atomics.
"""
from __future__ import annotations

import torch

from ..dist import sharding as shd
from .common import ACTIVATIONS, spec


def moe_spec(d_model: int, d_ff: int, n_experts: int) -> dict:
    return {
        "router": spec((d_model, n_experts), ("embed", "experts"),
                       init="normal", scale=0.02),
        "w_gu": spec((n_experts, d_model, 2 * d_ff),
                     ("experts", "embed", "mlp")),
        "w_down": spec((n_experts, d_ff, d_model),
                       ("experts", "mlp", "embed")),
    }


def capacity(N: int, k: int, E: int, capacity_factor: float) -> int:
    return max(int(-(-N * k // E) * capacity_factor), 1)


def route(probs, k: int, C: int):
    """(gate, sel, pos, keep) for router probabilities (N, E): top-k with
    ties to the lower index, renormalised gates, each slot's position in its
    expert's buffer (token order, then k rank), and whether it fits."""
    N, E = probs.shape
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, sel = vals[:, :k], idx[:, :k]                       # (N, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    experts = torch.arange(E, device=probs.device)
    onehot = (sel.T.reshape(-1, 1) == experts).long()        # k-major
    pos_kmajor = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    pos = pos_kmajor.reshape(k, N).T.reshape(-1)              # (N*k,)
    keep = pos < C
    return gate, sel, pos, keep


def moe_apply(p, x, *, top_k: int, capacity_factor: float = 1.25,
              act: str = "silu"):
    """x: [B, T, d] -> (y [B, T, d], aux dict of three scalar tensors)."""
    B, T, d = x.shape
    E = p["router"].shape[1]
    N, k = B * T, top_k
    C = capacity(N, k, E, capacity_factor)
    act_fn = ACTIVATIONS[act]

    # on a mesh the routing runs on every token on every rank: the
    # positions are a cumsum over the global batch (as the reference's),
    # and DTensor has no strategy for the dispatch's index_put nor the
    # combine's gather at token-sharded placements.  The tokens' gradient
    # is pinned so too: a token-sharded one would reach the reshape's
    # backward split over more ranks than the batch has rows
    xf = shd.constrain(x.reshape(N, d), (None, None))
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                     # (N, E)
    gate, sel, pos, keep = route(probs, k, C)

    # dispatch: kept slots are unique per (expert, position); dropped slots
    # go to a spare row C that is cut off before the experts run
    sel_flat = sel.reshape(-1)
    tok = torch.arange(N, device=x.device).repeat_interleave(k)
    slot = torch.where(keep, pos, C)
    buf = xf.new_zeros((E, C + 1, d))
    buf[sel_flat, slot] = xf[tok]
    buf = buf[:, :C]

    # the expert buffers at their weights' placements, so that each rank
    # runs its experts' products on its share of the model dims (and their
    # gradients are reduced where the weights' are)
    buf = shd.constrain(buf, ("experts", None, "embed"))
    gu = shd.constrain(torch.bmm(buf, p["w_gu"].to(x.dtype)),
                       ("experts", None, "mlp"))
    g, u = torch.chunk(gu, 2, dim=-1)
    h = act_fn(g.float()).to(x.dtype) * u
    out = shd.constrain(torch.bmm(h, p["w_down"].to(x.dtype)),
                        ("experts", None, "embed"))

    # combine: token n adds its k terms in k order
    gathered = out[sel_flat, torch.where(keep, pos, 0)]       # (N*k, d)
    w_flat = (gate.reshape(-1) * keep).to(x.dtype)
    terms = (gathered * w_flat[:, None]).reshape(N, k, d)
    y = xf.new_zeros((N, d))
    for j in range(k):
        y = y + terms[:, j]

    me = probs.mean(dim=0)                                    # importance
    ce = (sel[:, :1] == torch.arange(E, device=x.device)).float().mean(0)
    aux = {
        "moe_load_balance": E * torch.sum(me * ce),
        "moe_z_loss": torch.mean(torch.square(
            torch.logsumexp(logits, dim=-1))),
        # XLA's mean is a sum times the f32 reciprocal of the count; the
        # same here keeps this fraction bit-equal to the reference's
        "moe_dropped_frac": 1.0 - keep.float().sum() * torch.tensor(
            1.0 / keep.numel(), dtype=torch.float32),
    }
    return y.reshape(B, T, d), aux
