"""MoE layer: top-k router, shared experts, and two executions.

* ``moe_reference`` -- dense all-experts compute (exact, O(T*E) FLOPs); the
  oracle for everything else.
* ``moe_capacity`` -- static capacity-bounded gather -> expert -> scatter,
  the single-device semantics of the paper's FusedDispatch/FusedCombine
  pre-allocated buffers (paper Eq. 1-2).

The expert products are plain ``torch`` matmuls (the JAX package leaves them
to XLA; there is no TPU kernel here). Router: softmax -> top-k ->
renormalize, with a Switch-style load-balance auxiliary loss.

Top-k ties: ``jax.lax.top_k`` returns the lower expert index first among
equal probabilities; ``torch.topk`` does not promise an order. :func:`route`
takes the first k of a *stable* descending sort, which keeps equal values in
index order, so the port breaks ties exactly as JAX does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import dtensor as dt
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import swiglu, weight


class MoE(nn.Module):
    """One MoE layer's weights (router in f32, experts stacked (E, ...))."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        w = lambda shape, dt=dtype, kind="dense": weight(  # noqa: E731
            shape, dt, device, generator, kind)
        self.ln = w((d,), kind="ones")
        self.router = w((d, e), torch.float32)
        self.w_gate = w((e, d, f))
        self.w_up = w((e, d, f))
        self.w_down = w((e, f, d))
        self.has_shared = bool(cfg.num_shared_experts)
        if self.has_shared:
            fs = f * cfg.num_shared_experts
            self.shared_gate = w((d, fs))
            self.shared_up = w((d, fs))
            self.shared_down = w((fs, d))


def init_moe_params(cfg: ModelConfig, device: torch.device,
                    dtype: torch.dtype,
                    generator: Optional[torch.Generator]) -> MoE:
    return MoE(cfg, device, dtype, generator)


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, D) -> (top-k ids (T,K), renormalized probs (T,K), aux loss)."""
    logits = x.float() @ router_w
    probs = dt.softmax(logits, dim=-1)
    sorted_p, sorted_i = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    k = cfg.num_experts_per_tok
    top_p, top_i = sorted_p[:, :k], sorted_i[:, :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    e = cfg.num_experts
    frac = F.one_hot(top_i, e).float().sum(dim=1).mean(dim=0)
    mean_p = probs.mean(dim=0)
    aux = e * (frac * mean_p).sum()
    return top_i, top_p, aux


def _shared_out(p: MoE, x: torch.Tensor) -> torch.Tensor:
    if not p.has_shared:
        return torch.zeros_like(x)
    return swiglu(x, p.shared_gate, p.shared_up, p.shared_down)


def moe_reference(p: MoE, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dense all-experts oracle. x: (T, D)."""
    top_i, top_p, aux = route(p.router, x, cfg)
    # (1,T,D) @ (E,D,F) -> (E,T,F): batched over experts, no weight copy.
    g = x[None] @ p.w_gate
    u = x[None] @ p.w_up
    y = (F.silu(g) * u) @ p.w_down                              # (E,T,D)
    w = (F.one_hot(top_i, cfg.num_experts).float()
         * top_p[..., None]).sum(dim=1)                         # (T,E)
    out = torch.einsum("etd,te->td", y.float(), w).to(x.dtype)
    return out + _shared_out(p, x), {"aux_loss": aux}


def capacity_for(cfg: ModelConfig, n_tokens: int, ep_degree: int = 1) -> int:
    """Static buffer depth per expert -- the paper's max_tokens (Eq. 2)."""
    per = n_tokens * cfg.num_experts_per_tok / max(cfg.num_experts, 1)
    cap = int(per * cfg.capacity_factor) + 1
    return max(8, ((cap + 7) // 8) * 8)


def dispatch_indices(top_i: torch.Tensor, num_experts: int, capacity: int):
    """Scatter locations for capacity-bounded dispatch. top_i: (T, K) ->
    (expert_slot (T,K), valid (T,K)): the slot within the expert's buffer,
    tokens keeping arrival order within an expert."""
    t, k = top_i.shape
    flat_e = top_i.reshape(-1)
    onehot = F.one_hot(flat_e, num_experts).to(torch.int32)    # (TK, E)
    pos_in_e = torch.cumsum(onehot, dim=0) - 1
    slot = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    valid = slot < capacity
    return slot.reshape(t, k), valid.reshape(t, k)


def moe_capacity(p: MoE, x: torch.Tensor, cfg: ModelConfig,
                 capacity: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Capacity-bounded gather -> expert -> scatter (single-device
    FusedDispatch). Tokens past an expert's capacity are dropped."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = capacity or capacity_for(cfg, t)
    top_i, top_p, aux = route(p.router, x, cfg)
    slot, valid = dispatch_indices(top_i, e, cap)

    # Scatter tokens into the (E, C, D) buffer ("FusedDispatch"). Valid
    # (expert, slot) pairs are unique, so a plain write is exact and
    # deterministic; dropped tokens go to a spare row C that is never read.
    flat_e, flat_s = top_i.reshape(-1), slot.reshape(-1)
    flat_v = valid.reshape(-1)
    tok_ids = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[flat_e, torch.where(flat_v, flat_s, cap)] = x[tok_ids]
    buf = buf[:, :cap]

    # Expert FFN over the static buffer.
    g = torch.bmm(buf, p.w_gate)
    u = torch.bmm(buf, p.w_up)
    y = torch.bmm(F.silu(g) * u, p.w_down)                      # (E,C,D)

    # Gather back + weighted combine ("FusedCombine"): the K picks of a
    # token are adjacent in the flat order, so the combine is a sum over K.
    safe_s = torch.where(flat_v, flat_s, cap - 1)
    gathered = torch.where(flat_v[:, None], y[flat_e, safe_s], 0)
    weighted = gathered.float() * top_p.reshape(-1)[:, None]
    out = weighted.reshape(t, k, d).sum(dim=1).to(x.dtype)

    dropped = (~flat_v).sum()
    return out + _shared_out(p, x), {"aux_loss": aux, "dropped": dropped}
