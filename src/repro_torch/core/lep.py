"""Large-scale Expert Parallelism (LEP, paper §4.2) over ``torch.distributed``.

The port of the JAX package's ``core/lep.py``: the paper's FusedDispatch /
FusedCombine as a MoE function for the model's ``moe_fn`` hook.

* **Static pre-allocated buffers** (paper Eq. 1-2): each rank packs its
  tokens into a capacity-bounded (slots, C, D) dispatch buffer.
* **Early INT8 quantization** (Opt. 2): the buffer is quantized per row
  before the collective by the hand-written kernel behind
  :func:`repro_torch.kernels.dispatch_quant.dispatch_quantize`, which also
  writes each row's f32 scale into the row's last 4 bytes
  (``pack_scales``), so the dispatch hop is one ``all_to_all`` of int8
  rows. The combine returns bf16 (or the model's dtype) unquantized.
* **EPLB redundancy**: ``redundancy=r`` replicates each expert r times.

The world is one-dimensional: every rank of ``group`` is one expert-
parallel rank holding ``slots / world`` slots. ``group=None`` (or a group of
one rank) is world size 1: no collective is called and the whole MoE runs on
one card. Every rank calls the MoE function with the full token batch (the
attention runs replicated); each routes its ``1/world`` share of the rows,
as the JAX package's ``shard_map`` shards the token axis, and the outputs
are gathered back to every rank. The two-dimensional modes of the JAX
package (``ffn_shard_axis``, ``ffn_gather="tokens"``, ``quantize_gather``)
arrive with the slice that runs LEP across four cards.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch_quant import dispatch_quantize
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import swiglu

_TWO_D = ("the 2-D LEP modes (ffn_shard_axis, ffn_gather='tokens', "
          "quantize_gather) arrive with the slice of the port that runs LEP "
          "across 4 cards")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def lep_capacity(t_loc: int, k: int, slots: int, factor: float,
                 align: int = 8) -> int:
    """Static buffer depth per (slot, source rank), paper Eq. 2. ``align``
    pads the depth; decode may use ``align=1`` (the 8-floor over-dispatches
    up to 8x when t_loc*k/slots is about 1)."""
    cap = _cdiv(int(t_loc * k * factor), slots) + 1
    return max(align, ((cap + align - 1) // align) * align)


def _quantize_rows(x: torch.Tensor, pack: bool):
    """Per-row int8 quantization of ``x`` (..., D) through the
    dispatch-quantize wrapper: ``(q, scale (..., 1))``, or with ``pack`` one
    int8 (..., D + 4) tensor carrying the scale's bytes at the tail."""
    shp = x.shape
    out = dispatch_quantize(x.reshape(-1, shp[-1]), pack=pack)
    if pack:
        return out.reshape(shp[:-1] + (shp[-1] + 4,))
    q, s = out
    return q.reshape(shp), s.reshape(shp[:-1] + (1,))


def _world(group) -> Tuple[int, int]:
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of dim 0 goes to rank i; chunk i of the result came from
    rank i (``jax.lax.all_to_all(x, axes, 0, 0)``)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def make_lep_moe_fn(group: Optional["dist.ProcessGroup"] = None, *,
                    quantize: bool = True, redundancy: int = 1,
                    ffn_shard_axis: Optional[str] = None,
                    ffn_gather: str = "weights",
                    quantize_gather: bool = False,
                    capacity_factor: Optional[float] = None,
                    capacity_align: int = 8, naive: bool = False,
                    pack_scales: bool = True):
    """Build a ``moe_fn`` that runs the routed experts with LEP over the
    ranks of ``group``.

    ``naive=True`` is the paper's Fig. 10a baseline: unquantized payloads
    plus an explicit routing-metadata ``all_to_all``. ``pack_scales`` (on by
    default) carries each row's f32 scale in the int8 payload's last 4
    bytes, so the quantized dispatch hop is one collective;
    ``pack_scales=False`` sends payload and scales in two."""
    if ffn_shard_axis is not None or ffn_gather != "weights" or quantize_gather:
        raise NotImplementedError(_TWO_D)
    if naive:
        quantize = False

    def moe_fn(p, x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        n_rank, rank = _world(group)
        t, d = x.shape
        e, k = cfg.num_experts, cfg.num_experts_per_tok
        r = redundancy
        slots = e * r
        if slots % n_rank:
            raise ValueError(f"experts*redundancy ({slots}) must divide over "
                             f"the {n_rank} ranks; adjust redundancy")
        slots_loc = slots // n_rank
        factor = capacity_factor or cfg.capacity_factor
        dev = x.device

        # Pad tokens to the rank count so every rank gets equal rows.
        t_pad = _cdiv(t, n_rank) * n_rank
        t_loc = t_pad // n_rank
        cap = lep_capacity(t_loc, k, slots, factor, capacity_align)
        x_loc = F.pad(x, (0, 0, 0, t_pad - t))[rank * t_loc:(rank + 1) * t_loc]
        row = torch.arange(t_loc, device=dev)
        valid = row + rank * t_loc < t

        top_i, top_p, aux = moe_mod.route(p.router, x_loc, cfg)
        # Padded rows: spread over experts, zero combine weight.
        spread = (row[:, None] * k + torch.arange(k, device=dev)[None, :]) % e
        top_i = torch.where(valid[:, None], top_i, spread)
        top_p = torch.where(valid[:, None], top_p, 0.0)
        # Redundancy: replica chosen by token index (EPLB load spread).
        slot_ids = top_i * r + (row[:, None] % r) if r > 1 else top_i

        meta_term = 0.0
        if naive:
            # Fig. 10a baseline: an explicit metadata all_to_all first.
            counts = F.one_hot(slot_ids, slots).sum(dim=(0, 1)).to(torch.int32)
            counts = counts.reshape(n_rank, slots_loc)
            if n_rank > 1:
                counts = _all_to_all(counts, group)
            meta_term = counts.sum().float() * 0.0

        # --- FusedDispatch: pack into the static (slots, C, D) buffer.
        # Valid (slot, position) pairs are unique, so a plain write is exact;
        # dropped picks go to a spare last row that is never read.
        slot_pos, in_cap = moe_mod.dispatch_indices(slot_ids, slots, cap)
        flat_slot = slot_ids.reshape(-1)
        flat_v = in_cap.reshape(-1)
        flat_pos = torch.where(flat_v, slot_pos.reshape(-1), cap - 1)
        tok_of = torch.arange(t_loc, device=dev).repeat_interleave(k)
        dest = torch.where(flat_v, flat_slot * cap + flat_pos, slots * cap)
        buf = torch.zeros((slots * cap + 1, d), dtype=x.dtype, device=dev)
        buf[dest] = x_loc[tok_of]
        buf = buf[:slots * cap]                   # (slots * C, D), contiguous

        if quantize:   # early quantization BEFORE the collective
            if pack_scales:
                payload = _quantize_rows(buf, pack=True).reshape(
                    n_rank, slots_loc * cap, d + 4)
                if n_rank > 1:
                    payload = _all_to_all(payload, group)
                q_recv = payload[..., :d]
                s_recv = payload[..., d:].contiguous().view(torch.float32)
            else:
                q, scale = _quantize_rows(buf, pack=False)
                q_recv = q.reshape(n_rank, slots_loc * cap, d)
                s_recv = scale.reshape(n_rank, slots_loc * cap, 1)
                if n_rank > 1:
                    q_recv = _all_to_all(q_recv, group)
                    s_recv = _all_to_all(s_recv, group)
            recv = (q_recv.float() * s_recv).to(x.dtype)
        else:
            recv = buf.reshape(n_rank, slots_loc * cap, d)
            if n_rank > 1:
                recv = _all_to_all(recv, group)
        # (ranks, slots_loc, C, D) -> (slots_loc, ranks * C, D)
        tokens = recv.reshape(n_rank, slots_loc, cap, d).transpose(0, 1) \
            .reshape(slots_loc, n_rank * cap, d)

        # --- Expert FFN over the local slots.
        lo = rank * slots_loc
        if r == 1:
            wg, wu, wd = (w[lo:lo + slots_loc]
                          for w in (p.w_gate, p.w_up, p.w_down))
        else:
            experts = torch.arange(lo, lo + slots_loc, device=dev) // r
            wg, wu, wd = p.w_gate[experts], p.w_up[experts], p.w_down[experts]
        g = torch.bmm(tokens, wg)
        u = torch.bmm(tokens, wu)
        y = torch.bmm(F.silu(g) * u, wd)                # (slots_loc, ranks*C, D)

        # --- FusedCombine: payload back to the source ranks.
        y_back = y.reshape(slots_loc, n_rank, cap, d).transpose(0, 1)
        if n_rank > 1:
            y_back = _all_to_all(y_back, group)
        y_flat = y_back.reshape(slots, cap, d)

        # The K picks of a token are adjacent in the flat order, so the
        # combine is a sum over K (as in ``moe_capacity``).
        gathered = torch.where(flat_v[:, None], y_flat[flat_slot, flat_pos], 0)
        weighted = gathered.float() * top_p.reshape(-1)[:, None]
        out = (weighted.reshape(t_loc, k, d).sum(dim=1) + meta_term).to(x.dtype)

        dropped = (~flat_v).sum()
        if n_rank > 1:
            # pmean(aux) and psum(dropped) in one reduction, then the
            # token-sharded outputs back to every rank.
            red = torch.stack([aux.float(), dropped.float()])
            dist.all_reduce(red, group=group)
            aux = red[0] / n_rank
            dropped = red[1].round().to(torch.int64)
            parts = [torch.empty_like(out) for _ in range(n_rank)]
            dist.all_gather(parts, out.contiguous(), group=group)
            out = torch.cat(parts)
        routed = out[:t]

        # Shared experts: dense, on every rank.
        if p.has_shared:
            routed = routed + swiglu(x, p.shared_gate, p.shared_up,
                                     p.shared_down).to(routed.dtype)
        return routed, {"aux_loss": aux, "dropped": dropped}

    return moe_fn


def pick_lep_plan(cfg: ModelConfig, world_size: int,
                  serving: bool = False) -> dict:
    """Keyword arguments of :func:`make_lep_moe_fn` for ``cfg`` over a 1-D
    world of ``world_size`` ranks, in the paper's order of preference: one
    or more experts per rank (the paper's LEP), else, when serving, EPLB
    redundancy so the slots fill the world exactly. Anything else needs the
    JAX package's model-axis EP with FFN sharding, a 2-D mode."""
    e = cfg.num_experts
    if e % world_size == 0:
        return dict(redundancy=1)
    if serving and world_size % e == 0:
        return dict(redundancy=world_size // e)
    raise NotImplementedError(
        f"{e} experts over {world_size} ranks: {_TWO_D}")
