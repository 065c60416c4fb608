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

Two ways to lay out the ranks. With ``group`` (1-D), every rank of the
group is one expert-parallel rank holding ``slots / world`` slots;
``group=None`` (or a group of one rank) is world size 1. With ``mesh`` (a
``DeviceMesh``, 2-D as in the JAX package), tokens are sharded over every
mesh axis and ``ep_axes`` is the EP domain:

* ``("data", "model")``: full-mesh EP, the paper's LEP;
* ``("model",)``: EP over the model axis, the experts replicated over
  ``data``, or F-sharded over it with ``ffn_shard_axis="data"`` (Kimi K2's
  plan): gathered before the FFN (ZeRO-3, ``ffn_gather="weights"``), or the
  token buffer is gathered over the shard axis instead, the FFN runs on the
  rank's F-shard and the partial sums are reduce-scattered back
  (``ffn_gather="tokens"``; with ``quantize_gather`` that hop is quantized
  by the same kernel).

Every rank calls the MoE function with the full token batch (the attention
runs replicated); each routes its share of the rows, as JAX's ``shard_map``
shards the token axis, uses its own slots (and F-shard), and the outputs
are gathered back to every rank. By default each rank holds the whole
expert weights and the function cuts out its share (training takes this
form: the collectives carry the gradient rules of
:mod:`repro_torch.core.parallel`, so a step through LEP gets JAX's
gradients). :func:`keep_local_experts` instead cuts every MoE layer down to
the rank's slots and F-shard in place and marks it with that share, which
the function then uses as it is: a rank holds its share of the experts,
and the ZeRO-3 gather brings in F-shards it does not hold. An axis of one rank
issues no collective and copies no weight.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import dtensor as dt
from repro_torch.configs.base import ModelConfig
from repro_torch.core import parallel as par
from repro_torch.kernels.dispatch_quant import dispatch_quantize
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import swiglu

#: expert bytes a device may hold replicated before ``pick_lep_plan``
#: shards the FFN over ``data`` (the JAX package's threshold)
REPLICATE_LIMIT_BYTES = 4e9


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


def _unpack(payload: torch.Tensor, d: int, dtype: torch.dtype) -> torch.Tensor:
    """Dequantize packed int8 rows (..., D + 4) to ``dtype``."""
    q = payload[..., :d]
    s = payload[..., d:].contiguous().view(torch.float32)
    return (q.float() * s).to(dtype)


@dataclasses.dataclass(frozen=True)
class _Layout:
    """This rank's place: the group, size and index over every axis, over
    the EP axes and over the FFN shard axis, and over the axes its token
    rows are split over (every axis, unless the rows come already sharded
    over some: a DTensor batch). A group of one rank is None."""
    all_group: object = None
    n_all: int = 1
    i_all: int = 0
    ep_group: object = None
    n_ep: int = 1
    i_ep: int = 0
    shard_group: object = None
    n_shard: int = 1
    i_shard: int = 0
    tok_group: object = None
    n_tok: int = 1
    i_tok: int = 0


def _group_layout(group) -> _Layout:
    if group is None or dist.get_world_size(group) == 1:
        return _Layout()
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return _Layout(group, n, i, group, n, i, tok_group=group, n_tok=n,
                   i_tok=i)


def _mesh_layout(mesh, ep_axes, ffn_shard_axis) -> _Layout:
    names = tuple(mesh.mesh_dim_names)
    for a in tuple(ep_axes) + ((ffn_shard_axis,) if ffn_shard_axis else ()):
        if a not in names:
            raise ValueError(f"axis {a!r} is not one of the mesh's {names}")
    shard = (ffn_shard_axis,) if ffn_shard_axis else ()
    return _Layout(
        par.axes_group(mesh, names), par.axis_size(mesh, names),
        par.axis_index(mesh, names),
        par.axes_group(mesh, ep_axes), par.axis_size(mesh, ep_axes),
        par.axis_index(mesh, ep_axes),
        par.axes_group(mesh, shard), par.axis_size(mesh, shard),
        par.axis_index(mesh, shard),
        par.axes_group(mesh, names), par.axis_size(mesh, names),
        par.axis_index(mesh, names))


def _cut_experts(ws: Sequence[torch.Tensor], lay: _Layout, slots_loc: int,
                 r: int) -> Tuple[torch.Tensor, ...]:
    """This rank's slots of (w_gate, w_up, w_down) and, when the FFN is
    sharded, its F-shard: views of the whole weights when r is 1."""
    wg, wu, wd = ws
    lo = lay.i_ep * slots_loc
    if r == 1:
        wg, wu, wd = (w[lo:lo + slots_loc] for w in (wg, wu, wd))
    else:
        experts = torch.arange(lo, lo + slots_loc, device=wg.device) // r
        wg, wu, wd = wg[experts], wu[experts], wd[experts]
    if lay.n_shard > 1:
        f_loc = wg.shape[2] // lay.n_shard
        fl = lay.i_shard * f_loc
        wg, wu = wg[:, :, fl:fl + f_loc], wu[:, :, fl:fl + f_loc]
        wd = wd[:, fl:fl + f_loc]
    return wg, wu, wd


def _share(lay: _Layout, redundancy: int) -> Tuple[int, ...]:
    return (lay.i_ep, lay.n_ep, lay.i_shard, lay.n_shard, redundancy)


def keep_local_experts(module: torch.nn.Module, group=None, *, mesh=None,
                       ep_axes: Tuple[str, ...] = ("model",),
                       redundancy: int = 1,
                       ffn_shard_axis: Optional[str] = None,
                       **_plan) -> None:
    """Cut the experts of every MoE layer of ``module`` (a model or one
    layer) to this rank's slots and F-shard, in place, so that the rank
    holds only the expert bytes that LEP with the same layout uses; the
    whole weights are freed unless the caller keeps them. Each layer is
    marked with its share (``expert_share``), which the MoE function of
    the same layout then takes as it is, and any other refuses. Serving
    only: that function refuses marked weights that require grad (a
    training step's global gradient norm would see one rank's share).
    Takes a plan of :func:`pick_lep_plan` (its other keywords are
    ignored). Made by every rank together, as :func:`make_lep_moe_fn`. On
    an axis of one rank nothing is cut."""
    if mesh is None:
        lay = _group_layout(group)
    else:
        lay = _mesh_layout(mesh, tuple(ep_axes), ffn_shard_axis)
    for layer in module.modules():
        if not isinstance(layer, moe_mod.MoE):
            continue
        e, _, f = layer.w_gate.shape
        if (e * redundancy) % lay.n_ep or f % lay.n_shard:
            raise ValueError(f"{e} experts x {redundancy} and d_ff {f} must "
                             f"divide over {lay.n_ep} EP and {lay.n_shard} "
                             "FFN-shard ranks")
        cut = _cut_experts((layer.w_gate, layer.w_up, layer.w_down), lay,
                           e * redundancy // lay.n_ep, redundancy)
        for name, w in zip(("w_gate", "w_up", "w_down"), cut):
            old = getattr(layer, name)
            if w.shape != old.shape:   # a copy: the whole can be freed
                setattr(layer, name, torch.nn.Parameter(
                    w.clone(memory_format=torch.contiguous_format),
                    requires_grad=old.requires_grad))
        layer.expert_share = _share(lay, redundancy)


def make_lep_moe_fn(group: Optional["dist.ProcessGroup"] = None, *,
                    mesh=None, ep_axes: Tuple[str, ...] = ("model",),
                    quantize: bool = True, redundancy: int = 1,
                    ffn_shard_axis: Optional[str] = None,
                    ffn_gather: str = "weights",
                    quantize_gather: bool = False,
                    capacity_factor: Optional[float] = None,
                    capacity_align: int = 8, naive: bool = False,
                    pack_scales: bool = True):
    """Build a ``moe_fn`` that runs the routed experts with LEP over the
    ranks of ``group`` (1-D) or of ``mesh`` (with ``ep_axes``,
    ``ffn_shard_axis``, ``ffn_gather`` and ``quantize_gather``, as in the
    JAX package). Made by every rank together: a mesh's groups over
    several axes are made here.

    ``naive=True`` is the paper's Fig. 10a baseline: unquantized payloads
    plus an explicit routing-metadata ``all_to_all``. ``pack_scales`` (on by
    default) carries each row's f32 scale in the int8 payload's last 4
    bytes, so the quantized dispatch hop is one collective;
    ``pack_scales=False`` sends payload and scales in two.

    MoE weights that :func:`keep_local_experts` has cut to this rank's
    share are used as they are (serving only); whole ones are cut here."""
    if ffn_gather not in ("weights", "tokens"):
        raise ValueError(f"ffn_gather must be 'weights' or 'tokens', not "
                         f"{ffn_gather!r}")
    if mesh is None:
        if ffn_shard_axis is not None or ffn_gather != "weights" \
                or quantize_gather:
            raise ValueError("ffn_shard_axis, ffn_gather='tokens' and "
                             "quantize_gather shard over a mesh axis: pass "
                             "mesh=")
        lay = _group_layout(group)
    else:
        if group is not None:
            raise ValueError("pass group (1-D) or mesh (2-D), not both")
        lay = _mesh_layout(mesh, tuple(ep_axes), ffn_shard_axis)
    gather_tokens = bool(ffn_shard_axis) and ffn_gather == "tokens"
    if naive:
        quantize = False

    def run(p, x: torch.Tensor, cfg: ModelConfig, lay: _Layout,
            local_experts: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        t, d = x.shape
        e, k = cfg.num_experts, cfg.num_experts_per_tok
        r = redundancy
        slots = e * r
        if slots % lay.n_ep:
            raise ValueError(f"experts*redundancy ({slots}) must divide over "
                             f"the {lay.n_ep} EP ranks; adjust ep_axes or "
                             "redundancy")
        slots_loc = slots // lay.n_ep
        if cfg.d_ff % lay.n_shard:
            raise ValueError(f"d_ff ({cfg.d_ff}) must divide over the "
                             f"{lay.n_shard} ranks of {ffn_shard_axis!r}")
        factor = capacity_factor or cfg.capacity_factor
        dev = x.device

        # Pad tokens to the rank count so every rank gets equal rows.
        t_pad = _cdiv(t, lay.n_tok) * lay.n_tok
        t_loc = t_pad // lay.n_tok
        cap = lep_capacity(t_loc, k, slots, factor, capacity_align)
        x_loc = par.split_replicated(F.pad(x, (0, 0, 0, t_pad - t)),
                                     lay.tok_group)
        row = torch.arange(t_loc, device=dev)
        valid = row + lay.i_tok * t_loc < t

        router = par.grad_sum(p.router, lay.all_group)
        top_i, top_p, aux = moe_mod.route(router, x_loc, cfg)
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
            counts = par.all_to_all(counts.reshape(lay.n_ep, slots_loc),
                                    lay.ep_group)
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
                payload = par.all_to_all(_quantize_rows(buf, pack=True).reshape(
                    lay.n_ep, slots_loc * cap, d + 4), lay.ep_group)
                recv = _unpack(payload, d, x.dtype)
            else:
                q, scale = _quantize_rows(buf, pack=False)
                q_recv = par.all_to_all(
                    q.reshape(lay.n_ep, slots_loc * cap, d), lay.ep_group)
                s_recv = par.all_to_all(
                    scale.reshape(lay.n_ep, slots_loc * cap, 1), lay.ep_group)
                recv = (q_recv.float() * s_recv).to(x.dtype)
        else:
            recv = par.all_to_all(buf.reshape(lay.n_ep, slots_loc * cap, d),
                                  lay.ep_group)
        # (ranks, slots_loc, C, D) -> (slots_loc, ranks * C, D)
        tokens = recv.reshape(lay.n_ep, slots_loc, cap, d).transpose(0, 1) \
            .reshape(slots_loc, lay.n_ep * cap, d)

        # --- Expert FFN over the local slots (and the local F-shard). On an
        # axis of one rank these are views of the whole weights.
        # ``local_experts``: blocks a DTensor step placed (:func:`_on_blocks`).
        share = getattr(p, "expert_share", None)
        if local_experts:
            wg, wu, wd = p.w_gate, p.w_up, p.w_down
        elif share is not None:
            wg, wu, wd = p.w_gate, p.w_up, p.w_down
            if share != _share(lay, r):
                raise ValueError(f"the experts were cut to the share {share} "
                                 f"(EP index, ranks, F-shard index, ranks, "
                                 f"redundancy), not this rank's "
                                 f"{_share(lay, r)}: cut them with "
                                 "keep_local_experts and the same layout")
            if torch.is_grad_enabled() and any(
                    w.requires_grad for w in (wg, wu, wd)):
                raise ValueError("local experts serve only; a training step "
                                 "holds the whole weights")
        else:
            wg, wu, wd = _cut_experts(
                [par.grad_sum(w, lay.all_group)
                 for w in (p.w_gate, p.w_up, p.w_down)], lay, slots_loc, r)
        if gather_tokens:
            # Decode-optimized 2-level EP: gather the (small) token buffer
            # over the shard axis, run the rank's F-shard, and reduce-scatter
            # the partial sums back to the token owners.
            if quantize_gather:
                tok_g = _unpack(par.all_gather(
                    _quantize_rows(tokens, pack=True), lay.shard_group, dim=1),
                    d, tokens.dtype)
            else:
                tok_g = par.all_gather(tokens, lay.shard_group, dim=1)
            y_part = torch.bmm(F.silu(torch.bmm(tok_g, wg))
                               * torch.bmm(tok_g, wu), wd)
            y = par.reduce_scatter(y_part, lay.shard_group, dim=1)
        else:
            if lay.n_shard > 1:
                # ZeRO-3: gather the F-shards of the weights.
                wg = par.all_gather(wg, lay.shard_group, dim=2)
                wu = par.all_gather(wu, lay.shard_group, dim=2)
                wd = par.all_gather(wd, lay.shard_group, dim=1)
            g = torch.bmm(tokens, wg)
            u = torch.bmm(tokens, wu)
            y = torch.bmm(F.silu(g) * u, wd)            # (slots_loc, ranks*C, D)

        # --- FusedCombine: payload back to the source ranks.
        y_back = par.all_to_all(
            y.reshape(slots_loc, lay.n_ep, cap, d).transpose(0, 1),
            lay.ep_group)
        y_flat = y_back.reshape(slots, cap, d)

        # The K picks of a token are adjacent in the flat order, so the
        # combine is a sum over K (as in ``moe_capacity``).
        gathered = torch.where(flat_v[:, None], y_flat[flat_slot, flat_pos], 0)
        weighted = gathered.float() * top_p.reshape(-1)[:, None]
        out = (weighted.reshape(t_loc, k, d).sum(dim=1) + meta_term).to(x.dtype)

        dropped = (~flat_v).sum()
        if lay.all_group is not None:
            # pmean(aux) and psum(dropped) over every axis in one reduction.
            red = par.sum_replicated(torch.stack([aux.float(),
                                                  dropped.float()]),
                                     lay.all_group)
            aux = red[0] / lay.n_all
            dropped = red[1].round().to(torch.int64)
        # The token-split outputs back to every rank of the split.
        routed = par.gather_replicated(out, lay.tok_group)[:t]

        # Shared experts: dense, on every rank.
        if p.has_shared:
            routed = routed + swiglu(x, p.shared_gate, p.shared_up,
                                     p.shared_down).to(routed.dtype)
        return routed, {"aux_loss": aux, "dropped": dropped}

    def moe_fn(p, x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if dt.is_dtensor(x):
            return _on_blocks(run, p, x, cfg, mesh, lay, tuple(ep_axes),
                              redundancy, ffn_shard_axis)
        return run(p, x, cfg, lay)

    return moe_fn


def _on_blocks(run, p, x, cfg: ModelConfig, mesh, lay: _Layout,
               ep_axes: Tuple[str, ...], r: int, ffn_shard_axis):
    """The MoE function on a DTensor batch ``x`` (T, D) and DTensor weights,
    entered as JAX enters its ``shard_map``: each rank takes its block of
    the token rows (its batch block split over the axes the batch is
    replicated over), the router replicated, and its expert slots and
    F-shard placed as the plan says, and runs the routed experts on them
    with this layout's collectives. Serving with redundancy ``r``, slot s
    holds expert s // r: the weights enter as their specs place them, and
    each rank receives the experts of its slots that its own block lacks
    from ranks whose block holds them (:func:`_slot_experts`), as XLA
    partitions JAX's ``jnp.repeat`` into a collective permute. The shared
    experts run on the DTensors, tensor-parallel as their specs place
    them."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if mesh is None:
        raise ValueError("a DTensor batch needs the LEP function of a mesh")
    names = tuple(mesh.mesh_dim_names)
    rows = tuple(pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                 for pl in x.placements)
    tok_axes = tuple(a for a, pl in zip(names, rows)
                     if not isinstance(pl, Shard))
    lay = dataclasses.replace(
        lay, tok_group=par.axes_group(mesh, tok_axes),
        n_tok=par.axis_size(mesh, tok_axes),
        i_tok=par.axis_index(mesh, tok_axes))

    def placed(ffn_dim):
        return tuple(Shard(0) if a in ep_axes else
                     Shard(ffn_dim) if a == ffn_shard_axis else
                     Replicate() for a in names)

    ws = (p.w_gate, p.w_up, p.w_down)
    w_in = (placed(2), placed(2), placed(1))
    if r > 1:
        if torch.is_grad_enabled() and any(w.requires_grad for w in ws):
            raise ValueError("expert redundancy serves only; a training "
                             "step runs with redundancy=1")
        # Each weight's experts cut as its spec cuts them, its F-shard as
        # the plan's.
        w_in = tuple(tuple(pl if pl.is_shard(0) else Shard(fd)
                           if a == ffn_shard_axis else Replicate()
                           for a, pl in zip(names, w.placements))
                     for w, fd in zip(ws, (2, 2, 1)))
        moves = _redundancy_moves(mesh, w_in[0], cfg.num_experts, ep_axes, r,
                                  ffn_shard_axis)

    def body(x_loc, router, wg, wu, wd):
        if r > 1:
            wg, wu, wd = _slot_experts((wg, wu, wd), *moves)
        local = _LocalExperts(router, wg, wu, wd)
        out, aux = run(local, x_loc, cfg, lay, local_experts=True)
        return out, aux["aux_loss"], aux["dropped"]

    rep = dt.replicated(mesh)
    out, aux, dropped = local_map(
        body, out_placements=(rows, rep, rep),
        in_placements=(rows, rep) + w_in,
        redistribute_inputs=True, device_mesh=mesh)(x, p.router, *ws)
    if p.has_shared:
        out = out + swiglu(x, p.shared_gate, p.shared_up,
                           p.shared_down).to(out.dtype)
    return out, {"aux_loss": aux, "dropped": dropped}


def _redundancy_moves(mesh, placements, n_experts: int,
                      ep_axes: Tuple[str, ...], r: int,
                      ffn_shard_axis: Optional[str] = None):
    """Where each expert of this rank's slots comes from, when slot s holds
    expert s // r, the slots cut over ``ep_axes`` and the experts held in
    blocks cut over the axes where ``placements`` has ``Shard(0)`` (in the
    mesh's order): (this rank's first expert, the expert of each of its
    slots, [(expert, source rank)] to receive, [(expert, destination
    rank)] to send). A rank receives only the experts its own block lacks,
    each once, from a rank of its own F-shard; every rank computes the
    same plan, each transfer from the holder that sends least so far
    (lowest rank first), so the sends spread over the holders, and each
    pair lists its transfers in the same (expert) order."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    ranks = mesh.mesh.reshape(-1).tolist()
    coords = [dict(zip(names, c)) for c in
              itertools.product(*(range(n) for n in sizes.values()))]

    def flat(c, axes):
        i = 0
        for a in axes:
            i = i * sizes[a] + c[a]
        return i

    cut = tuple(a for a, pl in zip(names, placements) if pl.is_shard(0))
    per_block = n_experts // math.prod(sizes[a] for a in cut)
    n_ep = math.prod(sizes[a] for a in ep_axes)
    slots_loc = n_experts * r // n_ep
    shard = (ffn_shard_axis,) if ffn_shard_axis else ()
    block = {rk: flat(c, cut) for rk, c in zip(ranks, coords)}
    holders = {}
    for rk, c in zip(ranks, coords):
        holders.setdefault((block[rk], flat(c, shard)), []).append(rk)
    sent = dict.fromkeys(ranks, 0)
    moves = []                      # (source, destination, expert)
    for rk, c in zip(ranks, coords):
        lo = flat(c, ep_axes) * slots_loc
        for e in sorted({s // r for s in range(lo, lo + slots_loc)}):
            if block[rk] != e // per_block:
                src = min(holders[e // per_block, flat(c, shard)],
                          key=lambda h: (sent[h], h))
                sent[src] += 1
                moves.append((src, rk, e))
    me = dist.get_rank()
    lo = flat(coords[ranks.index(me)], ep_axes) * slots_loc
    return (block[me] * per_block,
            [s // r for s in range(lo, lo + slots_loc)],
            [(e, src) for src, dst, e in moves if dst == me],
            [(e, dst) for src, dst, e in moves if src == me])


def _slot_experts(ws, first: int, slot_expert, recv, send):
    """This rank's slots of each of the weights ``ws`` (its block of
    experts, from expert ``first`` on), its missing experts received and
    the ones other ranks need from it sent (``_redundancy_moves``)."""
    out = []
    for w in ws:
        got = {e: w.new_empty(w.shape[1:]) for e, _ in recv}
        par.send_recv([(w[e - first], dst) for e, dst in send],
                      [(got[e], src) for e, src in recv])
        out.append(torch.stack([got[e] if e in got else w[e - first]
                                for e in slot_expert]))
    return tuple(out)


@dataclasses.dataclass
class _LocalExperts:
    """A rank's blocks of one MoE layer's router and routed experts."""
    router: torch.Tensor
    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor
    has_shared: bool = False


def pick_lep_plan(cfg: ModelConfig, mesh, serving: bool = False) -> dict:
    """Keyword arguments of :func:`make_lep_moe_fn` for ``cfg``.

    ``mesh`` (a ``DeviceMesh`` or a mapping of axis sizes, such as
    ``launch.mesh.PRODUCTION_SHAPE``) gives the JAX package's plan, in the
    paper's order of preference: full-mesh EP with one or more experts per
    rank (the paper's LEP, §4.2); else, when serving, full-mesh EP through
    EPLB redundancy; else EP over ``model``, with the FFN sharded over
    ``data`` when the experts would not fit a device replicated over it
    (Kimi K2's 1T case).

    An int is a 1-D world of that many ranks (``group=``): one or more
    experts per rank, else, when serving, redundancy so the slots fill the
    world exactly; anything else needs a mesh."""
    e = cfg.num_experts
    if isinstance(mesh, int):
        if e % mesh == 0:
            return dict(redundancy=1)
        if serving and mesh % e == 0:
            return dict(redundancy=mesh // e)
        raise ValueError(f"{e} experts do not divide over a 1-D world of "
                         f"{mesh} ranks: plan over a mesh (its model-axis "
                         "EP)")
    shape = par.mesh_shape(mesh)
    full = tuple(a for a in shape if a != "pod")     # ("data", "model")
    n_full = math.prod(shape[a] for a in full)
    if e % n_full == 0:
        return dict(ep_axes=full, redundancy=1, ffn_shard_axis=None)
    if serving and n_full % e == 0:
        return dict(ep_axes=full, redundancy=n_full // e, ffn_shard_axis=None)
    # Model-axis EP; are the experts small enough to replicate over data?
    bytes_per_dev = (cfg.num_layers - cfg.first_k_dense) \
        * (e / shape["model"]) * 3 * cfg.d_model * cfg.d_ff * 2
    ffn_shard = "data" if bytes_per_dev > REPLICATE_LIMIT_BYTES else None
    return dict(ep_axes=("model",), redundancy=1, ffn_shard_axis=ffn_shard)
