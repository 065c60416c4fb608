"""Staged hybrid parallelism (SP -> TP -> SP) for the MLA prefill, paper
§4.3.1: the port of the JAX package's ``core/hybrid_parallel.py``.

Pure data parallelism for the prefill's MLA suffers sequence-length skew
and too little concurrency (paper Fig. 16a). The staged scheme instead:

* **Stage 1 (SP)**: the tokens are sharded by sequence over the mesh axis;
  the per-token down-projections (``wq_a``, ``wkv_a``, MLAProlog's front
  half) are balanced whatever the request lengths.
* **All-gather** after the reduction: the latents (``q_lora_rank`` and
  ``kv_lora_rank + rope`` wide) are far narrower than ``d_model``, so the
  collective moves less than gathering the hidden states would.
* **Stage 2 (TP)**: heads are sharded over the axis; each rank holds the
  column blocks of ``wq_b``, ``wk_b`` and ``wv_b`` of its contiguous heads,
  expands the latents for them (the unabsorbed form) and attends over the
  whole sequence.
* **Stage 3 (SP)**, in one of two forms: ``oproj_mode="a2a"`` (the paper's
  Fig. 17) sends head shards to sequence shards by all-to-all and applies
  ``wo`` locally; ``"rs"`` applies ``wo``'s rows of the rank's heads and
  reduce-scatters the partial sums over the sequence (D values a token
  instead of H x v_head_dim).

The attention takes the port's query chunks, whose last one may be shorter
(``mla_causal_attention``), where JAX halves the chunk until it divides S.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import dtensor as dt
from repro_torch.configs.base import ModelConfig
from repro_torch.core import parallel as par
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.models.mla import mla_causal_attention


def mla_prefill_hybrid(p, x: torch.Tensor, cfg: ModelConfig, mesh,
                       axis: str = "model", oproj_mode: str = "a2a"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MLA layer's prefill over the ranks of ``mesh``'s ``axis``.
    ``p``: the layer's MLA weights; ``x``: (B, S, D), the normed layer input,
    the same on every rank (the port's activations are replicated). Each
    rank works on its sequence shard and its heads; the result is gathered
    back to every rank, as JAX's consumers read its sequence-sharded
    output, with the gradient rules of :mod:`repro_torch.core.parallel`:
    a loss on ``out`` gets the one global gradient on every rank. Returns
    (out (B, S, D), latent cache (B, S, kvr + rope)); the latent is the
    cache, which no loss reads.
    Raises when S or the head count does not divide over the axis.

    A DTensor ``x`` (a step traced over DTensors) enters through
    ``local_map`` as JAX enters its ``shard_map``: ``x`` and the
    down-projections replicated, ``wq_b``, ``wk_b`` and ``wv_b`` as the
    column blocks of this rank's heads, ``wo`` whole (``a2a``) or as the
    row block of its heads (``rs``); the outputs come back replicated."""
    if oproj_mode not in ("a2a", "rs"):
        raise ValueError(f"oproj_mode must be 'a2a' or 'rs', not "
                         f"{oproj_mode!r}")
    if dt.is_dtensor(x):
        return _on_blocks(p, x, cfg, mesh, axis, oproj_mode)
    b, s, d = x.shape
    h = cfg.num_heads
    m = par.axis_size(mesh, (axis,))
    if s % m or h % m:
        raise ValueError(f"S={s} and {h} heads must divide over the {m} "
                         f"ranks of axis {axis!r}")
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    group = par.axes_group(mesh, (axis,))
    j = par.axis_index(mesh, (axis,))
    s_loc, h_loc = s // m, h // m
    # Every weight is replicated and each rank uses it on its own share of
    # the work (a sequence shard, or its heads' blocks): grad_sum gives each
    # rank the whole gradient, as shard_map's transpose does.
    wq_a, q_ln, wkv_a, kv_ln, wq_b, wk_b, wv_b, wo = (
        par.grad_sum(w, group) for w in (p.wq_a, p.q_ln, p.wkv_a, p.kv_ln,
                                         p.wq_b, p.wk_b, p.wv_b, p.wo))
    x_loc = par.split_replicated(x, group, dim=1)
    pos_loc = torch.arange(j * s_loc, (j + 1) * s_loc, dtype=torch.int32,
                           device=x.device).expand(b, s_loc)

    # ---- Stage 1 (SP): latent down-projections on sequence shards.
    q_lat = rms_norm(x_loc @ wq_a, q_ln, cfg.norm_eps)
    kv = x_loc @ wkv_a
    c_kv = rms_norm(kv[..., :kvr], kv_ln, cfg.norm_eps)
    k_rope = apply_rope(kv[..., kvr:][:, :, None, :], pos_loc,
                        cfg.rope_theta)[:, :, 0, :]
    latent_loc = torch.cat([c_kv, k_rope], dim=-1)

    # ---- All-gather of the post-reduction latents.
    q_lat = par.all_gather(q_lat, group, dim=1)
    latent = par.all_gather(latent_loc, group, dim=1)

    # ---- Stage 2 (TP over heads): this rank's column blocks.
    qw = nope + rope
    q = (q_lat @ _block(wq_b, 1, j, h_loc * qw)).reshape(b, s, h_loc, qw)
    pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], pos,
                                               cfg.rope_theta)
    c_full, kr_full = latent[..., :kvr], latent[..., kvr:]
    k_nope = (c_full @ _block(wk_b, 1, j, h_loc * nope)).reshape(
        b, s, h_loc, nope)
    v = (c_full @ _block(wv_b, 1, j, h_loc * vd)).reshape(b, s, h_loc, vd)
    out_h = mla_causal_attention(q_nope, q_rope, k_nope, kr_full, v,
                                 cfg).to(x.dtype)            # (B,S,H_loc,vd)

    # ---- Stage 3 (back to SP).
    if oproj_mode == "a2a":
        # Paper Fig. 17: head shards -> sequence shards, then wo locally.
        parts = par.all_to_all(out_h.reshape(b, m, s_loc, h_loc, vd)
                               .transpose(0, 1), group)  # (m, B, S_loc, ...)
        out = parts.permute(1, 2, 0, 3, 4).reshape(b, s_loc, h * vd) @ wo
    else:
        # wo's rows of this rank's heads, then reduce-scatter over S.
        partial = out_h.reshape(b, s, h_loc * vd) \
            @ _block(wo, 0, j, h_loc * vd)
        out = par.reduce_scatter(partial, group, dim=1)
    return par.gather_replicated(out, group, dim=1), latent


def _block(w: torch.Tensor, dim: int, j: int, width: int) -> torch.Tensor:
    """Block ``j`` of ``width`` along ``dim`` of a whole weight; a weight
    already cut to one block (``local_map``'s) as it is."""
    if w.shape[dim] == width:
        return w
    return w.narrow(dim, j * width, width)


def _on_blocks(p, x, cfg: ModelConfig, mesh, axis: str, oproj_mode: str):
    """:func:`mla_prefill_hybrid` on DTensors, through ``local_map`` with
    JAX's in-specs (see there)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = tuple(mesh.mesh_dim_names)
    rep = dt.replicated(mesh)

    def on(d):
        return tuple(Shard(d) if a == axis else Replicate() for a in names)

    def body(x, *ws):
        w = dict(zip(_WEIGHTS, ws))
        return mla_prefill_hybrid(_Weights(**w), x, cfg, mesh, axis,
                                  oproj_mode)

    wo = rep if oproj_mode == "a2a" else on(0)
    return local_map(
        body, out_placements=(rep, rep),
        in_placements=(rep, rep, rep, on(1), rep, rep, on(1), on(1), wo),
        redistribute_inputs=True, device_mesh=mesh)(
        x, *(getattr(p, n) for n in _WEIGHTS))


_WEIGHTS = ("wq_a", "q_ln", "wq_b", "wkv_a", "kv_ln", "wk_b", "wv_b", "wo")


@dataclasses.dataclass
class _Weights:
    """A rank's blocks of one MLA layer's weights."""
    wq_a: torch.Tensor
    q_ln: torch.Tensor
    wq_b: torch.Tensor
    wkv_a: torch.Tensor
    kv_ln: torch.Tensor
    wk_b: torch.Tensor
    wv_b: torch.Tensor
    wo: torch.Tensor
