"""Multi-head Latent Attention (DeepSeek-style), per paper §4.2.2 / §4.3.1.

Two execution forms, equivalence-tested against each other:

* ``mla_prefill`` -- the *unabsorbed* form used for prefill: latents are
  expanded to full per-head K/V and the layer behaves as standard MHA.
  Chunked over queries like the JAX package's ``models/attention.py``,
  except that the last chunk may be shorter (``_pick_chunk``).
* ``mla_decode`` -- the *absorbed* form for decode: queries are pulled into
  latent space through W_UK so attention runs directly against the
  compressed (kv_lora_rank + rope) cache. Its inner loop is the hand-written
  CUDA kernel behind :func:`repro_torch.kernels.mla_attention.
  mla_decode_attention`, called on every decode step with per-request
  ``cache_len``.

The latent cache is (B, S, kv_lora_rank + qk_rope_head_dim). Decode and
extend write the new entries into the cache they are given, in place, and
return that same tensor (the JAX package returns a fresh buffer from a
donating ``jit``).

Over DTensors (the dry run) the attention runs on each rank's blocks
through ``local_map``, as XLA partitions JAX's: prefill with the batch and
the heads local; decode over a latent cache whose sequence is sharded,
each rank's block of positions through the kernel wrapper with
``return_lse`` and the blocks merged by all-reduces
(``attention.merge_blocks``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch import dtensor as dt
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mla_attention import ops as mla_ops
from repro_torch.models.attention import (NEG_INF, _pick_chunk, _positions_of,
                                          block_skip_enabled, extend_positions,
                                          merge_blocks, update_cache,
                                          write_tokens)
from repro_torch.models.layers import apply_rope, rms_norm, weight


class MLA(nn.Module):
    """One MLA layer's weights, in the JAX layout (activations @ W)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
        w = lambda shape, kind="dense": weight(  # noqa: E731
            shape, dtype, device, generator, kind)
        self.ln = w((d,), "ones")
        self.wq_a = w((d, qr))
        self.q_ln = w((qr,), "ones")
        self.wq_b = w((qr, h * (nope + rope)))
        self.wkv_a = w((d, kvr + rope))
        self.kv_ln = w((kvr,), "ones")
        self.wk_b = w((kvr, h * nope))
        self.wv_b = w((kvr, h * vd))
        self.wo = w((h * vd, d))


def init_mla_params(cfg: ModelConfig, device: torch.device,
                    dtype: torch.dtype,
                    generator: Optional[torch.Generator]) -> MLA:
    return MLA(cfg, device, dtype, generator)


def _mla_qkv_latent(p: MLA, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor):
    """Shared 'MLAProlog': projections + norms + RoPE."""
    b, s, _ = x.shape
    h = cfg.num_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = dt.linear(x, p.wq_a)
    q = rms_norm(q, p.q_ln, cfg.norm_eps)
    q = dt.fit_heads(dt.linear(q, p.wq_b), h).reshape(b, s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = dt.linear(x, p.wkv_a)
    c_kv, k_rope = kv[..., :cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
    c_kv = rms_norm(c_kv, p.kv_ln, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_flash_causal(q_nope, q_rope, k_nope, k_rope, vfull, scale: float,
                      chunk: int) -> torch.Tensor:
    """Block-skipped causal MLA attention (a query chunk visits only kv
    blocks <= its own, with an online softmax; the last chunk may be
    shorter). Returns (B,S,H,vd) f32."""
    b, s, h, _ = q_nope.shape
    vd = vfull.shape[-1]
    dev = q_nope.device
    knf, krf, vf = k_nope.float(), k_rope.float(), vfull.float()
    outs = []
    for lo_q in range(0, s, chunk):
        hi_q = min(lo_q + chunk, s)
        n = hi_q - lo_q
        qn = q_nope[:, lo_q:hi_q].float()
        qr = q_rope[:, lo_q:hi_q].float()
        q_pos = torch.arange(lo_q, hi_q, device=dev)
        m = torch.full((b, h, n, 1), NEG_INF, device=dev)
        l = torch.zeros((b, h, n, 1), device=dev)
        acc = torch.zeros((b, h, n, vd), device=dev)
        for lo in range(0, lo_q + 1, chunk):
            hi = min(lo + chunk, s)
            scores = (torch.einsum("bshe,bthe->bhst", qn, knf[:, lo:hi])
                      + torch.einsum("bshe,bte->bhst", qr, krf[:, lo:hi])
                      ) * scale
            kv_pos = torch.arange(lo, hi, device=dev)
            mask = kv_pos[None, :] <= q_pos[:, None]
            scores = torch.where(mask[None, None], scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            pr = torch.exp(scores - m_new)
            l = l * alpha + pr.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhst,bthe->bhse", pr,
                                             vf[:, lo:hi])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)                 # (b,h,n,vd)
        outs.append(out.transpose(1, 2))                      # (b,n,h,vd)
    return torch.cat(outs, dim=1)


def mla_prefill(p: MLA, x: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unabsorbed MHA-form prefill. Returns (out, latent (B,S,kvr+rope))."""
    b, s, _ = x.shape
    h = cfg.num_heads
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(p, x, cfg, positions)

    k_nope = dt.fit_heads(dt.linear(c_kv, p.wk_b), h).reshape(b, s, h, nope)
    vfull = dt.fit_heads(dt.linear(c_kv, p.wv_b), h).reshape(b, s, h, vd)
    out = mla_causal_attention(q_nope, q_rope, k_nope, k_rope, vfull, cfg)
    out = dt.linear(out.reshape(b, s, h * vd).to(x.dtype), p.wo)
    latent = torch.cat([c_kv, k_rope], dim=-1)
    return out, latent


def mla_causal_attention(q_nope, q_rope, k_nope, k_rope, vfull,
                         cfg: ModelConfig) -> torch.Tensor:
    """Causal attention of the unabsorbed form over the whole sequence:
    (B,S,H,nope), (B,S,H,rope), (B,S,H,nope), (B,S,rope), (B,S,H,vd) ->
    (B,S,H,vd) f32, in query chunks of ``_pick_chunk(S)``. Over DTensors,
    on each rank's batch and heads (:func:`_heads_local`)."""
    if dt.is_dtensor(q_nope):
        return _heads_local(q_nope, q_rope, k_nope, k_rope, vfull, cfg)
    s = q_nope.shape[1]
    scale = 1.0 / ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** 0.5)
    chunk = _pick_chunk(s)
    if block_skip_enabled():
        return _mla_flash_causal(q_nope, q_rope, k_nope, k_rope, vfull,
                                 scale, chunk)
    dev = q_nope.device
    knf, krf, vf = k_nope.float(), k_rope.float(), vfull.float()
    kv_pos = torch.arange(s, device=dev)
    outs = []
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        q_pos = torch.arange(lo, hi, device=dev)
        scores = (torch.einsum("bshe,bthe->bhst",
                               q_nope[:, lo:hi].float(), knf)
                  + torch.einsum("bshe,bte->bhst",
                                 q_rope[:, lo:hi].float(), krf)
                  ) * scale
        mask = kv_pos[None, :] <= q_pos[:, None]
        scores = torch.where(mask[None, None], scores, NEG_INF)
        probs = dt.softmax(scores, dim=-1)
        outs.append(torch.einsum("bhst,bthe->bshe", probs, vf))
    return torch.cat(outs, dim=1)


def _heads_local(q_nope, q_rope, k_nope, k_rope, vfull, cfg: ModelConfig):
    """:func:`mla_causal_attention` over DTensors, through ``local_map``
    as XLA partitions JAX's: the batch as the query's is sharded, the heads
    as their projection cut them (over ``model`` where the specs cut the
    columns of ``wq_b``, ``wk_b`` and ``wv_b``; whole on every rank where
    they replicate them, as in a MoE segment), the shared ``k_rope`` whole
    on every rank (its gradient summed over the heads' axes). No DTensor
    op sees a sharded head dimension, and the mixer issues no collective
    in the forward."""
    mesh = q_nope.device_mesh
    heads = (0, 2)
    return dt.blockwise(
        lambda *a: mla_causal_attention(*a, cfg), mesh,
        (q_nope, q_rope, k_nope, k_rope, vfull),
        [heads, heads, heads, (0, None), heads], [heads],
        dt.shard_axes(q_nope, 0), dt.shard_axes(q_nope, 2))


def _decode_seq_blocks(q_lat, q_rope, cache, rows_len: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """The kernel wrapper over a DTensor latent cache whose batch and
    sequence are sharded, as XLA partitions JAX's softmax over the sharded
    sequence: the query's heads come whole to every rank of its batch
    block (8 x 128 x 576 floats a layer for R1), each rank attends its
    block of positions ``[v0, v0 + S_l)`` with its rows' bounds
    ``cache_len - v0`` (an empty row where negative) and ``return_lse``,
    and the blocks' (o, lse) merge by all-reduces over the sequence axes.
    On CUDA blocks the kernel runs, on meta the plain version. Returns
    o_lat (B,H,R)."""
    from repro_torch.core import parallel as par

    mesh = cache.device_mesh
    seq = dt.shard_axes(cache, 1)
    group = par.axes_group(mesh, seq)
    v0 = dt.shard_offsets(cache)[1]

    def body(q_lat, q_rope, block, lens):
        o, lse = mla_ops.mla_decode_attention(
            q_lat.contiguous(), q_rope.contiguous(),
            block.float().contiguous(), (lens - v0).contiguous(), scale,
            return_lse=True)
        return merge_blocks(o, lse, group)

    rows = (0, None)
    return dt.blockwise(body, mesh, (dt.batch_like(q_lat, cache),
                                     dt.batch_like(q_rope, cache), cache,
                                     rows_len),
                        [rows, rows, (0, 1), rows], [rows],
                        dt.shard_axes(cache, 0), seq)


def mla_decode(p: MLA, x: torch.Tensor, cache: torch.Tensor,
               cache_len: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absorbed decode step: x (B,1,D), cache (B,S,kvr+rope), cache_len
    scalar or (B,). Writes the new entry at ``cache_len`` in place and runs
    the attention through the kernel wrapper (per-row ``cache_len``; the
    plain version on a CPU tensor). Returns (out (B,1,D), cache)."""
    b = x.shape[0]
    h = cfg.num_heads
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    positions = _positions_of(cache_len, b)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(p, x, cfg, positions)

    new_entry = torch.cat([c_kv, k_rope], dim=-1)            # (B,1,kvr+rope)
    cache = update_cache(cache, new_entry, cache_len)

    # Absorb W_UK into the query: q_lat (B,1,H,kvr)
    wk = dt.fit_heads(p.wk_b, h).reshape(kvr, h, nope)
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope.float(), wk.float())
    scale = 1.0 / ((nope + rope) ** 0.5)
    rows_len = cache_len.to(torch.int32).expand(b).contiguous()
    if dt.is_dtensor(cache):
        o_lat = _decode_seq_blocks(q_lat[:, 0], q_rope[:, 0].float(), cache,
                                   rows_len, scale)[:, None]
    else:
        o_lat = mla_ops.mla_decode_attention(
            q_lat[:, 0].contiguous(), q_rope[:, 0].float().contiguous(),
            cache.float().contiguous(), rows_len, scale)[:, None]

    wv = dt.fit_heads(p.wv_b, h).reshape(kvr, h, vd)
    out = torch.einsum("bshr,rhe->bshe", o_lat, wv.float())
    out = dt.linear(out.reshape(b, 1, h * vd).to(x.dtype), p.wo)
    return out, cache


def mla_extend(p: MLA, x: torch.Tensor, cache: torch.Tensor, offset,
               cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absorbed-form teacher-forced continuation, the S-token generalization
    of :func:`mla_decode`. x: (B,S,D) at positions ``offset..offset+S-1``;
    the first ``offset`` cache rows are valid. ``offset`` may be per-request
    (B,); rows whose positions fall past the cache are dropped. Writes into
    ``cache`` in place. Returns (out (B,S,D), cache)."""
    b, s, _ = x.shape
    h = cfg.num_heads
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    cap = cache.shape[1]
    offset = torch.as_tensor(offset, dtype=torch.int32, device=x.device)
    positions = extend_positions(offset, b, s)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(p, x, cfg, positions)
    write_tokens(cache, torch.cat([c_kv, k_rope], dim=-1), offset, positions)

    wk = p.wk_b.reshape(kvr, h, nope)
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope.float(), wk.float())
    scale = 1.0 / ((nope + rope) ** 0.5)
    ck = cache[..., :kvr].float()
    kr = cache[..., kvr:].float()
    scores = (torch.einsum("bshr,btr->bhst", q_lat, ck)
              + torch.einsum("bshe,bte->bhst", q_rope.float(), kr)) * scale
    kv_idx = torch.arange(cap, dtype=torch.int32, device=x.device)
    mask = kv_idx[None, None, :] <= positions[:, :, None]      # (B,S,cap)
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", probs, ck)          # (B,S,H,kvr)
    wv = p.wv_b.reshape(kvr, h, vd)
    out = torch.einsum("bshr,rhe->bshe", o_lat, wv.float())
    out = dt.linear(out.reshape(b, s, h * vd).to(x.dtype), p.wo)
    return out, cache


def make_mla_cache(cfg: ModelConfig, n_layers: int, batch: int, seq_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    return torch.zeros((n_layers, batch, seq_len, width), dtype=dtype,
                       device=device)
