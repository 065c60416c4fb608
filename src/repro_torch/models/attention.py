"""GQA attention: chunked (memory-bounded) prefill, single-token decode
with sliding-window ring buffers, and multi-token cached extend; plus the
helpers MLA shares.

Variants (per ModelConfig): causal, bidirectional (encoder), sliding-window
(the serving path for long-context decode of full-attention archs), qk-norm
(Qwen3), QKV bias (Qwen2.5). The arithmetic is the JAX package's
(``repro/models/attention.py``): scores, softmax and the value product in
float32 over the grouped-head layout ``(B, KV, G, Sq, Skv)``, ``G = H //
KV``, masked with ``NEG_INF``.

Caches are updated in place: where the JAX package returns a new buffer
from ``dynamic_update_slice``/``.at[].set`` under a donating ``jit``, the
port writes into the tensor it was given and returns that same tensor.

Over DTensors (the dry run) attention runs on each rank's blocks through
``local_map``, as XLA partitions JAX's: prefill with the batch and the
heads local (no collective), decode over a cache whose sequence is sharded
with every head, each rank's block of positions giving a partial softmax
(o, lse) that :func:`merge_blocks` combines over the sequence axes by
all-reduces.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch import dtensor as dt
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm, weight, widened

NEG_INF = -1e30


class KVCache(NamedTuple):
    """Per-segment stacked KV cache. k/v: (L, B, S, KV, hd). The fields
    keep the JAX package's order, so tree walks visit K before V.

    Whether the cache is a sliding-window ring buffer is derived from
    (cfg, seq_len) via :func:`is_ring` when it is made, and from its shape
    (``S == cfg.sliding_window``) when it is decoded into, as in JAX."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor   # int32: tokens written (scalar, or (B,) in decode)

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def is_ring(cfg: ModelConfig, seq_len: int) -> bool:
    """Whether a GQA cache of ``seq_len`` is a sliding-window ring buffer
    of ``cfg.sliding_window`` slots."""
    return bool(cfg.sliding_window and seq_len > cfg.sliding_window)


class Attention(nn.Module):
    """One GQA layer's weights, in the JAX layout (activations @ W), under
    the keys of JAX's ``init_attention_params``."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        w = lambda shape, kind="dense": weight(  # noqa: E731
            shape, dtype, device, generator, kind)
        self.ln = w((d,), "ones")
        self.wq = w((d, h * hd))
        self.wk = w((d, kv * hd))
        self.wv = w((d, kv * hd))
        self.wo = w((h * hd, d))
        if cfg.qkv_bias:
            self.bq = w((h * hd,), "zeros")
            self.bk = w((kv * hd,), "zeros")
            self.bv = w((kv * hd,), "zeros")
        if cfg.qk_norm:
            self.q_norm = w((hd,), "ones")
            self.k_norm = w((hd,), "ones")


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, kv_out: bool = True):
    """x: (B,S,D) -> q (B,S,H,hd), k/v (B,S,KV,hd), with qk-norm + RoPE
    (RoPE for every attention kind, as in JAX). The three projections are
    one entry (over DTensors, x's gradient is reduced once for them).
    Without ``kv_out`` (no cache keeps the K/V), over DTensors whose query
    heads the model axes cut whole but whose K/V heads they do not
    (Qwen3-8B's 8 over 16), k and v may come out as the K/V head of each
    rank's query heads, repeated over the ranks that share it
    (``dtensor.linear``'s ``heads``): (B,S,R,hd), R the ranks that cut the
    heads, never gathered whole."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n = dt.column_ranks(p.wk)
    heads = (None, kv, kv) if not kv_out and h % n == 0 and kv % n \
        and n % kv == 0 else None
    q, k, v = dt.linear(x, (p.wq, p.wk, p.wv), heads=heads)
    if cfg.qkv_bias:
        bk, bv = (p.bk, p.bv) if k.shape[-1] == kv * hd else (
            dt.repeat_heads(t, kv) for t in (p.bk, p.bv))
        q, k, v = q + p.bq, k + bk, v + bv
    kv = k.shape[-1] // hd
    q = dt.fit_heads(q, h).reshape(b, s, h, hd)
    k = dt.fit_heads(k, kv).reshape(b, s, kv, hd)
    v = dt.fit_heads(v, kv).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,hd); k/v: (B,Skv,KV,hd); mask: (B|1, Sq, Skv) bool.
    Returns (B, Sq, H*hd) in q's dtype."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    q = dt.batch_like(dt.fit_heads(q, kvh, 2), k)
    qg = widened(q.reshape(b, sq, kvh, h // kvh, hd))
    scores = torch.einsum("bskgh,btkh->bkgst", qg, widened(k)) / (hd ** 0.5)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = dt.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, widened(v))
    return out.reshape(b, sq, h * hd).to(q.dtype)


def _sdpa_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_sdpa` over one block of the key positions, as a partial
    softmax: (o (B,Sq,H,hd) float32 (float64 in a float64 step),
    normalized within the block, lse (B,Sq,H) alike, the log of its
    denominator); a query row with no valid position in the block has o =
    0 and lse = -inf."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = widened(q.reshape(b, sq, kvh, h // kvh, hd))
    scores = torch.einsum("bskgh,btkh->bkgst", qg, widened(k)) / (hd ** 0.5)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, widened(v))
    full = mask.any(-1)                                       # (B|1, Sq)
    lse = torch.logsumexp(scores, dim=-1).permute(0, 3, 1, 2)  # (B,Sq,KV,G)
    lse = torch.where(full[:, :, None, None], lse, float("-inf"))
    out = torch.where(full[:, :, None, None, None], out, 0.0)
    return out.reshape(b, sq, h, hd), lse.reshape(b, sq, h)


def merge_blocks(o: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """The softmax over every rank's block of positions from each block's
    partial (o (..., H, D) normalized within the block, lse (..., H)):
    ``sum_r w_r o_r / sum_r w_r`` with ``w_r = exp(lse_r - max_r lse_r)``,
    the max and both sums all-reduced over ``group`` (the sequence axes).
    A block with no valid position (lse = -inf) weighs 0. On a group of
    one rank, ``o`` itself."""
    from repro_torch.core import parallel as par

    if group is None:
        return o
    w = torch.exp(lse - par.max_replicated(lse, group))
    num = par.sum_replicated(o * w[..., None], group)
    return num / par.sum_replicated(w, group)[..., None]


def _decode_seq_blocks(q: torch.Tensor, k, v, mask: torch.Tensor
                       ) -> torch.Tensor:
    """:func:`_sdpa` of one decode step over DTensor caches (B,S,KV,hd)
    whose batch and sequence are sharded: the query's heads come whole to
    every rank of its batch block, each rank attends its block of
    positions, and the blocks merge over the sequence axes
    (:func:`merge_blocks`). Returns (B, 1, H*hd) in q's dtype."""
    from repro_torch.core import parallel as par

    mesh = k.device_mesh
    seq = dt.shard_axes(k, 1)
    group = par.axes_group(mesh, seq)

    def body(q, k, v, mask):
        o, lse = _sdpa_block(q, k, v, mask)
        o = merge_blocks(o, lse, group)
        return o.reshape(q.shape[0], q.shape[1], -1).to(q.dtype)

    return dt.blockwise(
        body, mesh, (dt.batch_like(q, k), k, v, mask),
        [(0, None), (0, 1), (0, 1), (0 if mask.shape[0] > 1 else None, 2)],
        [(0, None)], dt.shard_axes(k, 0), seq)


def _pick_chunk(s: int, target: int = 512) -> int:
    """Query chunk of the chunked prefill loops: ``min(s, target)``, the
    last chunk taking what is left. The JAX package halves the chunk until
    it divides ``s`` (its ``scan`` needs equal chunks), which falls to a
    chunk of 1 for an odd ``s`` above ``target``; an eager loop has no such
    need."""
    return min(s, target)


def block_skip_enabled() -> bool:
    """Causal block-skipping: the flash-style prefill loop visits only kv
    blocks <= the query block (and within the sliding window), halving
    executed attention FLOPs against the masked full-S form. Opt-in via
    REPRO_BLOCK_SKIP=1."""
    return os.environ.get("REPRO_BLOCK_SKIP", "0") == "1"


def _flash_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ModelConfig, chunk: int) -> torch.Tensor:
    """Block-skipped causal attention with an online-softmax kv-block loop.
    q: (B,S,H,hd); k/v: (B,S,KV,hd). Query chunk ci attends kv blocks
    ``[lo(ci), ci]`` only, ``lo`` respecting the sliding window when one is
    configured (its mask then applies at every ``s``, as in JAX); the last
    chunk may be shorter. Returns (B, S, H*hd) in q's dtype."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    dev = q.device
    kf, vf = widened(k), widened(v)
    win = cfg.sliding_window
    outs = []
    for lo_q in range(0, s, chunk):
        hi_q = min(lo_q + chunk, s)
        n = hi_q - lo_q
        qg = widened(q[:, lo_q:hi_q].reshape(b, n, kvh, g, hd))
        q_pos = torch.arange(lo_q, hi_q, device=dev)
        m = torch.full((b, kvh, g, n, 1), NEG_INF, dtype=kf.dtype,
                       device=dev)
        l = torch.zeros((b, kvh, g, n, 1), dtype=kf.dtype, device=dev)
        acc = torch.zeros((b, kvh, g, n, hd), dtype=kf.dtype, device=dev)
        first = max(0, (lo_q - (win - 1)) // chunk) if win else 0
        for lo in range(first * chunk, lo_q + 1, chunk):
            hi = min(lo + chunk, s)
            scores = torch.einsum("bskgh,btkh->bkgst", qg,
                                  kf[:, lo:hi]) / (hd ** 0.5)
            kv_pos = torch.arange(lo, hi, device=dev)
            mask = kv_pos[None, :] <= q_pos[:, None]
            if win:
                mask &= kv_pos[None, :] > q_pos[:, None] - win
            scores = torch.where(mask, scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            pr = torch.exp(scores - m_new)
            l = l * alpha + pr.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bkgst,btkh->bkgsh", pr,
                                             vf[:, lo:hi])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, n, h * hd)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def attention_prefill(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                      positions: Optional[torch.Tensor] = None,
                      kv_out: bool = True):
    """Full-sequence attention, chunked over queries. Returns (out, (k, v)),
    or (out, None) without ``kv_out`` (no cache takes the K/V: a forward or
    a training step, where over DTensors each rank computes only the K/V
    heads its query heads read). The causal mask adds the sliding window
    only when ``s`` exceeds it."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, positions, kv_out)
    attend = _heads_local if dt.is_dtensor(q) else _attend_full
    return dt.linear(attend(q, k, v, cfg), p.wo), ((k, v) if kv_out
                                                   else None)


def _heads_local(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """:func:`_attend_full` over DTensors, on each rank's blocks as XLA
    partitions JAX's: the batch as the query's is sharded, the query heads
    as their projection cut them (over ``model`` where the specs cut its
    columns; whole on every rank where they replicate it, as they do a MoE
    segment's attention), the K/V heads likewise (each rank's own K/V
    head, repeated over the ranks that share it, where the model axis does
    not divide them: ``_project_qkv`` without ``kv_out``), or, where they
    are whole while the query's are cut (a cache's K/V taken whole by
    ``dtensor.fit_heads``), whole on every rank, which then attends with
    the K/V heads of its own query heads and sums their gradient over
    ``model``. No collective in the forward."""
    from repro_torch.core import parallel as par

    mesh = q.device_mesh
    h, kvh = q.shape[2], k.shape[2]
    heads = dt.shard_axes(q, 2)
    cut_kv = bool(heads) and dt.shard_axes(k, 2) == heads
    n = par.axis_size(mesh, heads)
    h0 = par.axis_index(mesh, heads) * (h // n) if heads else 0
    g = h // kvh

    def body(q, k, v):
        if heads and not cut_kv:
            hl = q.shape[2]
            if hl % g == 0 or g % hl == 0:     # whole groups, or one's part
                k, v = (t.narrow(2, h0 // g, max(1, hl // g)) for t in (k, v))
            else:                              # a K/V head per query head
                idx = torch.tensor([(h0 + i) // g for i in range(hl)],
                                   device=k.device)
                k, v = (t.index_select(2, idx) for t in (k, v))
        return _attend_full(q, k, v, cfg)

    kv_dims = (0, 2) if cut_kv else (0, None)
    return dt.blockwise(body, mesh, (q, k, v), [(0, 2), kv_dims, kv_dims],
                        [(0, 2)], dt.shard_axes(q, 0), heads)


def _attend_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Attention of :func:`attention_prefill`: q (B,S,H,hd), k/v
    (B,S,KV,hd) -> (B, S, H*hd) in q's dtype, chunked over queries (or the
    block-skipped loop)."""
    b, s = q.shape[:2]
    chunk = _pick_chunk(s)
    if cfg.attention_kind != "bidirectional" and block_skip_enabled():
        return _flash_causal(q, k, v, cfg, chunk)

    kf, vf = widened(k), widened(v)
    kv_pos = torch.arange(s, device=q.device)
    win = cfg.sliding_window
    outs = []
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        if cfg.attention_kind == "bidirectional":
            mask = torch.ones((1, hi - lo, s), dtype=torch.bool,
                              device=q.device)
        else:
            q_pos = torch.arange(lo, hi, device=q.device)
            mask = kv_pos[None, :] <= q_pos[:, None]
            if win and s > win:
                mask &= kv_pos[None, :] > q_pos[:, None] - win
            mask = mask[None]
        outs.append(_sdpa(q[:, lo:hi], kf, vf, mask))
    return torch.cat(outs, dim=1)


def _positions_of(cache_len: torch.Tensor, b: int) -> torch.Tensor:
    """cache_len: scalar or (B,) -> positions (B, 1) int32."""
    if cache_len.ndim == 0:
        return cache_len.reshape(1, 1).expand(b, 1).to(torch.int32)
    return cache_len[:, None].to(torch.int32)


def update_cache(cache: torch.Tensor, new: torch.Tensor,
                 slot: torch.Tensor) -> torch.Tensor:
    """Write the (B,1,...) entry into (B,S,...) in place at a scalar or
    per-request slot. A scalar slot is clamped into range as
    ``dynamic_update_slice`` does; per-request slots past the end are
    dropped, as an out-of-bounds scatter is. On a DTensor cache each rank
    writes the entries of its own block (:func:`_update_cache_block`)."""
    if dt.is_dtensor(cache):
        return _update_cache_block(cache, new, slot)
    b, s = cache.shape[0], cache.shape[1]
    rows = torch.arange(b, device=cache.device)
    if slot.ndim == 0:
        cache[rows, slot.clamp(0, s - 1).long().expand(b)] = \
            new[:, 0].to(cache.dtype)
        return cache
    keep = slot < s
    idx = torch.where(keep, slot, s - 1).long()
    old = cache[rows, idx]
    cache[rows, idx] = torch.where(
        keep.reshape((-1,) + (1,) * (old.ndim - 1)),
        new[:, 0].to(cache.dtype), old)
    return cache


def _update_cache_block(cache, new: torch.Tensor,
                        slot: torch.Tensor) -> torch.Tensor:
    """:func:`update_cache` into a DTensor cache, as XLA partitions a
    dynamic-update-slice into a sharded dimension: the entry is brought to
    the cache's placements with its sequence dimension replicated, and each
    rank writes the rows of its batch block whose slot falls in its
    sequence block, with no collective of the cache's size."""
    mesh = cache.device_mesh
    block = cache.to_local()
    new = dt.local(new, mesh, dt.without_shard(cache.placements, 1))
    slot = dt.local(slot, mesh, dt.replicated(mesh))
    b0, s0 = dt.shard_offsets(cache)[:2]
    b, s = block.shape[0], block.shape[1]
    if slot.ndim == 0:
        at = slot.clamp(0, cache.shape[1] - 1).expand(b)
        keep = torch.ones_like(at, dtype=torch.bool)
    else:
        at = slot[b0:b0 + b]
        keep = at < cache.shape[1]
    at = at - s0
    keep = keep & (at >= 0) & (at < s)
    idx = at.clamp(0, s - 1).long()
    rows = torch.arange(b, device=block.device)
    old = block[rows, idx]
    block[rows, idx] = torch.where(
        keep.reshape((-1,) + (1,) * (old.ndim - 1)),
        new[:, 0].to(block.dtype), old)
    return cache


def decode_valid_mask(cache_len: torch.Tensor, cap: int, ring: bool
                      ) -> torch.Tensor:
    """(B|1, 1, S) boolean mask of attendable cache slots (incl. the new
    token); cache_len may be per-request (B,)."""
    kv_idx = torch.arange(cap, dtype=torch.int32, device=cache_len.device)
    cl = cache_len.reshape(1) if cache_len.ndim == 0 else cache_len
    if ring:
        valid = kv_idx[None, :] <= torch.clamp(cl[:, None], max=cap - 1)
    else:
        valid = kv_idx[None, :] <= cl[:, None]
    return valid[:, None, :]


def decode_slot(cache_len: torch.Tensor, cap: int, ring: bool
                ) -> torch.Tensor:
    """The slot a decode step at ``cache_len`` writes: ``cache_len % cap``
    in a ring, else ``cache_len`` itself."""
    return cache_len % cap if ring else cache_len


def attention_decode(p: Attention, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_len: torch.Tensor,
                     cfg: ModelConfig, ring: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step: x (B,1,D) against caches (B,S,KV,hd) holding
    ``cache_len`` (scalar or (B,)) tokens. Writes the new K/V entry in place
    at :func:`decode_slot` and attends every valid slot of the whole
    buffer. Returns (out (B,1,D), cache_k, cache_v)."""
    b = x.shape[0]
    cap = cache_k.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, _positions_of(cache_len, b))
    slot = decode_slot(cache_len, cap, ring)
    update_cache(cache_k, k_new, slot)
    update_cache(cache_v, v_new, slot)
    attend = _decode_seq_blocks if dt.is_dtensor(cache_k) else _sdpa
    out = attend(q, cache_k, cache_v, decode_valid_mask(cache_len, cap, ring))
    return dt.linear(out, p.wo), cache_k, cache_v


def write_tokens(cache: torch.Tensor, new: torch.Tensor,
                 offset: torch.Tensor, positions: torch.Tensor) -> None:
    """Write ``new`` (B,S,...) into ``cache`` (B,cap,...) in place at
    ``positions`` (B,S) = ``offset`` (scalar or (B,)) + 0..S-1. A scalar
    offset's start is clamped into the buffer, as ``dynamic_update_slice``
    clamps it; per-request rows past the buffer are dropped, as an
    out-of-bounds scatter drops them. There, one token at a time, each
    row's entry goes to its (clamped) position or the row's old value is
    written back: no two writes of a call share an index, and no boolean
    mask makes the host wait for the device."""
    b, cap, s = cache.shape[0], cache.shape[1], new.shape[1]
    new = new.to(cache.dtype)
    if offset.ndim == 0:
        start = torch.clamp(offset, 0, max(cap - s, 0))
        cache[:, (start + torch.arange(s, device=cache.device)).long()] = new
        return
    rows = torch.arange(b, device=cache.device)
    keep = positions < cap
    idx = positions.clamp(max=cap - 1).long()
    shape = (-1,) + (1,) * (new.ndim - 2)
    for j in range(s):
        old = cache[rows, idx[:, j]]
        cache[rows, idx[:, j]] = torch.where(keep[:, j].reshape(shape),
                                             new[:, j], old)


def extend_positions(offset: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """Positions (B, S) int32 of S tokens from ``offset`` (scalar or
    (B,))."""
    steps = torch.arange(s, dtype=torch.int32, device=offset.device)
    if offset.ndim == 0:
        return (offset + steps).expand(b, s)
    return offset[:, None] + steps[None]


def attention_extend(p: Attention, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, offset, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-token cached attention: the S known tokens of x (B,S,D) at
    positions ``offset .. offset+S-1`` in one call -- the batched
    generalization of :func:`attention_decode`, for the chunked suffix
    prefill and, with a per-request ``offset`` (B,), the MTP fused verify.
    A scalar offset's write start is clamped into the buffer as
    ``dynamic_update_slice`` clamps it; per-request rows past the buffer
    are dropped. No ring-buffer support (as in JAX). Writes in place;
    returns (out (B,S,D), cache_k, cache_v)."""
    b, s, _ = x.shape
    cap = cache_k.shape[1]
    offset = torch.as_tensor(offset, dtype=torch.int32, device=x.device)
    positions = extend_positions(offset, b, s)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    write_tokens(cache_k, k_new, offset, positions)
    write_tokens(cache_v, v_new, offset, positions)
    kv_idx = torch.arange(cap, dtype=torch.int32, device=x.device)
    mask = kv_idx[None, None, :] <= positions[:, :, None]      # (B, S, cap)
    out = _sdpa(q, cache_k, cache_v, mask)
    return dt.linear(out, p.wo), cache_k, cache_v


def make_cache(cfg: ModelConfig, n_layers: int, batch: int, seq_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None) -> KVCache:
    """Zero K/V buffers of ``seq_len`` slots, or of ``sliding_window``
    slots when that makes a ring (:func:`is_ring`)."""
    cap = cfg.sliding_window if is_ring(cfg, seq_len) else seq_len
    shape = (n_layers, batch, cap, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))
