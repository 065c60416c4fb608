"""Attention helpers that MLA uses. GQA attention itself (prefill, decode
with ring buffers, extend) arrives with the dense-architecture slice.

Caches are updated in place: where the JAX package returns a new buffer
from ``dynamic_update_slice``/``.at[].set`` under a donating ``jit``, the
port writes into the tensor it was given and returns that same tensor.
"""
from __future__ import annotations

import os

import torch

NEG_INF = -1e30


def _pick_chunk(s: int, target: int = 512) -> int:
    """Query chunk of the chunked prefill loops: ``min(s, target)``, the
    last chunk taking what is left. The JAX package halves the chunk until
    it divides ``s`` (its ``scan`` needs equal chunks), which falls to a
    chunk of 1 for an odd ``s`` above ``target``; an eager loop has no such
    need."""
    return min(s, target)


def block_skip_enabled() -> bool:
    """Causal block-skipping: the flash-style prefill loop visits only kv
    blocks <= the query block, halving executed attention FLOPs against the
    masked full-S form. Opt-in via REPRO_BLOCK_SKIP=1."""
    return os.environ.get("REPRO_BLOCK_SKIP", "0") == "1"


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
    dropped, as an out-of-bounds scatter is."""
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


def is_ring(cfg, seq_len: int) -> bool:
    """Whether a GQA cache of ``seq_len`` would be a sliding-window ring
    buffer (the gate :func:`repro_torch.models.model.
    supports_prefill_continue` applies to every attention kind)."""
    return bool(cfg.sliding_window and seq_len > cfg.sliding_window)
