"""Plain PyTorch version of absorbed-MLA decode attention: the CPU path of
the wrapper and the reference the CUDA kernel is held against.

Beside it, two emulations of what the kernel does differently, for the CPU
tests: ``mla_decode_attention_pieces`` (its cut into pieces, per-segment
partials and merge, ``plan.py``) and ``mla_decode_attention_3xtf32`` (its
products in 3xTF32 on the tensor cores)."""
from __future__ import annotations

import torch

from repro_torch.kernels.mla_attention import plan
from repro_torch.models.attention import NEG_INF, decode_valid_mask

_TF32_MASK = -8192            # 0xffffe000: the sign, exponent, 10 mantissa bits


def mla_decode_attention_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                             cache: torch.Tensor, cache_len: torch.Tensor,
                             scale: float, return_lse: bool = False):
    """q_lat (B,H,R), q_rope (B,H,Dr), cache (B,S,R+Dr) f32, cache_len (B,)
    int32 -> o_lat (B,H,R) f32, and with ``return_lse`` lse (B,H) f32, the
    log-sum-exp of the row's scaled scores. Row ``b`` attends to positions
    ``0..min(cache_len[b], S-1)``; a negative ``cache_len[b]`` is an empty
    row: o_lat 0, lse -inf."""
    r = q_lat.shape[-1]
    s = cache.shape[1]
    ck = cache[..., :r]
    kr = cache[..., r:]
    scores = (torch.einsum("bhr,btr->bht", q_lat, ck)
              + torch.einsum("bhe,bte->bht", q_rope, kr)) * scale
    valid = decode_valid_mask(cache_len, s, ring=True)          # (B,1,S)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    full = cache_len[:, None] >= 0                              # (B,1)
    o_lat = torch.where(full[..., None],
                        torch.einsum("bht,btr->bhr", probs, ck), 0.0)
    if not return_lse:
        return o_lat
    return o_lat, torch.where(full, torch.logsumexp(scores, dim=-1),
                              float("-inf"))


def mla_decode_attention_pieces(q_lat: torch.Tensor, q_rope: torch.Tensor,
                                cache: torch.Tensor, cache_len: torch.Tensor,
                                scale: float, n_pieces: int,
                                return_lse: bool = False):
    """The kernel's split and merge in plain PyTorch (f32 products): a
    partial (m, l, acc) per segment of ``plan.segments`` in its slot, then
    per row the merge pass's weighting over ``plan.row_pieces``, an empty
    piece weighing 0, and with ``return_lse`` the row's lse, max m +
    log(sum w l); an empty row (no tile) is o 0, lse -inf. Slots no
    segment writes hold NaN, so a merge that read one would show it."""
    b, h, r = q_lat.shape
    s = cache.shape[1]
    lens = [int(c) for c in cache_len.tolist()]
    starts = plan.tile_starts(lens, s)
    total = starts[-1]
    slots = n_pieces + b - 1
    part_acc = torch.full((slots, h, r), float("nan"))
    part_m = torch.full((slots, h), float("nan"))
    part_l = torch.full((slots, h), float("nan"))
    q = torch.cat([q_lat, q_rope], dim=-1)
    for seg in plan.segments(lens, s, n_pieces):
        kv = cache[seg.row, seg.start:seg.end]                     # (n, W)
        sc = (q[seg.row] @ kv.T) * scale                           # (H, n)
        m = sc.max(dim=-1).values
        e = torch.exp(sc - m[:, None])
        part_m[seg.slot], part_l[seg.slot] = m, e.sum(dim=-1)
        part_acc[seg.slot] = e @ kv[:, :r]
    out = torch.zeros(b, h, r)
    lse = torch.full((b, h), float("-inf"))
    for row in range(b):
        if starts[row] == starts[row + 1]:               # an empty row
            continue
        pieces = [p for p in plan.row_pieces(starts, row, n_pieces)
                  if plan.piece_start(p, total, n_pieces)
                  < plan.piece_start(p + 1, total, n_pieces)]
        m_max = torch.stack([part_m[p + row] for p in pieces]).max(dim=0).values
        num = torch.zeros(h, r)
        den = torch.zeros(h)
        for p in pieces:
            l = part_l[p + row]
            w = torch.where(l > 0, torch.exp(part_m[p + row] - m_max), 0.0)
            num += w[:, None] * part_acc[p + row]
            den += w * l
        out[row] = num / den[:, None]
        lse[row] = m_max + torch.log(den)
    return (out, lse) if return_lse else out


def split_tf32(x: torch.Tensor):
    """The kernel's ``split_tf32`` on f32 bits: ``hi`` is ``x`` rounded to
    TF32 (half a TF32 ulp added to the bits, the 13 below it cleared),
    ``lo = x - hi`` exactly."""
    hi = ((x.view(torch.int32) + 0x1000) & _TF32_MASK).view(torch.float32)
    return hi, x - hi


def tf32_operand(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 register it takes as TF32: the
    top 19 bits (the rest truncated)."""
    return (x.view(torch.int32) & _TF32_MASK).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3
                ) -> torch.Tensor:
    """``a @ b`` as the tensor cores compute it in TF32: with ``passes=3``
    hi.hi + hi.lo + lo.hi (each lo truncated as the tensor core reads it),
    with ``passes=1`` hi.hi alone. TF32 products are exact in f32, so f32
    products of the parts give the tensor core's terms, summed in f32."""
    ah, al = split_tf32(a.contiguous())
    bh, bl = split_tf32(b.contiguous())
    if passes == 1:
        return ah @ bh
    if passes != 3:
        raise ValueError(f"passes is 1 or 3, got {passes}")
    return tf32_operand(al) @ bh + ah @ tf32_operand(bl) + ah @ bh


def mla_decode_attention_3xtf32(q_lat: torch.Tensor, q_rope: torch.Tensor,
                                cache: torch.Tensor, cache_len: torch.Tensor,
                                scale: float, passes: int = 3
                                ) -> torch.Tensor:
    """The function with both products (the scores over R + Dr channels,
    then P . c_kv) taken as ``tf32_matmul`` takes them; softmax in f32."""
    r = q_lat.shape[-1]
    s = cache.shape[1]
    q = torch.cat([q_lat, q_rope], dim=-1)                      # (B,H,W)
    scores = tf32_matmul(q, cache.transpose(1, 2), passes) * scale
    valid = decode_valid_mask(cache_len, s, ring=True)
    probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    return tf32_matmul(probs, cache[..., :r], passes)
