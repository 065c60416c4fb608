"""Plain PyTorch version of absorbed-MLA decode attention: the CPU path of
the wrapper and the reference the CUDA kernel is held against."""
from __future__ import annotations

import torch

from repro_torch.models.attention import NEG_INF, decode_valid_mask


def mla_decode_attention_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                             cache: torch.Tensor, cache_len: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """q_lat (B,H,R), q_rope (B,H,Dr), cache (B,S,R+Dr) f32, cache_len (B,)
    int32 -> o_lat (B,H,R) f32. Row ``b`` attends to positions
    ``0..min(cache_len[b], S-1)``."""
    r = q_lat.shape[-1]
    s = cache.shape[1]
    ck = cache[..., :r]
    kr = cache[..., r:]
    scores = (torch.einsum("bhr,btr->bht", q_lat, ck)
              + torch.einsum("bhe,bte->bht", q_rope, kr)) * scale
    valid = decode_valid_mask(cache_len, s, ring=True)          # (B,1,S)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bht,btr->bhr", probs, ck)
