"""Wrapper of the absorbed-MLA decode attention kernel
(``csrc/mla_decode_attention.cu``).

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor launches
the hand-written kernel on PyTorch's current stream or raises: there is no
fallback. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mla_attention.ref import mla_decode_attention_ref

#: kernel launches made by :func:`mla_decode_attention` in this process
LAUNCHES = 0

HEADS_PER_BLOCK = 16          # must match kHeadsPerBlock in the source
MAX_SPLIT = 64                # must match kMaxSplit
SMEM_LIMIT = 232_448          # dynamic shared memory one block may use
_TILE = 32


def _lib() -> ctypes.CDLL:
    lib = build.load("mla_decode_attention")
    if not getattr(lib, "_argtypes_set", False):
        fn = lib.mla_decode_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mla_decode_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.mla_decode_attention_smem_bytes.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _check(q_lat, q_rope, cache, cache_len) -> None:
    if q_lat.ndim != 3 or q_rope.ndim != 3 or cache.ndim != 3:
        raise ValueError("want q_lat (B,H,R), q_rope (B,H,Dr), cache "
                         f"(B,S,R+Dr); got {tuple(q_lat.shape)}, "
                         f"{tuple(q_rope.shape)}, {tuple(cache.shape)}")
    b, h, r = q_lat.shape
    dr = q_rope.shape[-1]
    if q_rope.shape[:2] != (b, h) or cache.shape[0] != b \
            or cache.shape[2] != r + dr or cache.shape[1] < 1:
        raise ValueError(f"shape mismatch: q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, cache {tuple(cache.shape)}")
    if tuple(cache_len.shape) != (b,) or cache_len.dtype != torch.int32:
        raise ValueError(f"cache_len must be ({b},) int32, got "
                         f"{tuple(cache_len.shape)} {cache_len.dtype}")
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope), ("cache", cache)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {t.device for t in (q_lat, q_rope, cache, cache_len)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")


def n_split_for(b: int, h: int, s: int, n_sm: int) -> int:
    """Sequence pieces per request: about six blocks per SM (three waves of
    the two that fit at once, so ragged rows even out across the waves), at
    most one piece per 32-position tile and at most ``MAX_SPLIT``. The
    readings behind the rule, from ``chip_smoke.py --sweep`` on an H100,
    are in PERF.md."""
    blocks = b * (h // HEADS_PER_BLOCK)
    want = math.ceil(6 * n_sm / max(blocks, 1))
    return max(1, min(MAX_SPLIT, want, math.ceil(s / _TILE)))


def mla_decode_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                         cache: torch.Tensor, cache_len: torch.Tensor,
                         scale: float, n_split: Optional[int] = None
                         ) -> torch.Tensor:
    """q_lat (B,H,R), q_rope (B,H,Dr), cache (B,S,R+Dr) float32 contiguous,
    cache_len (B,) int32 -> o_lat (B,H,R) float32. Row ``b`` attends to
    positions ``0..min(cache_len[b], S-1)``. ``n_split`` overrides
    :func:`n_split_for` (a sweep of the split; the model never sets it)."""
    global LAUNCHES
    _check(q_lat, q_rope, cache, cache_len)
    dev = q_lat.device
    if dev.type == "cpu":
        return mla_decode_attention_ref(q_lat, q_rope, cache, cache_len, scale)
    if dev.type != "cuda":
        raise ValueError(f"mla_decode_attention runs on cpu or cuda, not {dev}")
    b, h, r = q_lat.shape
    s, dr = cache.shape[1], q_rope.shape[-1]
    if h % HEADS_PER_BLOCK or r % 4 or r > 512 or dr % 4:
        raise ValueError(f"the kernel takes H % {HEADS_PER_BLOCK} == 0, "
                         f"R % 4 == 0, R <= 512 and Dr % 4 == 0; got H={h}, "
                         f"R={r}, Dr={dr}")
    if any(t.data_ptr() % 16 for t in (q_lat, q_rope, cache)):
        raise ValueError("the kernel reads float4: q_lat, q_rope and cache "
                         "must start on 16-byte boundaries")
    lib = _lib()
    if lib.mla_decode_attention_smem_bytes(r, dr) > SMEM_LIMIT:
        raise ValueError(f"R+Dr={r + dr} needs more shared memory than a "
                         "block may use")
    if n_split is None:
        n_split = n_split_for(b, h, s, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    if not 1 <= n_split <= MAX_SPLIT:
        raise ValueError(f"n_split must lie in 1..{MAX_SPLIT}, got {n_split}")
    out = torch.empty((b, h, r), dtype=torch.float32, device=dev)
    part_acc = torch.empty((b, n_split, h, r), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b, n_split, h, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mla_decode_attention_f32(
            q_lat.data_ptr(), q_rope.data_ptr(), cache.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), b, h, s, r, dr, n_split, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"mla_decode_attention kernel launch failed with "
                           f"CUDA error {rc}")
    LAUNCHES += 1
    return out
