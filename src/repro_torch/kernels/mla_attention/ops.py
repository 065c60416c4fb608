"""Wrapper of the absorbed-MLA decode attention kernel
(``csrc/mla_decode_attention.cu``).

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor launches
the hand-written kernel on PyTorch's current stream or raises: there is no
fallback. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mla_attention import plan
from repro_torch.kernels.mla_attention.ref import mla_decode_attention_ref

#: kernel launches made by :func:`mla_decode_attention` in this process
LAUNCHES = 0

SMEM_LIMIT = 232_448          # dynamic shared memory one block may use
MAX_R, MAX_W = 512, 576       # kPvCols * kWarps and kMaxW in the source


def _lib() -> ctypes.CDLL:
    lib = build.load("mla_decode_attention")
    if not getattr(lib, "_argtypes_set", False):
        fn = lib.mla_decode_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mla_decode_attention_smem_bytes.argtypes = [ctypes.c_int]
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
    # The kernel takes float32; the plain version also float64 on the CPU
    # (a float64 step's), all three alike.
    want = torch.float64 if q_lat.dtype == torch.float64 \
        and q_lat.device.type == "cpu" else torch.float32
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope), ("cache", cache)):
        if t.dtype != want:
            raise ValueError(f"{name} must be float32 (on the CPU all three "
                             f"may be float64), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {t.device for t in (q_lat, q_rope, cache, cache_len)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")


def mla_decode_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                         cache: torch.Tensor, cache_len: torch.Tensor,
                         scale: float, n_pieces: Optional[int] = None,
                         return_lse: bool = False):
    """q_lat (B,H,R), q_rope (B,H,Dr), cache (B,S,R+Dr) float32 contiguous,
    cache_len (B,) int32 -> o_lat (B,H,R) float32. Row ``b`` attends to
    positions ``0..min(cache_len[b], S-1)``; a negative ``cache_len[b]`` is
    an empty row, whose o_lat is 0. With ``return_lse`` it returns (o_lat,
    lse): lse (B,H) float32 is the log of the softmax's denominator in the
    scores' scale, -inf on an empty row, so that blocks of one sequence
    merge (a cache sharded on its sequence). ``n_pieces`` overrides
    :func:`plan.n_pieces_for` (a sweep of the cut; the model never sets
    it). The kernel cuts the batch's tiles into pieces on the device
    (``plan.py``); the host never reads ``cache_len``."""
    global LAUNCHES
    _check(q_lat, q_rope, cache, cache_len)
    dev = q_lat.device
    if dev.type in ("cpu", "meta"):
        return mla_decode_attention_ref(q_lat, q_rope, cache, cache_len, scale,
                                        return_lse)
    if dev.type != "cuda":
        raise ValueError(f"mla_decode_attention runs on cpu or cuda (meta "
                         f"traces shapes only), not {dev}")
    b, h, r = q_lat.shape
    s, dr = cache.shape[1], q_rope.shape[-1]
    if r % 4 or r > MAX_R or dr % 4 or r + dr > MAX_W:
        raise ValueError(f"the kernel takes R % 4 == 0, R <= {MAX_R}, "
                         f"Dr % 4 == 0 and R + Dr <= {MAX_W}; got R={r}, "
                         f"Dr={dr}")
    if any(t.data_ptr() % 16 for t in (q_lat, q_rope, cache)):
        raise ValueError("the kernel reads float4: q_lat, q_rope and cache "
                         "must start on 16-byte boundaries")
    lib = _lib()
    if lib.mla_decode_attention_smem_bytes(b) > SMEM_LIMIT:
        raise ValueError(f"a batch of {b} rows needs more shared memory than "
                         "a block may use")
    if n_pieces is None:
        n_pieces = plan.n_pieces_for(b, h, s, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    if not 1 <= n_pieces <= plan.MAX_PIECES:
        raise ValueError(f"n_pieces must lie in 1..{plan.MAX_PIECES}, got "
                         f"{n_pieces}")
    # One scratch allocation: the partial acc (slots, H, R), (m, l) (slots,
    # H, 2) and the kernel's cut, B + 1 int32 tile starts.
    out = torch.empty((b, h, r), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h), dtype=torch.float32, device=dev) \
        if return_lse else None
    slots = n_pieces + b - 1
    scratch = torch.empty(slots * h * (r + 2) + b + 1, dtype=torch.float32,
                          device=dev)
    part_acc = scratch.data_ptr()
    part_ml = part_acc + 4 * slots * h * r
    tile_starts = part_ml + 4 * slots * h * 2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mla_decode_attention_f32(
            q_lat.data_ptr(), q_rope.data_ptr(), cache.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), part_acc, part_ml,
            tile_starts, b, h, s, r, dr, n_pieces, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"mla_decode_attention kernel launch failed with "
                           f"CUDA error {rc}")
    LAUNCHES += 1
    return (out, lse) if return_lse else out
