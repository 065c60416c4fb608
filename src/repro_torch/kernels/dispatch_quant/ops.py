"""Wrapper of the per-row INT8 quantization kernel
(``csrc/dispatch_quant.cu``).

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor launches
the hand-written kernel on PyTorch's current stream or raises: there is no
fallback. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch_quant.ref import dispatch_quantize_ref

#: kernel launches made by :func:`dispatch_quantize` in this process
LAUNCHES = 0

SMEM_LIMIT = 232_448          # shared memory one block may use
STATIC_SMEM = 32              # the kernel's per-warp maxima (8 floats)


def _lib() -> ctypes.CDLL:
    lib = build.load("dispatch_quant")
    if not getattr(lib, "_argtypes_set", False):
        fn = lib.dispatch_quantize
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def dispatch_quantize(x: torch.Tensor, pack: bool = False):
    """x (T, D) float32 or bfloat16, contiguous -> (q int8 (T, D), scale
    f32 (T, 1)), or with ``pack`` one int8 (T, D + 4) tensor whose last 4
    bytes per row are the row's f32 scale. See :func:`dispatch_quantize_ref`
    for the arithmetic."""
    global LAUNCHES
    if x.ndim != 2:
        raise ValueError(f"want x (T, D), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cpu":
        return dispatch_quantize_ref(x, pack)
    if x.device.type != "cuda":
        raise ValueError(f"dispatch_quantize runs on cpu or cuda, not {x.device}")
    t, d = x.shape
    if d < 1 or 4 * d + STATIC_SMEM > SMEM_LIMIT:
        raise ValueError(f"the kernel keeps a row in shared memory: D must "
                         f"lie in 1..{(SMEM_LIMIT - STATIC_SMEM) // 4}, "
                         f"got {d}")
    width = d + 4 if pack else d
    q = torch.empty((t, width), dtype=torch.int8, device=x.device)
    scale = None if pack else torch.empty((t, 1), dtype=torch.float32,
                                          device=x.device)
    if t == 0:
        return q if pack else (q, scale)
    vec = d % 8 == 0 and x.data_ptr() % 16 == 0 and width % 4 == 0 \
        and q.data_ptr() % 4 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().dispatch_quantize(
            x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
            None if scale is None else scale.data_ptr(), t, d, width,
            int(pack), int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"dispatch_quantize kernel launch failed with "
                           f"CUDA error {rc}")
    LAUNCHES += 1
    return q if pack else (q, scale)
