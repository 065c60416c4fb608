"""Wrapper of the INT8 GEMM kernel (``csrc/int8_gemm.cu``).

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor launches
the hand-written kernel on PyTorch's current stream or raises: there is no
fallback. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.int8_gemm.ref import int8_matmul_ref

#: kernel launches made by :func:`int8_matmul` in this process
LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("int8_gemm")
    if not getattr(lib, "_argtypes_set", False):
        lib.int8_gemm_plan.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.int8_gemm_plan.restype = None
        fn = lib.int8_gemm
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def launch_plan(m: int, n: int, k: int, n_sm: int) -> Tuple[bool, int, int, int]:
    """The kernel's own launch plan of an (m, k) x (k, n) product on a card
    with ``n_sm`` SMs: (decode tile shape, K splits, K tiles per split, K
    bytes per tile). Builds the library on first use."""
    plan = (ctypes.c_int * 4)()
    _lib().int8_gemm_plan(m, n, k, n_sm, plan)
    return bool(plan[0]), plan[1], plan[2], plan[3]


def _check(x_q, w_q, x_scale, w_scale, out_dtype) -> None:
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"want x_q (M, K) and w_q (K, N), got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    m, n = x_q.shape[0], w_q.shape[1]
    if tuple(x_scale.shape) != (m, 1) or tuple(w_scale.shape) != (1, n):
        raise ValueError(f"want x_scale ({m}, 1) and w_scale (1, {n}), got "
                         f"{tuple(x_scale.shape)} and {tuple(w_scale.shape)}")
    for name, t, dt in (("x_q", x_q, torch.int8), ("w_q", w_q, torch.int8),
                        ("x_scale", x_scale, torch.float32),
                        ("w_scale", w_scale, torch.float32)):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    devices = {t.device for t in (x_q, w_q, x_scale, w_scale)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x_q (M, K) int8, w_q (K, N) int8 (the JAX layout), x_scale (M, 1)
    f32, w_scale (1, N) f32, all contiguous -> (M, N) ``out_dtype`` (f32 or
    bf16): ``(float(x_q @ w_q) * x_scale) * w_scale``."""
    global LAUNCHES
    _check(x_q, w_q, x_scale, w_scale, out_dtype)
    dev = x_q.device
    if dev.type == "cpu":
        return int8_matmul_ref(x_q, w_q, x_scale, w_scale, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"int8_matmul runs on cpu or cuda, not {dev}")
    (m, k), n = x_q.shape, w_q.shape[1]
    if max(m, n, k) >= 2 ** 31 // 128:
        raise ValueError(f"the kernel indexes tiles with 32-bit ints: "
                         f"M={m}, N={n}, K={k} is too large")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = launch_plan(m, n, k, n_sm)[1]
    partial = (torch.zeros((m, n), dtype=torch.int32, device=dev)
               if splits > 1 else None)
    a_vec = k % 16 == 0 and x_q.data_ptr() % 16 == 0
    b_vec = n % 4 == 0 and w_q.data_ptr() % 4 == 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().int8_gemm(
            x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), m, n, k, n_sm,
            int(out_dtype == torch.bfloat16), int(a_vec), int(b_vec), stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out
