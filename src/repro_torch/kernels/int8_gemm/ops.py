"""Wrapper of the INT8 GEMM kernel (``csrc/int8_gemm.cu``).

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor launches
the hand-written kernel on PyTorch's current stream or raises: there is no
fallback. ``LAUNCHES`` counts kernel launches, ``PADDED_CALLS`` the calls
that had to copy their operands into padded, aligned buffers first.

The weight ``w_q`` (K, N) must be stored K-major, on every device: the
``.t()`` view of a contiguous (N, K) tensor, ``stride() == (1, K)``
(:func:`repro_torch.quant.int8.k_major` makes one). That is the layout the
kernel's TMA loads feed to ``wgmma``; the wrapper never transposes it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.int8_gemm.ref import int8_matmul_ref

#: kernel launches made by :func:`int8_matmul` in this process
LAUNCHES = 0
#: CUDA calls whose operands were copied into padded, aligned buffers
PADDED_CALLS = 0
#: TMA reads rows whose pitch and base are multiples of this many bytes
TMA_ALIGN = 16
_ENCODE_ERROR = 1000          # int8_gemm's code for a failed tensor-map encode


class Plan(NamedTuple):
    """The kernel's launch plan of one product shape (``int8_gemm_plan``)."""
    swap_ab: bool          # decode: out^T = W x^T, the weight as wgmma's A
    tile_m: int            # output tile, M x N
    tile_n: int
    splits: int            # K splits, one thread-block cluster per tile
    k_blocks_per_split: int
    block_k: int           # K bytes per pipeline stage
    stages: int


def _lib() -> ctypes.CDLL:
    lib = build.load("int8_gemm")
    if not getattr(lib, "_argtypes_set", False):
        lib.int8_gemm_plan.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.int8_gemm_plan.restype = None
        fn = lib.int8_gemm
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def launch_plan(m: int, n: int, k: int, n_sm: int) -> Plan:
    """The kernel's own launch plan of an (m, k) x (k, n) product on a card
    with ``n_sm`` SMs (``int8_matmul`` does not need it: ``int8_gemm``
    plans inside). Builds the library on first use."""
    plan = (ctypes.c_int * 7)()
    _lib().int8_gemm_plan(m, n, k, n_sm, plan)
    return Plan(bool(plan[0]), *plan[1:7])


def needs_padding(k: int, x_ptr: int, w_ptr: int) -> bool:
    """Whether a product must be padded before TMA can read it: a row pitch
    of K bytes that is not a multiple of 16, or an operand base that is not
    16-byte aligned."""
    return k % TMA_ALIGN != 0 or x_ptr % TMA_ALIGN != 0 \
        or w_ptr % TMA_ALIGN != 0


def _padded(x_q: torch.Tensor, w_q: torch.Tensor):
    """Zero-padded, aligned copies: x_q (M, K') and w_q as the transpose of
    a fresh (N, K'), K' = K rounded up to 16. The padding adds zeros to
    every sum, so the kernel's result is unchanged."""
    (m, k), n = x_q.shape, w_q.shape[1]
    kp = -(-k // TMA_ALIGN) * TMA_ALIGN
    xp = torch.zeros((m, kp), dtype=torch.int8, device=x_q.device)
    xp[:, :k] = x_q
    wp = torch.zeros((n, kp), dtype=torch.int8, device=w_q.device)
    wp[:, :k] = w_q.t()
    return xp, wp.t()


def is_k_major(w_q: torch.Tensor) -> bool:
    """Whether ``w_q`` (K, N) is the ``.t()`` view of a contiguous (N, K)
    tensor."""
    return w_q.t().is_contiguous()


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
        if t is w_q:
            if not is_k_major(w_q):
                raise ValueError(
                    f"w_q must be stored K-major: the .t() view of a "
                    f"contiguous (N, K) tensor, stride (1, {w_q.shape[0]}); "
                    f"got stride {tuple(w_q.stride())} (quant.k_major makes "
                    f"one)")
        elif not t.is_contiguous():
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
    """x_q (M, K) int8 contiguous, w_q (K, N) int8 stored K-major,
    x_scale (M, 1) and w_scale (1, N) f32 contiguous -> (M, N)
    ``out_dtype`` (f32 or bf16): ``(float(x_q @ w_q) * x_scale) *
    w_scale``."""
    global LAUNCHES, PADDED_CALLS
    _check(x_q, w_q, x_scale, w_scale, out_dtype)
    dev = x_q.device
    if dev.type in ("cpu", "meta"):
        return int8_matmul_ref(x_q, w_q, x_scale, w_scale, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"int8_matmul runs on cpu or cuda (meta traces "
                         f"shapes only), not {dev}")
    (m, k), n = x_q.shape, w_q.shape[1]
    if max(m, n, k) >= 2 ** 31 // 128:
        raise ValueError(f"the kernel indexes tiles with 32-bit ints: "
                         f"M={m}, N={n}, K={k} is too large")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    if needs_padding(k, x_q.data_ptr(), w_q.data_ptr()):
        # Not on any served shape (every K of the served models is a
        # multiple of 16 and PyTorch's allocator aligns): the same kernel on
        # zero-padded, aligned copies.
        x_q, w_q = _padded(x_q, w_q)
        k = x_q.shape[1]
        PADDED_CALLS += 1
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().int8_gemm(
            x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(), m, n, k, n_sm,
            int(out_dtype == torch.bfloat16), stream)
    if rc >= _ENCODE_ERROR:
        raise RuntimeError(f"int8_matmul: cuTensorMapEncodeTiled failed "
                           f"with CUresult {rc - _ENCODE_ERROR}")
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out
