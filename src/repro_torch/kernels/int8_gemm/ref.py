"""Plain PyTorch version of the INT8 GEMM with the per-token x per-channel
rescale: the CPU path of the wrapper and the reference the CUDA kernel is
held against."""
from __future__ import annotations

import torch


def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                    x_scale: torch.Tensor, w_scale: torch.Tensor,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x_q (M, K) int8, w_q (K, N) int8 in any layout (the kernel's wrapper
    takes it K-major), x_scale (M, 1) f32 (per token),
    w_scale (1, N) f32 (per channel) -> (M, N) ``out_dtype``: the exact
    integer product, then ``(acc * x_scale) * w_scale`` in f32.

    The product is taken in float64, where it is exact (every partial sum
    is an integer below 2**53 for K < 2**39), because CUDA has no int32
    matrix product; rounding that integer to f32 equals rounding the int32
    sum."""
    acc = x_q.to(torch.float64) @ w_q.to(torch.float64)
    return (acc.to(torch.float32) * x_scale * w_scale).to(out_dtype)
