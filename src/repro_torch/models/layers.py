"""Shared building blocks: RMSNorm, RoPE, SwiGLU, initializers."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import dtensor as dt


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * gain.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    dt = x.dtype
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    angles = positions.float()[..., None] * freqs              # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = dt.linear(x, w_gate)
    u = dt.linear(x, w_up)
    return dt.linear(F.silu(g) * u, w_down)


def dense_init(shape: Sequence[int], dtype: torch.dtype,
               generator: torch.Generator, device: torch.device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, scale) weights, ``scale = fan_in ** -0.5`` by default.
    Drawn directly in ``dtype`` on ``device`` from ``generator`` (which must
    live on that device), so a full-width bf16 layer needs no f32 copy."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / (fan_in ** 0.5)
    w = torch.randn(tuple(shape), generator=generator, device=device,
                    dtype=dtype)
    return w.mul_(scale)


def weight(shape: Sequence[int], dtype: torch.dtype, device: torch.device,
           generator: Optional[torch.Generator], kind: str = "dense",
           scale: Optional[float] = None) -> torch.nn.Parameter:
    """A frozen parameter: ones for ``kind="ones"`` (norm gains), zeros for
    ``kind="zeros"`` (biases), else :func:`dense_init`. Without a generator
    it is left uninitialized, for a caller that loads weights into it
    (``repro_torch.convert``)."""
    if generator is None:
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
    elif kind == "ones":
        t = torch.ones(tuple(shape), dtype=dtype, device=device)
    elif kind == "zeros":
        t = torch.zeros(tuple(shape), dtype=dtype, device=device)
    else:
        t = dense_init(shape, dtype, generator, device, scale)
    return torch.nn.Parameter(t, requires_grad=False)
