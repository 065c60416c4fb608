"""Plain PyTorch version of per-row INT8 quantization: the CPU path of the
wrapper and the reference the CUDA kernel is held against."""
from __future__ import annotations

import torch


def dispatch_quantize_ref(x: torch.Tensor, pack: bool = False):
    """x (T, D) float -> (q int8 (T, D), scale f32 (T, 1)) with
    ``scale = max(max|x|, 1e-8) / 127`` and ``q = clip(round(x / scale),
    -127, 127)`` (round half to even, as ``jnp.round``). With ``pack`` the
    result is one int8 (T, D + 4) tensor: the codes, then the 4 bytes of
    each row's f32 scale (``lep.py``'s bitcast payload tail)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    # A tensor divisor: on CUDA, dividing by a Python number multiplies by
    # its reciprocal, which is not the true quotient the kernel computes.
    scale = absmax.clamp_min(1e-8) / torch.tensor(127.0, device=x.device)
    q = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    if not pack:
        return q, scale
    return torch.cat([q, scale.reshape(-1).view(torch.int8).view(-1, 4)],
                     dim=-1)
