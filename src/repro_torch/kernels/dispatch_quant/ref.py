"""Plain PyTorch version of per-row INT8 quantization: the CPU path of the
wrapper and the reference the CUDA kernel is held against. Beside it, a
plain model of the kernel's rounding rule (:func:`codes_by_reciprocal`,
:func:`quotient_codes`; on no path) and the rows that put it to the test at its rounding
boundaries (:func:`bf16_boundary_rows`, :func:`f32_boundary_rows`)."""
from __future__ import annotations

import numpy as np
import torch

#: Half-width of the kernel's window around each half-integer (kNearHalf =
#: 0.5 - NEAR_WINDOW in ``csrc/dispatch_quant.cu``).
NEAR_WINDOW = 2.0 ** -15
#: Unbiased exponents of absmax in :func:`bf16_boundary_rows`: bf16
#: subnormals, absmax just around the 1e-8 clamp, [1, 2) and the top binade.
BF16_EXPONENTS = (-133, -27, 0, 127)


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


def quotient_codes(x: torch.Tensor, scale: torch.Tensor,
                   inv: torch.Tensor) -> torch.Tensor:
    """The kernel's ``quotient_code`` (its split and rows paths):
    ``rint(RN(x / scale))`` as float for |x| <= absmax, found without
    dividing. With ``k = floor(|x| * inv)`` and ``h = k + 1/2`` (a short
    mantissa ending in 0, so ties go to it), RN(|x| / scale) is h exactly
    for |x| / scale within half the f32 spacing below or above h; ``d = |x|
    - h * scale``, rounded once (exact near h), against those half-spacings
    times scale decides: code k, k + 1, or the even one of the two."""
    xf = x.float()
    a = xf.abs()
    k = torch.floor(a * inv)
    h = k + 0.5
    lo = h - torch.nextafter(h, torch.zeros_like(h))
    hi = torch.nextafter(h, torch.full_like(h, float("inf"))) - h
    d = (a.double() - h.double() * scale.double()).float()   # one FFMA
    even = torch.where(torch.remainder(k, 2) == 0, k, k + 1)
    c = torch.where(d < -(0.5 * lo) * scale, k,
                    torch.where(d > (0.5 * hi) * scale, k + 1, even))
    return torch.where(xf < 0, -c, c)


def codes_by_reciprocal(x: torch.Tensor, window: float = NEAR_WINDOW):
    """The kernel's rounding rule on the CPU: with ``inv = fl(1/scale)`` and
    ``p = x * inv`` exact (float64 holds it; the kernel's FFMA rounds it
    once), the code is ``rint(p)``, except where ``|fl(p - rint(p))| > 0.5
    - window``: there it is ``rint(fl(x / scale))``, the quotient the plain
    version rounds (the kernel's ring takes the quotient for the whole quad
    of values, its other paths :func:`quotient_codes`: the same codes). Returns (codes int8 (T, D), the mask of
    elements that took the quotient). ``window = 0`` gives the bare
    reciprocal.

    Why ``NEAR_WINDOW = 2^-15`` gives the quotient's code everywhere: with
    ``|x| <= absmax`` and ``scale = fl(max(absmax, 1e-8) / 127)``, the true
    ratio ``z = x / scale`` has ``|z| < 127.00001``; p carries inv's one
    rounding, so ``|p - z| <= |z| 2^-24 < 2^-17``, and ``|fl(z) - z| <=
    2^-18``. Where p lies at least 2^-15 (less the 2^-25 of the rounded
    difference) from every half-integer, z and fl(z) lie on p's side of
    each, and all three round to one integer."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-8) / torch.tensor(127.0)
    inv = torch.tensor(1.0) / scale
    p = xf.double() * inv.double()
    r = torch.round(p)
    near = (p - r).float().abs() > 0.5 - window
    r = torch.where(near, torch.round(xf / scale).double(), r)
    return r.clamp_(-127, 127).to(torch.int8), near


def bf16_boundary_rows(d: int, seed: int = 0,
                       exponents=BF16_EXPONENTS) -> torch.Tensor:
    """bfloat16 rows (CPU) that hold, for each of the 128 bf16 mantissas of
    absmax at each of ``exponents`` (unbiased; -133 takes the subnormal
    binade), every bf16 value ``0 <= |x| <= absmax`` (signs drawn from
    ``seed``): chunks of ``d - 1`` values, each row led by absmax and padded
    with zeros. A last row is all zeros (absmax 0). Every quotient the
    kernel can meet in a bf16 row at these absmax is there."""
    rng = np.random.RandomState(seed)
    rows = []
    for e in exponents:
        biased = max(e + 127, 0)          # 0: the subnormal binade
        for mant in range(128):
            top = (biased << 7) | mant
            if top == 0:
                continue
            bits = np.arange(top + 1, dtype=np.int64)
            vals = bits[rng.permutation(top + 1)]
            n = -(-len(vals) // (d - 1))
            block = np.zeros((n, d), np.int64)
            block[:, 0] = top
            flat = np.zeros(n * (d - 1), np.int64)
            flat[:len(vals)] = vals
            block[:, 1:] = flat.reshape(n, d - 1)
            rows.append(block)
    rows.append(np.zeros((1, d), np.int64))
    bits = np.concatenate(rows)
    bits |= rng.randint(0, 2, bits.shape) << 15            # signs
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(
        torch.bfloat16)


def f32_boundary_rows(t: int, d: int, seed: int = 0) -> torch.Tensor:
    """float32 rows (CPU): normal values at magnitudes from 1e-3 to 1e3
    (one magnitude a row), a quarter of each row's elements replaced by
    ``(k + 1/2) * scale`` (k from -127 to 126, away from absmax) moved by 0
    to 3 ulp either way, where ``scale`` is the row's own."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(t, d) * 10.0 ** rng.uniform(-3, 3, (t, 1))).astype(
        np.float32)
    absmax = np.abs(x).max(axis=1)
    scale = np.maximum(absmax, np.float32(1e-8)) / np.float32(127.0)
    top = np.abs(x).argmax(axis=1)
    for i in range(t):
        pos = rng.choice(d, d // 4, replace=False)
        pos = pos[pos != top[i]]
        k = rng.randint(-127, 127, len(pos)).astype(np.float64)
        v = ((k + 0.5) * np.float64(scale[i])).astype(np.float32)
        for _ in range(3):
            step = rng.randint(-1, 2, len(v))
            v = np.where(step > 0, np.nextafter(v, np.float32(np.inf)),
                         np.where(step < 0, np.nextafter(v, np.float32(-np.inf)),
                                  v)).astype(np.float32)
        x[i, pos] = v
    return torch.from_numpy(x)
