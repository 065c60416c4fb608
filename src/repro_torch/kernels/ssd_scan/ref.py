"""Plain PyTorch version of the Mamba2 SSD chunked scan: the CPU path of
the wrapper, the model's ``ssd_chunked``, and the reference the CUDA kernel
is held against.

It is written as the kernel's stages, each over every chunk at once, in the
layouts of the kernel's scratch: :func:`chunk_cb` (C.B^T per batch and
chunk), :func:`chunk_cumsum` and :func:`chunk_states` (each chunk's own
state from zero), :func:`state_passing` (the only loop over chunks: the
state entering each chunk) and :func:`chunk_output`, composed by
:func:`ssd_stages`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def split_chunks(x, dt, bmat, cmat, chunk: int):
    """Pads S to ``nc`` whole chunks of ``q = min(chunk, S)`` rows, the
    rows past S with dt = 0 and zero x, B and C, and splits it: x (b,nc,q,h,p),
    dt (b,nc,q,h), B and C (b,nc,q,n), in the dtype of ``x``."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = max(1, min(chunk, s))
    nc = -(-s // q)
    pad = nc * q - s
    x, dt, bmat, cmat = (t.to(x.dtype) for t in (x, dt, bmat, cmat))
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    return (x.reshape(b, nc, q, h, p), dt.reshape(b, nc, q, h),
            bmat.reshape(b, nc, q, n), cmat.reshape(b, nc, q, n))


def chunk_cb(bc: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    """C.B^T of every (batch, chunk), shared by all heads: (b,nc,q,q)."""
    return torch.einsum("bcqn,bckn->bcqk", cc, bc)


def chunk_cumsum(dtc: torch.Tensor, a_log: torch.Tensor) -> torch.Tensor:
    """cum = cumsum over each chunk of dt * -exp(a_log): (b,nc,h,q). Rows
    past S (dt = 0) repeat the chunk's last value, cum_last."""
    a = -torch.exp(a_log.to(dtc.dtype))
    return torch.cumsum(dtc * a, dim=2).transpose(2, 3)


def chunk_states(xc: torch.Tensor, dtc: torch.Tensor, bc: torch.Tensor,
                 cum: torch.Tensor) -> torch.Tensor:
    """Each chunk's own state from a zero state, s_c = sum_t exp(cum_last -
    cum_t) dt_t x_t (x) B_t: (b,nc,h,p,n)."""
    scale = torch.exp(cum[..., -1:] - cum) * dtc.transpose(2, 3)  # (b,nc,h,q)
    u = scale.transpose(2, 3)[..., None] * xc                      # (b,nc,q,h,p)
    return torch.einsum("bcqhp,bcqn->bchpn", u, bc)


def state_passing(states: torch.Tensor, cum: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The state recurrence across chunks, h_c = exp(cum_last,c) h_{c-1} +
    s_c from h_{-1} = 0. Returns (the state entering each chunk, h_{c-1}:
    (b,nc,h,p,n); the last state h_{nc-1}: (b,h,p,n))."""
    decay = torch.exp(cum[..., -1])                          # (b,nc,h)
    hstate = torch.zeros_like(states[:, 0])
    entering = []
    for c in range(states.shape[1]):
        entering.append(hstate)
        hstate = hstate * decay[:, c, :, None, None] + states[:, c]
    return torch.stack(entering, 1), hstate


def chunk_output(xc: torch.Tensor, dtc: torch.Tensor, cc: torch.Tensor,
                 cb: torch.Tensor, cum: torch.Tensor, h_in: torch.Tensor
                 ) -> torch.Tensor:
    """y_t = exp(cum_t) C_t.h_{c-1} + sum_{s<=t} C.B^T[t,s] exp(cum_t -
    cum_s) dt_s x_s for every chunk: (b,nc,q,h,p)."""
    q = xc.shape[2]
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cc, h_in) \
        * torch.exp(cum).transpose(2, 3)[..., None]
    # Masked before the exponential: above the diagonal cum_t - cum_s is
    # positive and its exp may overflow.
    causal = torch.ones((q, q), dtype=torch.bool, device=xc.device).tril()
    diff = cum[..., :, None] - cum[..., None, :]             # (b,nc,h,q,k)
    lmat = torch.exp(diff.masked_fill(~causal, float("-inf")))
    w = cb[:, :, None] * lmat * dtc.transpose(2, 3)[:, :, :, None, :]
    return y_inter + torch.einsum("bchqk,bckhp->bcqhp", w, xc)


def ssd_stages(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
               bmat: torch.Tensor, cmat: torch.Tensor, chunk: int
               ) -> Dict[str, torch.Tensor]:
    """The stages of :func:`ssd_chunked` (S >= 1), each as the kernel's
    scratch holds it: ``cb`` (B,nc,q,q), ``cum`` (B,nc,H,q),
    ``chunk_states`` and ``states_in`` (B,nc,H,P,N), ``h_final``
    (B,H,P,N), and ``y`` (B,S,H,P)."""
    b, s, h, p = x.shape
    xc, dtc, bc, cc = split_chunks(x, dt, bmat, cmat, chunk)
    cum = chunk_cumsum(dtc, a_log)
    cb = chunk_cb(bc, cc)
    states = chunk_states(xc, dtc, bc, cum)
    h_in, h_final = state_passing(states, cum)
    y = chunk_output(xc, dtc, cc, cb, cum, h_in)
    return {"cb": cb, "cum": cum, "chunk_states": states, "states_in": h_in,
            "h_final": h_final, "y": y.reshape(b, -1, h, p)[:, :s]}


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact chunked SSD (arXiv:2405.21060 §6) from a zero state, in the
    dtype of ``x`` (float32 as the wrapper passes it; float64 gives an
    accuracy reference).

    x (B,S,H,P); dt (B,S,H); a_log (H,); B/C (B,S,N). Returns
    (y (B,S,H,P), h_final (B,H,P,N)).

    Chunks hold ``min(chunk, S)`` rows and the last one is ragged: it is
    padded with rows whose ``dt`` is 0, which add nothing to ``y``, to the
    chunk's decay or to the state, so ``h_final`` is the state after the
    last valid row. The JAX package instead halves the chunk until it
    divides S, which falls to 1-row chunks for most odd prompt lengths; the
    decomposition is exact for any chunking, so the two agree to rounding.
    """
    b, s, h, p = x.shape
    if s == 0:
        n = bmat.shape[-1]
        return (torch.zeros((b, 0, h, p), dtype=x.dtype, device=x.device),
                torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device))
    stages = ssd_stages(x, dt, a_log, bmat, cmat, chunk)
    return stages["y"], stages["h_final"]
