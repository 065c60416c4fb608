"""Plain PyTorch version of the Mamba2 SSD chunked scan: the CPU path of
the wrapper, the model's ``ssd_chunked``, and the reference the CUDA kernel
is held against."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


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
    n = bmat.shape[-1]
    f32 = x.dtype
    hstate = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    if s == 0:
        return torch.zeros((b, 0, h, p), dtype=f32, device=x.device), hstate
    q = max(1, min(chunk, s))
    nc = -(-s // q)
    pad = nc * q - s
    x, dt, bmat, cmat = (t.to(f32) for t in (x, dt, bmat, cmat))
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    a = -torch.exp(a_log.to(f32))
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    bc = bmat.reshape(b, nc, q, n)
    cc = cmat.reshape(b, nc, q, n)
    cum = torch.cumsum(dtc * a, dim=2)                       # (b,nc,q,h)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(nc):
        x_c, dt_c, cum_c = xc[:, c], dtc[:, c], cum[:, c]
        b_c, c_c = bc[:, c], cc[:, c]
        y_inter = torch.einsum("bqn,bhpn->bqhp", c_c, hstate) \
            * torch.exp(cum_c)[..., None]
        # Masked before the exponential: above the diagonal cum_t - cum_s
        # is positive and its exp may overflow.
        diff = cum_c[:, :, None, :] - cum_c[:, None, :, :]   # (b,q,k,h)
        lmat = torch.exp(diff.masked_fill(~causal[None, :, :, None],
                                          float("-inf")))
        cb = torch.einsum("bqn,bkn->bqk", c_c, b_c)
        w = cb[..., None] * lmat * dt_c[:, None, :, :]
        y_intra = torch.einsum("bqkh,bkhp->bqhp", w, x_c)
        decay_to_end = torch.exp(cum_c[:, -1:, :] - cum_c)   # (b,q,h)
        contrib = torch.einsum("bqhp,bqn->bhpn",
                               (decay_to_end * dt_c)[..., None] * x_c, b_c)
        hstate = hstate * torch.exp(cum_c[:, -1, :])[:, :, None, None] \
            + contrib
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, 1).reshape(b, nc * q, h, p)[:, :s]
    return y, hstate
