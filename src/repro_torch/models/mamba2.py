"""Mamba2 block: SSD (state-space duality) chunked scan. [arXiv:2405.21060]

Prefill runs the exact chunked SSD algorithm (the quadratic intra-chunk
term and the inter-chunk state recurrence) through the ``ssd_scan`` kernel
wrapper; decode is the O(1) recurrence in plain PyTorch, as in the JAX
package, which has no kernel for it. ``ssd_reference`` (the naive
per-token recurrence) is the test oracle and ``ssd_chunked`` the plain
chunked form.

Both chunked forms take a ragged last chunk (masked rows of ``dt = 0``)
where the JAX package halves the chunk until it divides the prompt length;
the decomposition is exact for any chunking, so the two agree to rounding.

Over DTensors (the dry run) the causal conv and the scan run on each
rank's blocks through ``local_map``: the conv on its batch and channels,
the scan on its batch and its SSM heads (over ``model``, as JAX's specs
shard ``in_proj``'s columns), with B and C whole.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import dtensor as dtn
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan_autograd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: F401
from repro_torch.models.layers import rms_norm, weight, widened


class SSMState(NamedTuple):
    h: Any       # (L, B, H, P, N) float32 recurrent state
    conv: Any    # (L, B, conv-1, conv_channels) rolling conv inputs
    length: Any  # int32, scalar or (B,)


class Mamba(nn.Module):
    """Weights of one Mamba2 layer, under the JAX package's names."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.d_model
        din = d * cfg.ssm_expand
        n, h = cfg.ssm_state, cfg.ssm_heads
        conv_ch = din + 2 * n
        f32 = torch.float32
        self.ln = weight((d,), dtype, device, generator, "ones")
        # in_proj -> [z (din), x (din), B (n), C (n), dt (h)]
        self.in_proj = weight((d, 2 * din + 2 * n + h), dtype, device,
                              generator)
        self.conv_w = weight((cfg.ssm_conv, conv_ch), dtype, device,
                             generator, scale=0.5)
        self.conv_b = weight((conv_ch,), dtype, device, generator, "zeros")
        self.dt_bias = weight((h,), f32, device, generator, "zeros")
        self.A_log = weight((h,), f32, device, generator, "zeros")  # A = -1
        self.D = weight((h,), f32, device, generator, "ones")
        self.norm_gain = weight((din,), dtype, device, generator, "ones")
        self.out_proj = weight((din, d), dtype, device, generator)


def _split_proj(p: Mamba, x: torch.Tensor, cfg: ModelConfig):
    """z, xBC and dt: ``in_proj``'s product cut into its parts. Over
    DTensors each rank computes its own block of each part's columns
    (``dtensor.linear``'s ``parts``), so the parts of a model-sharded
    product are never gathered to be cut."""
    din = cfg.d_model * cfg.ssm_expand
    n = cfg.ssm_state
    z, xbc, dt_raw = dtn.linear(x, p.in_proj, (din, din + 2 * n,
                                               cfg.ssm_heads))
    dt = F.softplus(widened(dt_raw) + p.dt_bias)
    return z, xbc, dt  # dt: (b,s,h) f32


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. xbc: (B,S,C); w: (K,C). A DTensor ``xbc``
    is convolved on each rank's batch and channels, its sequence whole."""
    if dtn.is_dtensor(xbc):
        return dtn.blockwise(_causal_conv, xbc.device_mesh, (xbc, w, b),
                             [(0, 2), (None, 1), (None, 0)], [(0, 2)],
                             dtn.shard_axes(xbc, 0), dtn.shard_axes(xbc, 2))
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros(xbc.shape, dtype=widened(xbc).dtype, device=xbc.device)
    for i in range(k):  # K is tiny (4); unrolled taps
        out = out + widened(pad[:, i: i + s]) * widened(w[i])
    return F.silu(out + widened(b)).to(xbc.dtype)


def ssd_reference(x, dt, a_log, bmat, cmat):
    """Naive per-token recurrence (oracle). x: (B,S,H,P); B/C: (B,S,N).
    Returns (y (B,S,H,P), h_final (B,H,P,N)), float32."""
    a = -torch.exp(a_log.float())
    b, s, h, pdim = x.shape
    n = bmat.shape[-1]
    state = torch.zeros((b, h, pdim, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        xt, dtt = x[:, t].float(), dt[:, t].float()
        bt, ct = bmat[:, t].float(), cmat[:, t].float()
        decay = torch.exp(dtt * a)[..., None, None]
        state = state * decay + (dtt[..., None] * xt)[..., None] \
            * bt[:, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, ct))
    y = torch.stack(ys, 1) if ys else x.new_zeros((b, 0, h, pdim),
                                                   dtype=torch.float32)
    return y, state


def mamba_prefill(p: Mamba, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,D). Returns (out (B,S,D), h_state (B,H,P,N) f32, conv_state
    (B,K-1,C) in x's dtype). The scan runs through the ``ssd_scan`` kernel
    on the card, by way of its autograd Function (``ssd_scan_autograd``),
    so a loss backpropagates through it."""
    bsz, s, d = x.shape
    din = d * cfg.ssm_expand
    n, h = cfg.ssm_state, cfg.ssm_heads
    k = cfg.ssm_conv
    if dtn.is_dtensor(p.in_proj):
        z, xin, bmat, cmat, dt, conv_state = _conv_blocks(p, x, cfg)
    else:
        z, xbc_raw, dt = _split_proj(p, x, cfg)
        xbc = _causal_conv(xbc_raw, p.conv_w, p.conv_b)
        xin, bmat, cmat = (xbc[..., :din], xbc[..., din: din + n],
                           xbc[..., din + n:])
        # conv state: the last (K-1) raw xbc inputs
        conv_state = _conv_tail(xbc_raw, k)
    xin = xin.reshape(bsz, s, h, cfg.ssm_head_dim)
    y, h_final = _scan(widened(xin).contiguous(), dt.contiguous(),
                       widened(p.A_log).contiguous(),
                       widened(bmat).contiguous(), widened(cmat).contiguous(),
                       cfg.ssm_chunk)
    y = y + p.D[None, None, :, None] * widened(xin)
    y = y.reshape(bsz, s, din).to(x.dtype)
    y = rms_norm(y * F.silu(widened(z)).to(z.dtype), p.norm_gain,
                 cfg.norm_eps)
    out = dtn.linear(y, p.out_proj)
    return out, h_final, conv_state


def _conv_tail(xbc_raw: torch.Tensor, k: int) -> torch.Tensor:
    """The last (K-1) positions of ``xbc_raw`` (B,S,C), zeros in front of a
    shorter sequence."""
    s = xbc_raw.shape[1]
    return xbc_raw[:, s - (k - 1):, :] if s >= k - 1 else F.pad(
        xbc_raw, (0, 0, k - 1 - s, 0))


def _conv_blocks(p: Mamba, x: torch.Tensor, cfg: ModelConfig):
    """:func:`mamba_prefill`'s z, x, B, C, dt and conv state over DTensors:
    in_proj's x and B|C columns as parts of their own (each rank its block
    of each, ``dtensor.linear``'s ``parts``), each convolved with its
    channels of the depthwise conv, so x comes out cut by SSM heads, as
    the scan takes it, and only B and C (2N channels) are gathered for it
    (once, both together), never the whole xBC. The same arithmetic as the
    plain path: the conv is per channel."""
    din = cfg.d_model * cfg.ssm_expand
    n = cfg.ssm_state
    z, x_raw, bc_raw, dt_raw = dtn.linear(
        x, p.in_proj, (din, din, 2 * n, cfg.ssm_heads))
    dt = F.softplus(widened(dt_raw) + p.dt_bias)
    xs = _causal_conv(x_raw, p.conv_w[:, :din], p.conv_b[:din])
    bc = dtn.whole_last(_causal_conv(bc_raw, p.conv_w[:, din:],
                                     p.conv_b[din:]))
    k = cfg.ssm_conv
    tail = torch.cat([_conv_tail(x_raw, k), _conv_tail(bc_raw, k)], dim=-1)
    return z, xs, bc[..., :n], bc[..., n:], dt, tail


def _scan(x, dt, a_log, bmat, cmat, chunk: int):
    """``ssd_scan_autograd``; over DTensors, on each rank's batch and SSM
    heads through ``local_map`` (the kernel's Function on CUDA blocks, the
    plain chunked scan on meta), B and C whole on every rank: y (B,S,H,P)
    and h_final (B,H,P,N) come out sharded as the heads are."""
    if not dtn.is_dtensor(x):
        return ssd_scan_autograd(x, dt, a_log, bmat, cmat, chunk)
    mesh = x.device_mesh

    def body(*blocks):
        return ssd_scan_autograd(*(t.contiguous() for t in blocks), chunk)

    return dtn.blockwise(body, mesh, (x, dt, a_log, bmat, cmat),
                         [(0, 2), (0, 2), (None, 0), (0, None), (0, None)],
                         [(0, 2), (0, 1)], dtn.shard_axes(x, 0),
                         dtn.shard_axes(x, 2))


def mamba_decode(p: Mamba, x: torch.Tensor, h_state: torch.Tensor,
                 conv_state: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token. x: (B,1,D); h_state: (B,H,P,N); conv_state: (B,K-1,C).
    Returns (out (B,1,D), new h_state, new conv_state); the new conv state
    has the promoted dtype of ``conv_state`` and x (f32 in an f32 model)."""
    bsz, _, d = x.shape
    din = d * cfg.ssm_expand
    n, h = cfg.ssm_state, cfg.ssm_heads
    z, xbc_raw, dt = _split_proj(p, x, cfg)                  # seq dim = 1
    window = torch.cat([conv_state, xbc_raw], dim=1)         # (B,K,C)
    new_conv_state = window[:, 1:, :]
    conv_out = torch.einsum("bkc,kc->bc", widened(window),
                            widened(p.conv_w)) + widened(p.conv_b)
    # Over DTensors the row's channels are gathered once, to be cut by
    # heads and to give every rank B and C.
    xbc = F.silu(dtn.whole_last(conv_out))
    xin = xbc[..., :din].reshape(bsz, h, cfg.ssm_head_dim)
    bmat, cmat = xbc[..., din: din + n], xbc[..., din + n:]
    a = -torch.exp(p.A_log)
    dtt = dt[:, 0]                                           # (B,H)
    decay = torch.exp(dtt * a)[..., None, None]
    h_state = h_state * decay + (dtt[..., None] * xin)[..., None] \
        * bmat[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h_state, cmat)
    y = y + p.D[None, :, None] * xin
    y = y.reshape(bsz, 1, din).to(x.dtype)
    y = rms_norm(y * F.silu(widened(z)).to(z.dtype), p.norm_gain,
                 cfg.norm_eps)
    out = dtn.linear(y, p.out_proj)
    return out, h_state, new_conv_state


def make_ssm_state(cfg: ModelConfig, n_layers: int, batch: int,
                   device: torch.device,
                   dtype: torch.dtype = torch.bfloat16) -> SSMState:
    """A zero state: ``h`` float32 and ``conv`` bfloat16 whatever the cache
    ``dtype``, as the JAX package makes them; both float64 for a float64
    cache (a float64 step's, ``launch/sharded_step.py``)."""
    din = cfg.d_model * cfg.ssm_expand
    conv_ch = din + 2 * cfg.ssm_state
    wide = dtype == torch.float64
    return SSMState(
        h=torch.zeros((n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                       cfg.ssm_state),
                      dtype=torch.float64 if wide else torch.float32,
                      device=device),
        conv=torch.zeros((n_layers, batch, cfg.ssm_conv - 1, conv_ch),
                         dtype=torch.float64 if wide else torch.bfloat16,
                         device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )
