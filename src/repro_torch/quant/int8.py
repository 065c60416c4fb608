"""Training-free hierarchical INT8 quantization (paper §4.5), the port of
the JAX package's ``quant/int8.py``.

1. **Mixed-precision strategy**: ``INT8_PATHS``/``KEEP_PATHS`` classify
   tensors by their ``/``-joined path; large matmuls go INT8, norms,
   routers and other sensitive tensors stay in high precision.
2. **Adaptive scale search** (Eq. 3): a grid search for the weight/
   activation scale split ``s*`` minimizing ``|Q(W s)(X / s) - W X|``.
3. **Outlier suppression**: SmoothQuant-style diagonal equalization,
   absorbed into the weights.
4. **Mixed-granularity kernels**: per-token activation scales (the
   dispatch-quantize kernel, the same function as LEP's early quantization)
   times per-channel weight scales, multiplied by the hand-written INT8 GEMM
   (:func:`repro_torch.kernels.int8_gemm.int8_matmul`).
5. **Block-level clipping + error compensation** (Eq. 4): a per-block clip
   search and an additive bias for the systematic error, on calibration
   data.

Calibration is offline; inference uses :class:`QuantizedLinear`. Every
int8 product here, calibration included, goes through the ``int8_matmul``
wrapper: its kernel for CUDA tensors, its plain version for CPU tensors.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.dispatch_quant import dispatch_quantize
from repro_torch.kernels.int8_gemm import int8_matmul


class QuantizedLinear(NamedTuple):
    """Per-channel INT8 weight + scales (+ optional equalization & bias).

    ``w_q`` has JAX's shape (K, N) and JAX's values, stored K-major: it is
    the ``.t()`` view of a contiguous (N, K) tensor, ``stride() == (1, K)``
    (:func:`k_major`). That is the layout the INT8 GEMM kernel feeds to the
    tensor cores, so it is made once, when the weight is quantized, and not
    on every product."""
    w_q: torch.Tensor                    # (K, N) int8, stored K-major
    w_scale: torch.Tensor                # (1, N) f32
    eq: Optional[torch.Tensor]           # (K,) f32 activation equalization
    bias_corr: Optional[torch.Tensor]    # (N,) f32 error compensation


# ---------------------------------------------------------------------------
# Granular quantizers (component 4)
# ---------------------------------------------------------------------------


def k_major(w: torch.Tensor) -> torch.Tensor:
    """``w`` (..., K, N) with the same values, stored K-major: the
    transposed view of a contiguous (..., N, K) tensor. No copy if ``w`` is
    stored so already."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_weight_per_channel(w: torch.Tensor,
                                clip: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (K, N) -> (int8 (K, N) stored K-major, scale (1, N)). Per output
    channel, static."""
    wf = w.float()
    absmax = wf.abs().amax(dim=0, keepdim=True)
    if clip is not None:
        absmax = absmax * clip
    # A tensor divisor: on CUDA a Python-number divisor becomes a product by
    # its reciprocal.
    scale = absmax.clamp_min(1e-8) / torch.tensor(127.0, device=w.device)
    q = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
    return k_major(q), scale


def quantize_act_per_token(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, K) -> (int8 (T, K), scale (T, 1)). Per token, dynamic: the
    dispatch-quantize kernel on CUDA (f32 or bf16 rows; other float types
    are taken as f32, as the JAX package does)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    return dispatch_quantize(x.contiguous())


# ---------------------------------------------------------------------------
# Adaptive scale search (component 2, paper Eq. 3)
# ---------------------------------------------------------------------------


def adaptive_scale_search(w: torch.Tensor, x_calib: torch.Tensor,
                          grid=(0.5, 0.7, 0.85, 1.0, 1.2, 1.5, 2.0)
                          ) -> Tuple[float, torch.Tensor]:
    """Find the scalar ``s*`` minimizing ``|Q(W s)(X / s) - W X|_F``
    (offline). Returns ``(s*, errors over grid)``."""
    ref = x_calib.float() @ w.float()

    def err(s):
        wq, ws = quantize_weight_per_channel(w * s)
        xq, xs = quantize_act_per_token(x_calib / s)
        return torch.linalg.norm(
            int8_matmul(xq, wq, xs, ws, out_dtype=torch.float32) - ref)

    errs = torch.stack([err(s) for s in grid])
    best = int(torch.argmin(errs))
    return float(grid[best]), errs


# ---------------------------------------------------------------------------
# Outlier suppression (component 3)
# ---------------------------------------------------------------------------


def equalization_scales(w: torch.Tensor, x_calib: torch.Tensor,
                        alpha: float = 0.5) -> torch.Tensor:
    """Diagonal equalization ``s_k = max|X_k|^a / max|W_k|^(1-a)``, absorbed
    as ``x' = x / s``, ``w' = w * s[:, None]``: function-preserving, it
    moves activation outlier channels into the statically quantized
    weights."""
    xmax = x_calib.float().abs().amax(dim=0).clamp_min(1e-5)
    wmax = w.float().abs().amax(dim=1).clamp_min(1e-5)
    return (xmax ** alpha) / (wmax ** (1 - alpha))


# ---------------------------------------------------------------------------
# Block-level clipping + error compensation (component 5, Eq. 4)
# ---------------------------------------------------------------------------


def block_clip_search(w: torch.Tensor, x_calib: torch.Tensor,
                      n_blocks: int = 4,
                      grid=(0.8, 0.9, 0.95, 1.0)) -> torch.Tensor:
    """Per-block clip factor minimizing the block's output error (Eq. 4).
    Blocks partition the output channels. Returns (1, N) clip
    multipliers."""
    _, n = w.shape
    bs = max(1, n // n_blocks)
    xf = x_calib.float()
    xq, xs = quantize_act_per_token(x_calib)
    clips = []
    for b0 in range(0, n, bs):
        wb = w[:, b0:b0 + bs]
        ref = xf @ wb.float()
        errs = []
        for a in grid:
            wq, ws = quantize_weight_per_channel(
                wb, clip=torch.tensor(a, dtype=torch.float32, device=w.device))
            errs.append(torch.linalg.norm(
                int8_matmul(xq, wq, xs, ws, out_dtype=torch.float32) - ref))
        best = grid[int(torch.argmin(torch.stack(errs)))]
        clips.append(torch.full((1, wb.shape[1]), best, dtype=torch.float32,
                                device=w.device))
    return torch.cat(clips, dim=1)


def error_compensation(w: torch.Tensor, ql: QuantizedLinear,
                       x_calib: torch.Tensor) -> torch.Tensor:
    """Additive bias ``E[W X - Q(W) Q(X)]`` over calibration tokens (N,).

    ``w`` and ``x_calib`` are the original (un-equalized) tensors; the
    quantized path applies ``ql.eq`` itself, so both sides see the same
    inputs."""
    ref = x_calib.float() @ w.float()
    approx = quantized_matmul(x_calib, ql._replace(bias_corr=None))
    return (ref - approx.float()).mean(dim=0)


# ---------------------------------------------------------------------------
# Calibration pipeline + runtime apply
# ---------------------------------------------------------------------------


def calibrate_linear(w: torch.Tensor, x_calib: torch.Tensor, *,
                     equalize: bool = True, block_clip: bool = True,
                     compensate: bool = True) -> QuantizedLinear:
    """The full §4.5 pipeline for one weight matrix (offline)."""
    eq = equalization_scales(w, x_calib) if equalize else None
    w_eff = w * eq[:, None] if eq is not None else w
    x_eff = x_calib / eq[None, :] if eq is not None else x_calib
    clip = block_clip_search(w_eff, x_eff) if block_clip else None
    w_q, w_scale = quantize_weight_per_channel(w_eff, clip=clip)
    ql = QuantizedLinear(w_q, w_scale, eq, None)
    if compensate:
        ql = ql._replace(bias_corr=error_compensation(w, ql, x_calib))
    return ql


def quantized_matmul(x: torch.Tensor, ql: QuantizedLinear,
                     use_kernel: bool = False,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Runtime: per-token quantize -> INT8 GEMM -> rescale (+ bias).

    On CUDA tensors the INT8 GEMM is always the hand-written kernel, and on
    CPU tensors its plain version; ``use_kernel`` is kept for the JAX
    signature and changes nothing (it does not bypass the kernel)."""
    del use_kernel
    if ql.eq is not None:
        x = x / ql.eq[None, :].to(x.dtype)
    x_q, x_scale = quantize_act_per_token(x)
    out = int8_matmul(x_q, ql.w_q, x_scale, ql.w_scale,
                      out_dtype=torch.float32)
    if ql.bias_corr is not None:
        out = out + ql.bias_corr[None, :]
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# Mixed-precision policy (component 1)
# ---------------------------------------------------------------------------

#: path-substring rules: tensors matching INT8_PATHS are quantized; others
#: (norms, routers, biases, scales, dt/A/D of SSM blocks) stay high precision.
INT8_PATHS = ("w_gate", "w_up", "w_down", "wq", "wk", "wv", "wo",
              "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b",
              "shared_gate", "shared_up", "shared_down",
              "in_proj", "out_proj", "lm_head", "mix", "proj")
KEEP_PATHS = ("ln", "norm", "router", "bias", "dt_bias", "A_log", "D",
              "conv", "embed", "q_norm", "k_norm", "q_ln", "kv_ln")


def should_quantize(path: str) -> bool:
    leaf = path.split("/")[-1]
    if any(k in leaf for k in KEEP_PATHS):
        return False
    return any(k == leaf or leaf.startswith(k) for k in INT8_PATHS)


def quantize_param_tree(params: dict) -> Tuple[dict, Dict[str, int]]:
    """Apply the mixed-precision policy over a parameter tree in the JAX
    layout (nested dicts of tensors, e.g. :func:`repro_torch.convert.
    param_tree`). 2-D+ tensors on INT8 paths become ``{"__q__": int8,
    "__scale__": f32}`` dicts (one per-channel scale over all leading
    axes; the codes stored K-major, so each (K, N) matrix has stride
    (1, K)); the rest is untouched. Returns ``(new tree, {"quantized": n,
    "kept": m})``."""
    stats = {"quantized": 0, "kept": 0}

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, torch.Tensor) and tree.ndim >= 2 \
                and should_quantize(path):
            q, s = quantize_weight_per_channel(tree.reshape(-1, tree.shape[-1]))
            stats["quantized"] += 1
            return {"__q__": k_major(q.reshape(tree.shape)),
                    "__scale__": s.float()}
        stats["kept"] += 1
        return tree

    return walk(params), stats
