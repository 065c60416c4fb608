"""Wrapper of the per-row INT8 quantization kernel
(``csrc/dispatch_quant.cu``).

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor launches
the hand-written kernel on PyTorch's current stream, with the launch plan
of ``plan.py``, or raises: there is no fallback. ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch_quant import plan as dq_plan
from repro_torch.kernels.dispatch_quant.ref import dispatch_quantize_ref

#: kernel launches made by :func:`dispatch_quantize` in this process
LAUNCHES = 0

KINDS = {"none": 0, "ring": 1, "rows": 2, "split": 3}

_N_SM = {}                    # device index -> SM count


def _lib() -> ctypes.CDLL:
    lib = build.load("dispatch_quant")
    if not getattr(lib, "_argtypes_set", False):
        fn = lib.dispatch_quantize
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int,
                       *[ctypes.c_int] * 8, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def plan_for(x: torch.Tensor, q: torch.Tensor) -> dq_plan.Plan:
    """The launch plan of ``x`` (T, D) into the code rows of ``q``."""
    t, d = x.shape
    n_sm = _N_SM.get(x.device.index)
    if n_sm is None:
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        _N_SM[x.device.index] = n_sm
    return dq_plan.launch_plan(t, d, x.element_size(), x.data_ptr(),
                               q.data_ptr(), q.shape[1], n_sm)


def dispatch_quantize(x: torch.Tensor, pack: bool = False):
    """x (T, D) float32 or bfloat16, contiguous -> (q int8 (T, D), scale
    f32 (T, 1)), or with ``pack`` one int8 (T, D + 4) tensor whose last 4
    bytes per row are the row's f32 scale. See :func:`dispatch_quantize_ref`
    for the arithmetic."""
    global LAUNCHES
    if x.ndim != 2:
        raise ValueError(f"want x (T, D), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type in ("cpu", "meta"):
        return dispatch_quantize_ref(x, pack)
    if x.device.type != "cuda":
        raise ValueError(f"dispatch_quantize runs on cpu or cuda (meta traces "
                         f"shapes only), not {x.device}")
    t, d = x.shape
    if d < 1:
        raise ValueError(f"D must be at least 1, got {d}")
    width = d + 4 if pack else d
    q = torch.empty((t, width), dtype=torch.int8, device=x.device)
    scale = None if pack else torch.empty((t, 1), dtype=torch.float32,
                                          device=x.device)
    plan = plan_for(x, q)
    if plan.kind == "none":
        return q if pack else (q, scale)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().dispatch_quantize(
            x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
            None if scale is None else scale.data_ptr(), t, d, width,
            int(pack), KINDS[plan.kind], plan.grid, plan.warps, plan.stages,
            plan.cluster, plan.slice, int(plan.vec), plan.smem, stream)
    if rc != 0:
        raise RuntimeError(f"dispatch_quantize kernel launch failed with "
                           f"CUDA error {rc} ({plan})")
    LAUNCHES += 1
    return q if pack else (q, scale)
