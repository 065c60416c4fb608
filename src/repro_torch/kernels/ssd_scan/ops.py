"""Wrapper of the Mamba2 SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor launches
the hand-written kernel's four stages on PyTorch's current stream or raises:
there is no fallback. ``LAUNCHES`` counts calls that launched the scan.
The stages' scratch is allocated here (:func:`scratch_shapes`); the kernel
allocates nothing.

The kernel writes its outputs through raw pointers, so autograd sees
nothing of it: :func:`ssd_scan` refuses an input that requires grad while
grad mode is on, and a caller that needs gradients (``mamba_prefill``)
goes through :func:`ssd_scan_autograd`, whose backward is the gradient of
the plain ``ssd_chunked``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

#: kernel launches made by :func:`ssd_scan` in this process
LAUNCHES = 0

#: the kernel's stages, one launch each, in order
STAGES = ("chunk_cb", "chunk_states", "state_passing", "chunk_output")


def scratch_shapes(b: int, s: int, h: int, p: int, n: int, chunk: int
                   ) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the scratch the stages pass on, for x (b, s, h, p), B and
    C (b, s, n) in chunks of ``q = min(chunk, s)`` rows: cum (b, nc, h, q),
    C.B^T (b, nc, q, q) and the chunk states (b, nc, h, p, n), as the
    matching plain stages of ``ref.py`` return them."""
    q = max(1, min(chunk, s))
    nc = -(-s // q)
    return {"cum": (b, nc, h, q), "cb": (b, nc, q, q),
            "states": (b, nc, h, p, n)}


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    if not getattr(lib, "_argtypes_set", False):
        ints = [ctypes.c_int] * 6
        lib.ssd_scan_f32.argtypes = [ctypes.c_void_p] * 10 + ints + [
            ctypes.c_void_p]
        lib.ssd_scan_f32.restype = ctypes.c_int
        lib.ssd_scan_stage.argtypes = [ctypes.c_int] + [
            ctypes.c_void_p] * 10 + ints + [ctypes.c_void_p]
        lib.ssd_scan_stage.restype = ctypes.c_int
        lib.ssd_scan_max_chunk.argtypes = []
        lib.ssd_scan_max_chunk.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _check(x, dt, a_log, bmat, cmat, chunk) -> None:
    if x.ndim != 4 or dt.ndim != 3 or a_log.ndim != 1 or bmat.ndim != 3 \
            or cmat.ndim != 3:
        raise ValueError("want x (B,S,H,P), dt (B,S,H), a_log (H,), B and C "
                         f"(B,S,N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(a_log.shape)}, {tuple(bmat.shape)}, "
                         f"{tuple(cmat.shape)}")
    b, s, h, _ = x.shape
    if tuple(dt.shape) != (b, s, h) or tuple(a_log.shape) != (h,) \
            or bmat.shape[:2] != (b, s) or cmat.shape != bmat.shape:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a_log {tuple(a_log.shape)}, B "
                         f"{tuple(bmat.shape)}, C {tuple(cmat.shape)}")
    for name, t in (("x", x), ("dt", dt), ("a_log", a_log), ("B", bmat),
                    ("C", cmat)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {t.device for t in (x, dt, a_log, bmat, cmat)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def _buffers(x, bmat, chunk):
    """(y, h_final, scratch by name, launch arguments after the input
    pointers) for a CUDA launch; scratch None for an empty input."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    dev = x.device
    if 0 in (b, s, h, p, n):          # y and the state are then all 0
        return (torch.zeros((b, s, h, p), dtype=torch.float32, device=dev),
                torch.zeros((b, h, p, n), dtype=torch.float32, device=dev),
                None, None)
    max_chunk = _lib().ssd_scan_max_chunk()
    if chunk > max_chunk:
        raise ValueError(f"the kernel holds at most {max_chunk} rows of a "
                         f"chunk, got chunk={chunk}")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    h_final = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    shapes = scratch_shapes(b, s, h, p, n, chunk)
    scratch = {name: torch.empty(shape, dtype=torch.float32, device=dev)
               for name, shape in shapes.items()}
    ptrs = [y.data_ptr(), h_final.data_ptr(), scratch["cum"].data_ptr(),
            scratch["cb"].data_ptr(), scratch["states"].data_ptr()]
    return y, h_final, scratch, ptrs + [b, s, h, p, n, chunk]


def _inputs(x, dt, a_log, bmat, cmat):
    return [t.data_ptr() for t in (x, dt, a_log, bmat, cmat)]


def _refuse_graph(*inputs: torch.Tensor) -> None:
    """The kernel's outputs carry no ``grad_fn``: refuse to drop a gradient
    silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            "ssd_scan records no gradient (the kernel writes through raw "
            "pointers); call ssd_scan_autograd for inputs that require grad")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P), dt (B,S,H), a_log (H,), B and C (B,S,N), all float32
    and contiguous -> (y (B,S,H,P), h_final (B,H,P,N)) float32, from a zero
    state, in chunks of ``min(chunk, S)`` rows with a ragged last chunk.
    See :func:`repro_torch.kernels.ssd_scan.ref.ssd_chunked`. Raises on an
    input that requires grad while grad mode is on (on every device): use
    :func:`ssd_scan_autograd` there."""
    global LAUNCHES
    _check(x, dt, a_log, bmat, cmat, chunk)
    _refuse_graph(x, dt, a_log, bmat, cmat)
    dev = x.device
    if dev.type in ("cpu", "meta"):
        return ssd_chunked(x, dt, a_log, bmat, cmat, chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda (meta traces "
                         f"shapes only), not {dev}")
    y, h_final, scratch, args = _buffers(x, bmat, chunk)
    if scratch is None:
        return y, h_final
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().ssd_scan_f32(*_inputs(x, dt, a_log, bmat, cmat), *args,
                                 stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return y, h_final


class SSDScan(torch.autograd.Function):
    """The SSD scan with a gradient, for training through ``mamba_prefill``.

    Forward: :func:`ssd_scan`, under ``no_grad`` as autograd runs every
    forward: on a CUDA tensor it launches the hand-written kernel (counted
    in ``LAUNCHES``) or raises; on a CPU tensor it runs the plain
    ``ssd_chunked``. This is not a fallback: nothing gives way when the
    kernel fails, and the card's forward always launches it.

    Backward: the gradient that JAX's autodiff of its ``ssd_chunked``
    computes, for x, dt, a_log, B and C, from an upstream gradient of ``y``
    and of ``h_final`` (either may be zero). It recomputes the plain
    chunked stages of ``ref.py`` from the saved float32 inputs under
    ``enable_grad`` (a ragged last chunk included) and differentiates them
    with autograd, so it launches no kernel on any device. The JAX package
    has no backward kernel either; a hand-written one is speed work.
    """

    @staticmethod
    def forward(ctx, x, dt, a_log, bmat, cmat, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a_log, bmat, cmat)
        return ssd_scan(x, dt, a_log, bmat, cmat, chunk)

    @staticmethod
    def backward(ctx, g_y, g_h):
        if ctx.saved_tensors[0].shape[1] == 0:     # S = 0: nothing flows
            return (None,) * 6
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, h_final = ssd_chunked(*inputs, ctx.chunk)
            grads = iter(torch.autograd.grad(
                (y, h_final), [t for t in inputs if t.requires_grad],
                (g_y, g_h), allow_unused=True))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None)


def ssd_scan_autograd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                      bmat: torch.Tensor, cmat: torch.Tensor, chunk: int = 128
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan` (same arguments and outputs) through
    :class:`SSDScan`, so that gradients flow to every input."""
    return SSDScan.apply(x, dt, a_log, bmat, cmat, chunk)


def ssd_scan_stages(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    bmat: torch.Tensor, cmat: torch.Tensor, chunk: int = 128
                    ) -> Dict[str, torch.Tensor]:
    """The kernel's stages launched one at a time on CUDA tensors, with a
    copy of what each wrote: ``cb`` (B,nc,Q,Q: C.B^T, on and below the
    diagonal only); ``cum`` (B,nc,H,Q) and ``chunk_states`` (B,nc,H,P,N);
    ``states_in`` (the state entering each chunk, in place of the chunk
    states) and ``h_final``; ``y``. Each is shaped as the
    matching function of ``ref.py`` returns it, so a fault shows the stage
    it is in. Not on the served path: ``chip_smoke.py`` reads it."""
    global LAUNCHES
    _check(x, dt, a_log, bmat, cmat, chunk)
    _refuse_graph(x, dt, a_log, bmat, cmat)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_stages runs on cuda, not {x.device}")
    y, h_final, scratch, args = _buffers(x, bmat, chunk)
    if scratch is None:
        raise ValueError("ssd_scan_stages needs a non-empty input")
    wrote = (lambda: {"cb": scratch["cb"].clone()},
             lambda: {"cum": scratch["cum"].clone(),
                      "chunk_states": scratch["states"].clone()},
             lambda: {"states_in": scratch["states"].clone(),
                      "h_final": h_final.clone()},
             lambda: {"y": y.clone()})
    out = {}
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for stage, copy in enumerate(wrote):
            rc = lib.ssd_scan_stage(stage, *_inputs(x, dt, a_log, bmat, cmat),
                                    *args, stream)
            if rc != 0:
                raise RuntimeError(f"ssd_scan stage {STAGES[stage]} failed "
                                   f"with CUDA error {rc}")
            out.update(copy())
    LAUNCHES += 1
    return out
