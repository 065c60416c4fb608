"""Wrapper of the Mamba2 SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

A CPU tensor goes to the plain version (``ref.py``). A CUDA tensor launches
the hand-written kernel on PyTorch's current stream or raises: there is no
fallback. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

#: kernel launches made by :func:`ssd_scan` in this process
LAUNCHES = 0

MAX_CHUNK = 128               # must match kQ in the source
SMEM_LIMIT = 232_448          # dynamic shared memory one block may use


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    if not getattr(lib, "_argtypes_set", False):
        fn = lib.ssd_scan_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P), dt (B,S,H), a_log (H,), B and C (B,S,N), all float32
    and contiguous -> (y (B,S,H,P), h_final (B,H,P,N)) float32, from a zero
    state, in chunks of ``min(chunk, S)`` rows with a ragged last chunk.
    See :func:`repro_torch.kernels.ssd_scan.ref.ssd_chunked`."""
    global LAUNCHES
    _check(x, dt, a_log, bmat, cmat, chunk)
    dev = x.device
    if dev.type == "cpu":
        return ssd_chunked(x, dt, a_log, bmat, cmat, chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {dev}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"the kernel holds at most {MAX_CHUNK} rows of a "
                         f"chunk, got chunk={chunk}")
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    h_final = torch.zeros((b, h, p, n), dtype=torch.float32, device=dev)
    if b == 0 or s == 0 or h == 0 or p == 0:
        return y, h_final
    lib = _lib()
    if n < 1 or lib.ssd_scan_smem_bytes(n) > SMEM_LIMIT:
        raise ValueError(f"the kernel keeps a chunk of B and C in shared "
                         f"memory: N={n} needs more than a block may use")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_f32(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), y.data_ptr(), h_final.data_ptr(), b, s, h, p, n,
            min(chunk, s), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return y, h_final
