#!/usr/bin/env python3
"""The MLA decode kernel's default call (no lse) against another build of
it, in turns on one card: another tree's ``mla_decode_attention.cu`` (its
C entry with or without the ``lse`` pointer) is built by ``nvcc`` into its
own library beside this tree's, and both are timed at the R1 serve's final
lengths (B = 8, H = 128, S = 2048, float32), other-this-this-other for
ROUNDS rounds, each time the median of a CUDA-graph replay after an L2
flush (``chip_smoke.timed_ms`` / ``graph_of``). Their outputs must be bit
for bit equal.

    python3 scripts/torch_mla_kernel_ab.py --other OTHER/mla_decode_attention.cu

Prints one JSON line per timing and a summary line: the medians of each
side and their ratio, beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(0, str(HERE))

SERVE_LENS = [971, 846, 916, 479, 1050, 994, 646, 296]
B, H, S, R, DR = 8, 128, 2048, 512, 64
ROUNDS, REPS = 5, 30


def build_other(src: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build

    out = build.BUILD_DIR / "libmla_decode_attention_other.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    n_ptr = 9 if "float* lse" in src.read_text() else 8
    lib.mla_decode_attention_f32.argtypes = [ctypes.c_void_p] * n_ptr + [
        ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    lib.mla_decode_attention_f32.restype = ctypes.c_int
    lib.n_ptr = n_ptr
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke
    from repro_torch.kernels.mla_attention import ops, plan

    print(chip_smoke.device_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    other = build_other(args.other)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q_lat = torch.randn(B, H, R, device="cuda", generator=gen)
    q_rope = torch.randn(B, H, DR, device="cuda", generator=gen)
    cache = torch.randn(B, S, R + DR, device="cuda", generator=gen)
    lens = torch.tensor(SERVE_LENS, dtype=torch.int32, device="cuda")
    scale = 1.0 / (192 ** 0.5)
    n_pieces = plan.n_pieces_for(
        B, H, S, torch.cuda.get_device_properties(0).multi_processor_count)
    slots = n_pieces + B - 1
    out = torch.empty(B, H, R, device="cuda")
    scratch = torch.empty(slots * H * (R + 2) + B + 1, device="cuda")
    acc = scratch.data_ptr()
    ml = acc + 4 * slots * H * R
    starts = ml + 4 * slots * H * 2

    def run_other():
        ptrs = [q_lat.data_ptr(), q_rope.data_ptr(), cache.data_ptr(),
                lens.data_ptr(), out.data_ptr()]
        if other.n_ptr == 9:
            ptrs.append(None)
        rc = other.mla_decode_attention_f32(
            *ptrs, acc, ml, starts, B, H, S, R, DR, n_pieces, scale,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"other build: CUDA error {rc}")
        return out

    def run_this():
        return ops.mla_decode_attention(q_lat, q_rope, cache, lens, scale)

    if not torch.equal(run_other().clone(), run_this()):
        raise AssertionError("the two builds' outputs differ")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    graphs = {"other": chip_smoke.graph_of(torch, run_other),
              "this": chip_smoke.graph_of(torch, run_this)}
    times = {"other": [], "this": []}
    for rnd in range(ROUNDS):
        for side in ("other", "this", "this", "other"):
            ms = chip_smoke.timed_ms(torch, graphs[side].replay, REPS, flush)
            times[side].append(ms)
            print(json.dumps({"round": rnd, "side": side, "graph_ms": ms}),
                  flush=True)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(json.dumps({"other_median_ms": med["other"],
                      "this_median_ms": med["this"],
                      "this_over_other": med["this"] / med["other"],
                      "other_ms": times["other"], "this_ms": times["this"],
                      "other_abi_pointers": other.n_ptr,
                      "device": chip_smoke.device_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
