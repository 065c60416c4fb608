#!/usr/bin/env python3
"""Where a Qwen3-8B decode step spends its time on the card (PyTorch/CUDA
port, one GPU).

    python3 scripts/torch_dense_decode_profile.py [--batch 8] [--capacity 2048]

Qwen3-8B whole (bf16 random weights from seed 0, as ``chip_smoke.py``'s
serve-dense makes them) takes ``decode_step`` at ``--batch`` rows against
f32 caches of ``--capacity`` slots, every row at ``cache_len`` 1000 (as in
serving, GQA attention masks and reads every slot). After three warm-up
steps it prints the wall time of ten synchronized steps, then one step
under ``torch.profiler``: the device time by kernel (the top rows of
``key_averages``), the kernels launched, the device's total and its
share of the profiled wall
time and of the unprofiled steps' median (the profiler slows the host,
not the kernels). Beside them, the bytes a step must move -- the weights and the f32
K/V of every slot, each read once -- and the least time they take at the
data sheet's HBM rate. The last line is one JSON object of these numbers.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=2048)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_dense_decode_profile: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, make_caches

    device = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(device, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-8b")
    params = init_params(cfg, seed=0)
    caches = make_caches(cfg, args.batch, args.capacity, torch.float32)
    tok = torch.zeros((args.batch, 1), dtype=torch.int32, device="cuda")
    cache_len = torch.full((args.batch,), 1000, dtype=torch.int32,
                           device="cuda")

    def step():
        decode_step(params, cfg, tok, caches, cache_len)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    print(events.table(sort_by="self_cuda_time_total", row_limit=12))
    # Kernel rows only (device_type CUDA), as the table's own total sums.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    kv_bytes = sum(c.k.numel() * 4 + c.v.numel() * 4 for c in caches.values())
    print(json.dumps({
        "device": device, "batch": args.batch, "capacity": args.capacity,
        "step_wall_ms_p50": statistics.median(walls),
        "profiled_step_wall_ms": profiled_ms, "device_ms": device_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "device_share_of_profiled_step": device_ms / profiled_ms,
        "device_share_of_step_wall_p50": device_ms
        / statistics.median(walls),
        "weight_bytes": weight_bytes, "kv_bytes": kv_bytes,
        "bytes_bound_ms": 1e3 * (weight_bytes + kv_bytes) / HBM_BYTES_PER_S,
        "kv_bound_ms": 1e3 * kv_bytes / HBM_BYTES_PER_S}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
