#!/usr/bin/env python3
"""Does the Mamba2 serve of ``chip_smoke.py`` depend on the phases run
before it in the same process? (PyTorch/CUDA port, one GPU.)

    python3 scripts/torch_ssm_serve_order.py [--variants none,r1,mtp,...]

Each variant runs in a process of its own: first the R1 phases it names
(``r1``: the plain serve; ``mtp``, ``ems``, ``cli``: the serve, then that
phase; ``all``: the serve, then serve-mtp, serve-ems and cli, as
``chip_smoke.py`` orders them), then the R1 weights are freed as
``chip_smoke.py`` frees them and Mamba2-780m serves the serve traffic
through ``chip_smoke.serve_phase`` twice: as ``chip_smoke.py`` does, then
with Python's garbage collector off. Printed per serve: TPOT p50, decode
step p50, decode tokens/s, the process's CPU seconds over the serve's wall
seconds (all threads), the collector's runs by generation and seconds in
it; before the first serve: objects the collector tracks (and the ten
most common types), threads, device memory allocated and reserved.

Two more variants run the whole of ``chip_smoke.main``: ``smoke`` as it
is, ``smoke-skip`` with serve-mtp, serve-ems and cli replaced by stubs
that run nothing; each prints the R1 serve's and the Mamba2 serve's
readings from that run. The last line is one JSON object with every
variant's readings.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
VARIANTS = {"none": (), "r1": ("serve",), "mtp": ("serve", "mtp"),
            "ems": ("serve", "ems"), "cli": ("serve", "cli"),
            "all": ("serve", "mtp", "ems", "cli")}


def threads() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("Threads:"):
                return int(line.split()[1])
    return -1


def timed_serve(torch, cs, scfg, sparams, gc_on: bool) -> dict:
    runs, spent, starts = collections.Counter(), [0.0], {}

    def on_gc(phase, info):
        if phase == "start":
            starts["t"] = time.perf_counter()
        else:
            runs[info["generation"]] += 1
            spent[0] += time.perf_counter() - starts["t"]

    gc.callbacks.append(on_gc)
    if not gc_on:
        gc.disable()
    cpu0, t0 = os.times(), time.perf_counter()
    try:
        summary, counts, _, _ = cs.serve_phase(torch, scfg, sparams)
    finally:
        wall = time.perf_counter() - t0
        cpu1 = os.times()
        gc.enable()
        gc.callbacks.remove(on_gc)
    cpu = (cpu1.user - cpu0.user) + (cpu1.system - cpu0.system)
    keys = ("tpot_p50_s", "decode_step_p50_s", "decode_tokens_per_s",
            "ttft_p50_s", "serve_wall_s", "peak_mem_gib")
    return {key: summary[key] for key in keys if key in summary} | {
        "gc_on": gc_on, "cpu_over_wall": cpu / wall,
        "gc_runs_by_generation": dict(runs), "gc_s": spent[0],
        "ssd_scan_launches": counts["ssd_scan"]}


def whole_smoke(cs, skip_new: bool) -> dict:
    """``chip_smoke.main`` in this process (the new phases stubbed out when
    ``skip_new``); the serve and serve-ssm summaries it printed."""
    import contextlib
    import io

    if skip_new:
        zero = {name: 0 for name in cs.KERNEL_MODULES}
        cs.serve_mtp_phase = lambda *a, **k: ({}, {"unfused": zero,
                                                   "fused": zero})
        cs.serve_ems_phase = lambda *a, **k: ({}, {"turn1": zero,
                                                   "turn2": zero})
        cs.cli_phase = lambda *a, **k: {"kernel_launches": zero}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cs.main([])
    out = {"rc": rc, "wall_s": time.perf_counter() - t0}
    keys = ("tpot_p50_s", "decode_step_p50_s", "decode_tokens_per_s",
            "ttft_p50_s")
    for line in buf.getvalue().splitlines():
        for tag in ("serve", "serve-ssm"):
            if line.startswith(tag + ": {"):
                summary = json.loads(line[len(tag) + 2:].rsplit(" on ", 1)[0])
                out[tag] = {key: summary[key] for key in keys}
    return out


def child(variant: str) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    if variant in ("smoke", "smoke-skip"):
        return {"variant": variant,
                **whole_smoke(cs, variant == "smoke-skip")}
    sys.path.insert(0, str(cs.SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.models import init_params

    phases = VARIANTS[variant]
    out = {"variant": variant, "phases": list(phases), "phase_s": {}}
    if phases:
        cfg = cs.serve_config()
        params = init_params(cfg, seed=cs.SEED)
        for name in phases:
            t0 = time.perf_counter()
            if name == "serve":
                _, _, _, tokens = cs.serve_phase(torch, cfg, params)
            elif name == "mtp":
                cs.serve_mtp_phase(torch, cfg, params)
            elif name == "ems":
                cs.serve_ems_phase(torch, cfg, params, tokens)
            else:
                cs.cli_phase(torch)
            out["phase_s"][name] = time.perf_counter() - t0
        del params
    gc.collect()
    torch.cuda.empty_cache()
    objs = gc.get_objects()
    out["gc_tracked_objects"] = len(objs)
    out["gc_top_types"] = collections.Counter(
        type(o).__name__ for o in objs).most_common(10)
    del objs
    out["threads"] = threads()
    out["cuda_allocated_gib"] = torch.cuda.memory_allocated() / 2 ** 30
    out["cuda_reserved_gib"] = torch.cuda.memory_reserved() / 2 ** 30
    scfg = cs.ssm_config()
    sparams = init_params(scfg, seed=cs.SEED)
    torch.cuda.synchronize()
    out["serves"] = [timed_serve(torch, cs, scfg, sparams, gc_on)
                     for gc_on in (True, False)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="none,r1,mtp,ems,cli,all",
                    help=f"comma-separated, of {sorted(VARIANTS)}, smoke "
                         "and smoke-skip")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_ssm_serve_order: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import build
    build.build_all()
    device = cs.device_line()
    print(device, flush=True)
    results = []
    for variant in args.variants.split(","):
        proc = subprocess.run([sys.executable, __file__, "--child", variant],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        results.append(row)
    print(device, flush=True)
    print(json.dumps({"device": device, "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
