#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--sweep]

Phases, each of which must pass (the script exits non-zero otherwise):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off for
   matmul and cuDNN.
2. build: every CUDA kernel of the port, compiled from ``src/repro_torch/
   kernels/csrc`` into ``build/kernels/`` (one ``nvcc`` per source, all at
   once).
3. serve: DeepSeek-R1 at full width cut to 4 layers (3 dense + 1 MoE with
   all 256 experts), bf16 random weights from a seed, through
   ``ServingSystem.serve``: 8 requests with prompt lengths drawn uniformly
   from 256-1024 tokens and 32 new tokens each. Every request must finish,
   and the kernel's launch count must equal decode steps x 4 MLA layers.
   Wall-clock prefill time and TTFT per request, TTFT/TPOT p50 and decode
   tokens/s.
4. kernel: ``mla_decode_attention`` against its plain PyTorch version at
   DeepSeek-R1 widths (B=8, H=128, R=512, Dr=64), S=2048 and a ragged
   S=1000 with per-row ``cache_len`` including 0, S-1 and S, full rows,
   and the serve phase's own final lengths (the row the kernels line
   reports); median CUDA-event times of the kernel, the plain version and
   one library call, beside the least time the card could take. With
   ``--sweep``, also the kernel at each ``n_split`` of SWEEP_SPLITS.
5. agreement: requests of three prompt seeds served with
   ``moe_fn=moe_reference`` (no capacity drops) are replayed through
   ``decode_step`` (kernel on) and checked against a full-sequence
   ``prefill`` over prompt + generated tokens (logits within AGREE_ATOL
   where both chose the same experts; served tokens equal to the
   reference's argmax where its margin is clear).

The last two lines of standard output are a ``{"kernels": [...]}`` JSON
object and ``{"ok": true, "device": {...}}``. Without CUDA, or without the
port's package beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

SEED = 0
KERNEL_TOL = 3e-5        # f32 kernel vs f32 plain version (summation order)
# bf16 agreement of decode replay vs full prefill: logits have unit scale
# (rms-normed state times a fan-in-scaled head), a bf16 ulp near 4 is
# 2^-6, and the absorbed decode and unabsorbed prefill round at different
# places through 4 layers -- 0.1 allows ~6 ulps at the largest logits.
AGREE_ATOL = 0.1
AGREE_SEEDS = (1, 2, 3)      # prompt seeds (offsets of SEED), 3 prompts each
# Where the two forms chose different experts the logits are not compared.
# The three seeds read 6, 5 and 7 flips in 48 positions each (10-15 %) on
# an H100 at 700 W (PERF.md); a quarter is the most the phase lets pass.
MAX_FLIP_SHARE = 0.25
SWEEP_SPLITS = (4, 5, 8, 12, 16, 24, 32)     # n_split values of --sweep
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12      # H100 SXM data sheet, FP32 outside tensor cores


def log(*args) -> None:
    print(*args, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def timed_ms(torch, fn, reps: int, flush) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` launches, each after
    a write of ``flush`` that evicts the L2 cache (a decode step finds the
    latent cache cold: the MoE weights pass through L2 between layers)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def mla_bound(b, h, r, dr, cache_len, s):
    """Least time (ms) for absorbed-MLA decode attention on these inputs,
    and what bounds it: each input read once (the valid cache rows only)
    and the output written once over the HBM rate, against
    2*H*n*(2R+Dr) FP32 operations per row of n valid positions over the
    FP32 rate."""
    n = [min(int(c), s - 1) + 1 for c in cache_len]
    nbytes = 4 * (sum(n) * (r + dr) + b * h * (r + dr) + b + b * h * r)
    flops = 2 * h * sum(n) * (2 * r + dr)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_phase(torch, flush, serve_lens, sweep: bool):
    from repro_torch.kernels.mla_attention import ops
    from repro_torch.kernels.mla_attention.ref import mla_decode_attention_ref

    b, h, r, dr = 8, 128, 512, 64
    scale = 1.0 / (192 ** 0.5)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        ("S=2048 edges", 2048, [0, 2047, 2048, 1024, 1, 31, 32, 2015]),
        ("S=1000 ragged", 1000, [999, 1000, 0, 500, 37, 128, 129, 777]),
        ("S=2048 full", 2048, [2047] * b),
        ("serve lengths", 2048, serve_lens),
    ]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, s, lens in cases:
        q_lat = torch.randn(b, h, r, device="cuda", generator=gen)
        q_rope = torch.randn(b, h, dr, device="cuda", generator=gen)
        cache = torch.randn(b, s, r + dr, device="cuda", generator=gen)
        cache_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = ops.mla_decode_attention(q_lat, q_rope, cache, cache_len, scale)
        torch.cuda.synchronize()
        ref = mla_decode_attention_ref(q_lat, q_rope, cache, cache_len, scale)
        err = (out - ref).abs().max().item()
        if not torch.allclose(out, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL):
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"({name}): max |err| {err:.3e}")
        # Library yardstick (never called by the port): heads as the query
        # rows of one KV head, the latent cache as K and its first R
        # columns as V.
        q = torch.cat([q_lat, q_rope], -1)[:, None]            # (B,1,H,R+Dr)
        k = cache[:, None]                                      # (B,1,S,R+Dr)
        v = cache[:, None, :, :r]
        mask = (torch.arange(s, device="cuda")[None, :]
                <= cache_len.clamp(max=s - 1)[:, None])[:, None, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = sdpa(q, k, v, attn_mask=mask, scale=scale)[:, 0]
        lib_err = (lib - ref).abs().max().item()
        row = {
            "case": name, "S": s, "cache_len": lens, "max_abs_err": err,
            "ms": timed_ms(torch, lambda: ops.mla_decode_attention(
                q_lat, q_rope, cache, cache_len, scale), 30, flush),
            "plain_ms": timed_ms(torch, lambda: mla_decode_attention_ref(
                q_lat, q_rope, cache, cache_len, scale), 30, flush),
            "library_ms": timed_ms(torch, lambda: sdpa(
                q, k, v, attn_mask=mask, scale=scale), 30, flush),
            "library_max_abs_err": lib_err,
        }
        row["bound_ms"], row["bound_by"] = mla_bound(b, h, r, dr, lens, s)
        log("kernel:", json.dumps(row))
        rows.append(row)
        chosen = ops.n_split_for(b, h, s, n_sm)
        for n in (sorted(set(SWEEP_SPLITS) | {chosen}) if sweep else ()):
            def run(n=n):
                return ops.mla_decode_attention(q_lat, q_rope, cache,
                                                cache_len, scale, n_split=n)
            if not torch.allclose(run(), ref, rtol=KERNEL_TOL,
                                  atol=KERNEL_TOL):
                raise AssertionError(f"kernel at n_split={n} disagrees "
                                     f"with its plain version ({name})")
            log("sweep:", json.dumps({
                "case": name, "n_split": n, "chosen": n == chosen,
                "ms": timed_ms(torch, run, 30, flush)}))
    return rows


def serve_config():
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-r1")
    # Depth cut only: 3 dense MLA layers + 1 MoE layer; widths whole.
    return dataclasses.replace(cfg, name="deepseek-r1-4layer", num_layers=4,
                               first_k_dense=3, dtype="bfloat16")


def serve_phase(torch, cfg, params, dev="cuda"):
    import numpy as np
    from repro_torch.kernels.mla_attention import ops
    from repro_torch.serving import Request, ServingSystem

    rng = np.random.RandomState(SEED)
    n_req, max_new = 8, 32
    lens = rng.randint(256, 1025, size=n_req)          # uniform on 256..1024
    reqs = [Request(i, [int(t) for t in rng.randint(0, cfg.vocab_size, n)],
                    max_new) for i, n in enumerate(lens)]
    system = ServingSystem(params, cfg, n_prefill=1, decode_batch=8,
                           capacity=2048, device=dev)

    # Wall-clock instrumentation around the engines' own calls: both end in
    # a host read of the sampled tokens, so the device work is done.
    prefill_start, prefill_done, steps = {}, {}, []
    pre, dec = system.prefills[0], system.decode
    run0, step0 = pre.run, dec.step_chunk

    def run(req):
        prefill_start[req.rid] = time.perf_counter()
        out = run0(req)
        prefill_done[req.rid] = time.perf_counter()
        return out

    def step_chunk(*a, **kw):
        t0 = time.perf_counter()
        finished, log_ = step0(*a, **kw)
        steps.append((t0, time.perf_counter(), [r.rid for r in finished]))
        return finished, log_

    pre.run, dec.step_chunk = run, step_chunk
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES = 0
    t_start = time.perf_counter()
    results = system.serve(reqs)
    t_end = time.perf_counter()
    launches = ops.LAUNCHES

    if len(results) != n_req or any(r.shed or len(r.tokens) != max_new
                                    for r in results):
        raise AssertionError("not every request finished: "
                             f"{[(r.rid, r.shed, len(r.tokens)) for r in results]}")
    for r in results:
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"rid {r.rid}: token out of range")
    n_steps = dec.iters
    if launches != n_steps * cfg.num_layers or launches == 0:
        raise AssertionError(f"kernel launches {launches} != decode steps "
                             f"{n_steps} x {cfg.num_layers} MLA layers")
    results = sorted(results, key=lambda r: r.rid)      # prompt_lens order
    finish = {rid: t1 for _, t1, rids in steps for rid in rids}
    ttft = [prefill_done[r.rid] - t_start for r in results]
    tpot = [(finish[r.rid] - prefill_done[r.rid]) / (max_new - 1)
            for r in results]
    decode_s = steps[-1][1] - steps[0][0]
    decode_tokens = sum(len(r.tokens) - 1 for r in results)
    step_s = [t1 - t0 for t0, t1, _ in steps]
    summary = {
        "requests": n_req, "prompt_lens": [int(n) for n in lens],
        "max_new_tokens": max_new, "decode_steps": n_steps,
        "kernel_launches": launches,
        "prefill_s": [prefill_done[r.rid] - prefill_start[r.rid]
                      for r in results],
        "ttft_s": ttft,
        "ttft_p50_s": statistics.median(ttft),
        "tpot_p50_s": statistics.median(tpot),
        "decode_step_p50_s": statistics.median(step_s),
        "decode_tokens_per_s": decode_tokens / decode_s,
        "serve_wall_s": t_end - t_start,
    }
    if dev == "cuda":
        summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    final_lens = [int(n) + max_new - 1 for n in lens]
    return summary, launches, final_lens


def agreement_phase(torch, cfg, params, dev="cuda"):
    """Decode (absorbed MLA through the kernel) against full-sequence
    prefill (unabsorbed MLA), both in bf16 with the dense MoE oracle.

    The two forms round differently, and a bf16 difference can flip a
    token's top-8 expert choice, which moves its logits by far more than
    rounding does (on the chip: ~0.2 at flipped positions, <= 0.07
    elsewhere). So every MoE call records each token's expert set, and
    the logit tolerance is held where both forms chose the same experts;
    flips are counted per prompt seed and may reach at most MAX_FLIP_SHARE
    of all positions. Requests are served one at a time (decode_batch=1),
    so the replay through ``decode_step`` repeats the serving computation
    exactly and must reproduce every served token. Where the reference's
    top-1/top-2 margin exceeds 2 x AGREE_ATOL (each logit may move by
    AGREE_ATOL) and the experts agree, the served token must be the
    reference's argmax."""
    import numpy as np
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.moe import moe_reference, route
    from repro_torch.serving import Request, ServingSystem

    n_new, capacity = 16, 512
    n_moe = cfg.num_layers - cfg.first_k_dense
    prompts, seed_of = [], []
    for k in AGREE_SEEDS:
        rng = np.random.RandomState(SEED + k)
        for n in (128, 192, 256):
            prompts.append([int(t) for t in rng.randint(0, cfg.vocab_size, n)])
            seed_of.append(k)
    system = ServingSystem(params, cfg, n_prefill=1, decode_batch=1,
                           capacity=capacity, moe_fn=moe_reference,
                           device=dev)
    results = {r.rid: r.tokens for r in system.serve(
        [Request(i, p, n_new) for i, p in enumerate(prompts)])}

    calls = []

    def recording(p, x, c):
        calls.append(route(p.router, x, c)[0].sort(dim=-1).values.cpu())
        return moe_reference(p, x, c)

    def tok(ids):
        return torch.tensor(ids, dtype=torch.int32, device=dev)

    stats = {"requests": len(prompts), "new_tokens": n_new,
             "atol": AGREE_ATOL, "max_abs_logit_err": 0.0,
             "expert_flips": 0,
             "expert_flips_per_seed": {k: 0 for k in AGREE_SEEDS},
             "max_abs_logit_err_at_flips": 0.0, "tokens_checked": 0}
    for rid, prompt in enumerate(prompts):
        served = results[rid]
        if len(served) != n_new:
            raise AssertionError(f"rid {rid} served {len(served)} tokens")
        # Replay: prefill the prompt, then teacher-force the served tokens
        # through decode_step (the kernel path).
        calls.clear()
        logits, caches = prefill(params, cfg, {"tokens": tok([prompt])},
                                 capacity, recording,
                                 cache_dtype=torch.float32)
        replay = [logits[0, -1].float()]
        experts = [torch.stack([c[-1] for c in calls[-n_moe:]])]
        for i, t in enumerate(served[:-1]):
            lg, caches = decode_step(params, cfg, tok([[t]]), caches,
                                     tok([len(prompt) + i]), recording)
            replay.append(lg[0].float())
            experts.append(torch.stack([c[0] for c in calls[-n_moe:]]))
        replay = torch.stack(replay)
        if replay.argmax(-1).tolist() != served:
            raise AssertionError(f"rid {rid}: decode replay does not "
                                 "reproduce the served tokens")
        calls.clear()
        ref_logits, _ = prefill(params, cfg, {"tokens": tok([prompt + served[:-1]])},
                                capacity, recording, cache_dtype=torch.float32)
        ref = ref_logits[0, len(prompt) - 1:].float()           # (n_new, V)
        top2 = ref.topk(2, dim=-1)
        for i in range(n_new):
            ref_experts = torch.stack([c[len(prompt) - 1 + i]
                                       for c in calls[-n_moe:]])
            err = (replay[i] - ref[i]).abs().max().item()
            if not torch.equal(experts[i], ref_experts):
                stats["expert_flips"] += 1
                stats["expert_flips_per_seed"][seed_of[rid]] += 1
                stats["max_abs_logit_err_at_flips"] = max(
                    stats["max_abs_logit_err_at_flips"], err)
                continue
            stats["max_abs_logit_err"] = max(stats["max_abs_logit_err"], err)
            if err > AGREE_ATOL:
                raise AssertionError(f"rid {rid} position {i}: decode vs "
                                     f"prefill max |dlogit| {err:.4f} > "
                                     f"{AGREE_ATOL}")
            margin = (top2.values[i, 0] - top2.values[i, 1]).item()
            if margin > 2 * AGREE_ATOL:
                stats["tokens_checked"] += 1
                if served[i] != top2.indices[i, 0].item():
                    raise AssertionError(
                        f"rid {rid} token {i}: served {served[i]}, reference "
                        f"argmax {top2.indices[i, 0].item()} (margin "
                        f"{margin:.4f})")
    if stats["expert_flips"] > MAX_FLIP_SHARE * len(prompts) * n_new:
        raise AssertionError(f"expert choice differs at {stats['expert_flips']}"
                             f" of {len(prompts) * n_new} positions")
    if stats["tokens_checked"] == 0:
        raise AssertionError("no position had a margin to check tokens at")
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also time the MLA kernel at each n_split of "
                         "SWEEP_SPLITS in every kernel-phase case")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: the port's package is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    device = device_line()
    log(device)
    kind = torch.cuda.get_device_name(0)

    from repro_torch.kernels import build
    tb = time.perf_counter()
    build_logs = build.build_all(ptxas_verbose=True)
    log(f"build: {time.perf_counter() - tb:.1f} s for {sorted(build.SOURCES)}")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build[{name}]: {line.strip()}")

    from repro_torch.models import init_params
    cfg = serve_config()
    ti = time.perf_counter()
    params = init_params(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"init: {n_params / 1e9:.3f} B parameters in "
        f"{time.perf_counter() - ti:.1f} s")

    serve, launches, final_lens = serve_phase(torch, cfg, params)
    log(f"serve: {json.dumps(serve)} on {device}")

    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = kernel_phase(torch, flush, final_lens, args.sweep)
    del flush

    agree = agreement_phase(torch, cfg, params)
    log(f"agreement: {json.dumps(agree)}")

    main_row = rows[-1]
    kernels = [{
        "name": "mla_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mla_decode_attention.cu",
        "replaces": "src/repro/kernels/mla_attention/mla_attention.py:69",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    log(f"total: {time.perf_counter() - t0:.1f} s")
    log(device)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:                     # any failed phase fails the run
        traceback.print_exc()
        sys.exit(1)
