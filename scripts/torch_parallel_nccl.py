#!/usr/bin/env python3
"""The parallel layer's collectives, and the dry run's sharded steps, across
four cards over NCCL.

    python3 scripts/torch_parallel_nccl.py                 # needs 4 GPUs
    python3 scripts/torch_parallel_nccl.py --cases train-qwen3,decode-r1

Four ranks, one card each, over a 2 x 2 ``("data", "model")`` mesh
(``launch.mesh.make_debug_mesh``; a file rendezvous in a temporary
directory). ``--cases`` takes any of ``lep``, ``hybrid``, ``decode-seq``
and the sharded steps of ``launch/sharded_step.py``'s ``CASES``
(default: all of them, in this order):

1. lep: Kimi K2's MoE layer at its widths (384 experts top-8 of d_ff 2048,
   d_model 7168, one shared expert; bf16; the same seeded weights on every
   rank) at capacity factor 8, so that no token is dropped at either world
   size, on a 1019-row and an 8-row input (seeded). Every 2-D mode of
   ``make_lep_moe_fn`` (those of ``tests/test_torch_lep2d.py``), each rank
   holding only its own expert slots and F-shard (``keep_local_experts``;
   the whole layer is freed first): each rank's
   output bit-equal to rank 0's, nothing dropped, and within TOL of the
   largest value of the 1-D LEP at world size 1 on the same card (same
   ``quantize``, whole weights), which issues no collective. CUDA-event ms
   of both, and the expert bytes each rank holds.
2. hybrid: one MLA layer at DeepSeek-R1's widths (bf16, seeded) on x of
   (1, 1018, 7168): ``mla_prefill_hybrid`` in both forms over the model
   axis (2 ranks, 64 heads each) against ``mla_prefill`` on the same card,
   within TOL of its largest value; ms of both.
3. decode-seq: one MLA decode layer at DeepSeek-R1's widths (bf16 weights
   placed by the serving specs, a float32 latent cache of 8 rows x 2048
   positions) over a 1 x 4 mesh, the cache's sequence cut into four
   blocks of 512, one a card (``mla_decode`` on DTensors: each card's
   block through the kernel with ``return_lse``, the blocks merged by
   all-reduces over NCCL), rows ending inside the first block (the other
   three blocks empty for them), a capacity-frozen row and the R1 serve's
   lengths; against ``mla_decode`` on one card (the whole cache, the
   kernel), within TOL of its largest value, each card having launched
   the kernel once; ms of both.

4. The dry run's sharded steps (``train-qwen3``, ``train-olmoe``,
   ``train-mamba2``, ``decode-r1``, ``decode-olmoe``, ``prefill-r1``,
   ``prefill-r1-a2a``, ``prefill-r1-rs``, ``prefill-qwen3``,
   ``prefill-mamba2``, ``train-r1``; their configs, depth cuts, shapes and
   hybrid modes in ``launch/sharded_step.py``'s ``CASES``) on real CUDA
   tensors:
   ``dryrun.build_step`` on the card, every weight drawn from the seed and
   placed by the specs one at a time, caches and batch placed as the dry
   run places its meta tensors, TF32 off. Each is held against the same
   step unsharded on rank 0's card, run over the row groups the ranks'
   products take (``sharded_step.row_groups``: a data rank's rows; in a
   train step with LEP, ``train-olmoe`` and ``train-r1``, a mesh rank's,
   LEP's token split), at fixed tolerances (``sharded_step.compare``: a train
   step's loss and global gradient norm within 1e-5, each parameter and
   both moments within 2e-4 of the leaf's largest -- for ``train-qwen3``
   and ``train-mamba2``, which carry no INT8 payload, no further from the
   same step in float64 on rank 0's host (``sharded_step.truth``) than
   the unsharded step plus 2e-4, its time and the process's peak RSS
   beside it --; a prefill or decode step's caches (and a decode step's
   written rows) within TOL, and on the rows ``Case.logits`` names its
   logits within TOL and its greedy tokens equal where the top-2 margin
   exceeds it; ``decode-r1``'s and the prefills' logits through the same
   step run again with float32 weights, every row within TOL;
   ``train-olmoe`` and ``train-r1`` again with an unquantized payload on
   both sides, ``Case.f32_payload``, a row of its own held alike). Printed
   beside it, never a limit: that reference against itself evaluated
   otherwise (``floor``: a train or prefill step over the whole batch --
   a train step with LEP over the data ranks' row groups --, a decode
   step with its caches nudged by one part in 1e7), how far rounding
   alone moves it. ``train-olmoe`` and ``train-r1`` with their INT8
   payload are held instead by their discrete choices: the INT8 codes,
   scales and router picks of every MoE layer, recorded on every rank by
   global token (``sharded_step.record_choices``), against the reference's
   own (``choices``: codes within one, scales within 1e-4, a flipped pick
   only where the reference's two probabilities lie within 1e-4 of the
   token's largest, ``sharded_step.compare_choices``), and by the
   reference run again on rank 0 with the step's choices in place of its
   own (``replay``: ``compare`` at its fixed tolerances), its seconds and
   rank 0's peak GiB beside it (``replay_s``, ``replay_peak_gib``). And
   its collective bytes by kind on rank 0
   (``CollectiveCounter``) against the dry run's record of the same case
   on a fake 2 x 2 group (``python -m repro_torch.launch.sharded_step``,
   traced in a process of its own beside the ranks), byte for byte; and
   against NCCL's own record of what it ran (the ``record_param_comms``
   events of a ``torch.profiler`` trace of the step, in the counter's
   convention), within 1 % by kind. Beside them: the kernels' launches on
   the step, the NCCL kernels' device time from the same trace against the
   record's computed collective term (no gate), build, step and reference
   seconds, and each rank's peak GiB.

Rank 0 prints one JSON line per case, then ``{"ok": true, ...}``; any
failed check fails the run. The caching allocator grows its blocks in
place (``expandable_segments``, unless ``PYTORCH_CUDA_ALLOC_CONF`` says
otherwise): train-r1's unsharded step fills most of
rank 0's card, where fixed segments fragment. The same collectives are
held against JAX on the CPU by ``tests/test_torch_lep2d.py``,
``tests/test_torch_hybrid_parallel.py`` and
``tests/test_torch_sharded_steps.py`` (gloo ranks).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

WORLD, N_DATA, N_MODEL = 4, 2, 2
DECODE_LENS = [971, 846, 300, 479, 2048, 994, 5, 296]   # 300, 5: block 0 only
LAYER_CASES = ("lep", "hybrid", "decode-seq")
#: NCCL's bytes of a kind against the counter's
TRACE_RTOL = 0.01
KERNEL_MODULES = ("mla_attention", "dispatch_quant", "int8_gemm", "ssd_scan")
DECODE_S = 2048
SEED = 0
TOL = 0.02            # of the reference's largest |value|; bf16 outputs
LEP_TOKENS = (1019, 8)
HYBRID_S = 1018       # divides over the model axis
MODES = {
    "model": dict(ep_axes=("model",)),
    "full": dict(ep_axes=("data", "model")),
    "full_redundancy": dict(ep_axes=("data", "model"), redundancy=2),
    "ffn_weights": dict(ep_axes=("model",), ffn_shard_axis="data"),
    "ffn_tokens": dict(ep_axes=("model",), ffn_shard_axis="data",
                       ffn_gather="tokens"),
    "ffn_tokens_quantized": dict(ep_axes=("model",), ffn_shard_axis="data",
                                 ffn_gather="tokens", quantize_gather=True),
    "naive": dict(ep_axes=("model",), naive=True),
    "bf16_payload": dict(ep_axes=("model",), quantize=False),
}


def timed_ms(torch, fn, reps=5):
    """Median CUDA-event time of ``fn`` after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def rel(torch, a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def same_on_every_rank(torch, dist, t):
    """Whether every rank holds ``t`` bit for bit."""
    ref = t.clone()
    dist.broadcast(ref, 0)
    flag = torch.tensor([int(torch.equal(ref, t))], device=t.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def run(rank, init, out_path, cases, trace_dir):
    import torch
    import torch.distributed as dist
    from repro_torch.launch import sharded_step as ss
    from repro_torch.launch.mesh import make_debug_mesh

    torch.cuda.set_device(rank)
    # Products in full float32 (no TF32), and bf16 products summed in
    # float32 (cuBLAS may otherwise sum split-K partials in bf16).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    # The other ranks wait at a barrier while rank 0 runs a train case's
    # float64 step on its host.
    dist.init_process_group("nccl", init_method=init, rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=900))
    mesh = make_debug_mesh(N_DATA, N_MODEL, "cuda")

    def keep(rows):
        # Rank 0's rows go out as they come, so a later case's failure
        # leaves the earlier ones.
        if rank == 0:
            with open(out_path, "a") as f:
                f.writelines(json.dumps(r) + "\n" for r in rows)

    if "lep" in cases:
        keep(lep_rows(torch, dist, rank, mesh))
    if "hybrid" in cases or "decode-seq" in cases:
        keep(mla_rows(torch, dist, rank, mesh, cases))
    for name in cases:
        if name not in LAYER_CASES:
            keep([sharded_step_row(torch, dist, rank, mesh, name,
                                   trace_dir)])
            if ss.CASES[name].f32_payload:
                keep([{"case": name, "payload": "float32",
                       **(f32_row(torch, rank, mesh, name, quantize=False)
                          or {})}])
                dist.barrier()
    dist.destroy_process_group()


def gen_on(torch, seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def cut(name):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name), capacity_factor=8.0)


def lep_rows(torch, dist, rank, mesh):
    """Case 1: LEP at Kimi K2's MoE layer: the 1-D references on the whole
    layer, then each mode on a fresh layer cut to the rank's share."""
    from repro_torch.core.lep import keep_local_experts, make_lep_moe_fn
    from repro_torch.models.moe import MoE

    device = torch.device("cuda", rank)
    dtype = torch.bfloat16
    lines = []
    gen = lambda seed: gen_on(torch, seed)  # noqa: E731
    cfg = cut("kimi-k2-1t-a32b")
    moe = MoE(cfg, device, dtype, gen(SEED))
    whole_bytes = sum(w.numel() * w.element_size()
                      for w in (moe.w_gate, moe.w_up, moe.w_down))
    xs = {t: torch.randn((t, cfg.d_model), generator=gen(SEED + t),
                         device=device, dtype=dtype) for t in LEP_TOKENS}
    refs, ref_ms = {}, {}
    for q in (True, False):
        fn = make_lep_moe_fn(quantize=q)
        for t, x in xs.items():
            refs[q, t] = fn(moe, x, cfg)[0]
            ref_ms[q, t] = timed_ms(torch, lambda: fn(moe, x, cfg))
    del moe
    torch.cuda.empty_cache()
    for name, kw in MODES.items():
        moe = MoE(cfg, device, dtype, gen(SEED))
        keep_local_experts(moe, mesh=mesh, **kw)
        torch.cuda.empty_cache()
        held = sum(w.untyped_storage().nbytes()
                   for w in (moe.w_gate, moe.w_up, moe.w_down))
        fn = make_lep_moe_fn(mesh=mesh, **kw)
        quantized = kw.get("quantize", True) and not kw.get("naive")
        for t, x in xs.items():
            out, aux = fn(moe, x, cfg)
            row = {"case": "lep", "mode": name, "tokens": t,
                   "expert_gb_held": held / 1e9,
                   "expert_gb_whole": whole_bytes / 1e9,
                   "rel_err_vs_1d": rel(torch, out, refs[quantized, t]),
                   "dropped": int(aux["dropped"]),
                   "ranks_equal": same_on_every_rank(torch, dist, out),
                   "ms_2x2": timed_ms(torch, lambda: fn(moe, x, cfg)),
                   "ms_1d_world1": ref_ms[quantized, t]}
            lines.append(row)
            if not (row["rel_err_vs_1d"] <= TOL and row["dropped"] == 0
                    and row["ranks_equal"]):
                raise AssertionError(f"rank {rank}: {row}")
        del fn, out, moe
        torch.cuda.empty_cache()
    del refs
    return lines


def mla_rows(torch, dist, rank, mesh, cases):
    """Cases 2 and 3 on one MLA layer at DeepSeek-R1's widths."""
    from repro_torch.models.mla import MLA

    device = torch.device("cuda", rank)
    dtype = torch.bfloat16
    lines = []
    gen = lambda seed: gen_on(torch, seed)  # noqa: E731
    cfg = cut("deepseek-r1")
    layer = MLA(cfg, device, dtype, gen(SEED))
    if "hybrid" in cases:
        lines += hybrid_rows(torch, dist, rank, mesh, layer, cfg, gen)
    if "decode-seq" in cases:
        lines.append(decode_seq_row(torch, dist, rank, layer, cfg, gen))
    del layer
    torch.cuda.empty_cache()
    return lines


def hybrid_rows(torch, dist, rank, mesh, layer, cfg, gen):
    """Case 2: the hybrid MLA prefill at DeepSeek-R1's widths."""
    from repro_torch.core.hybrid_parallel import mla_prefill_hybrid
    from repro_torch.models.mla import mla_prefill

    lines = []
    x = torch.randn((1, HYBRID_S, cfg.d_model), generator=gen(SEED + 1),
                    device=layer.wq_a.device, dtype=layer.wq_a.dtype)
    plain, plain_lat = mla_prefill(layer, x, cfg)
    plain_ms = timed_ms(torch, lambda: mla_prefill(layer, x, cfg))
    for mode in ("a2a", "rs"):
        out, lat = mla_prefill_hybrid(layer, x, cfg, mesh, oproj_mode=mode)
        row = {"case": "hybrid", "mode": mode, "S": HYBRID_S,
               "rel_err_vs_plain": rel(torch, out, plain),
               "latent_rel_err_vs_plain": rel(torch, lat, plain_lat),
               "ranks_equal": same_on_every_rank(torch, dist, out),
               "ms_model_axis_2": timed_ms(torch, lambda: mla_prefill_hybrid(
                   layer, x, cfg, mesh, oproj_mode=mode)),
               "ms_plain": plain_ms}
        lines.append(row)
        if not (row["rel_err_vs_plain"] <= TOL
                and row["latent_rel_err_vs_plain"] <= TOL
                and row["ranks_equal"]):
            raise AssertionError(f"rank {rank}: {row}")
    return lines


def decode_seq_row(torch, dist, rank, layer, cfg, gen):
    """Case 3: the sharded-sequence decode against the one-card kernel."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels.mla_attention import ops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import (distribute, param_pspecs,
                                             param_shapes)
    from repro_torch.models.mla import MLA, mla_decode

    device = layer.wq_a.device
    mesh = make_debug_mesh(1, WORLD, "cuda")
    x = torch.randn((8, 1, cfg.d_model), generator=gen(SEED + 2),
                    device=device, dtype=layer.wq_a.dtype)
    cache = torch.randn((8, DECODE_S, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                        generator=gen(SEED + 3), device=device)
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=device)
    specs = param_pspecs(cfg, mesh, param_shapes(cfg))["segments"][
        "dense_lead"]["attn"]
    sharded = MLA(cfg, torch.device("meta"), layer.wq_a.dtype)
    with implicit_replication():
        for name, w in layer.named_parameters():
            setattr(sharded, name, torch.nn.Parameter(
                distribute(w.detach(), mesh, specs[name][1:]),
                requires_grad=False))
        args = (distribute(x, mesh, ("data", None, None)),
                distribute(cache, mesh, ("data", "model", None)),
                distribute(lens, mesh, ()))

        def run_sharded():
            return mla_decode(sharded, args[0], args[1].clone(), args[2],
                              cfg)[0].full_tensor()

        before = ops.LAUNCHES
        out = run_sharded()
        launches = ops.LAUNCHES - before
        ms = timed_ms(torch, run_sharded)
    ref = mla_decode(layer, x, cache.clone(), lens, cfg)[0]
    row = {"case": "decode-seq", "mesh": "1x4", "S": DECODE_S,
           "cache_len": DECODE_LENS, "rel_err_vs_one_card": rel(torch, out,
                                                                ref),
           "kernel_launches_per_card": launches,
           "ranks_equal": same_on_every_rank(torch, dist, out),
           "ms_seq_sharded_4": ms,
           "ms_one_card": timed_ms(torch, lambda: mla_decode(
               layer, x, cache.clone(), lens, cfg))}
    if not (row["rel_err_vs_one_card"] <= TOL and launches == 1
            and row["ranks_equal"]):
        raise AssertionError(f"rank {rank}: {row}")
    return row


def kernel_counts():
    import importlib

    return {k: importlib.import_module(f"repro_torch.kernels.{k}.ops")
            .LAUNCHES for k in KERNEL_MODULES}


def sharded_step_row(torch, dist, rank, mesh, name, trace_dir):
    """Case 4: one of the dry run's sharded steps on CUDA tensors over the
    2 x 2 mesh, against the same step unsharded on rank 0's card; its
    collectives as the counter counts them and as NCCL's trace records
    them (the record's are added by ``main``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import sharded_step as ss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, shape, step, args = ss.case_step(name, mesh, "cuda", seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    before = kernel_counts()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
        if rank == 0 else contextlib.nullcontext()
    # An INT8 LEP train step's choices, recorded in the run that is held
    int8 = ss.CASES[name].f32_payload
    t0 = time.perf_counter()
    with prof, (ss.record_choices(ss.mesh_block(mesh)) if int8
                else contextlib.nullcontext()) as rec:
        out, counts = ss.run_counted(step, args)
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in kernel_counts().items()}
    peak = torch.tensor([torch.cuda.max_memory_allocated() / 2 ** 30],
                        device="cuda")
    got = ss.step_results(shape.kind, out, keep=rank == 0)
    choices = ss.gather_choices(rec) if int8 else None
    del out, step, args, rec
    free(torch)
    peaks = [torch.zeros_like(peak) for _ in range(WORLD)]
    dist.all_gather(peaks, peak)
    row = None
    if rank == 0:
        path = Path(trace_dir) / f"{name}.json"
        prof.export_chrome_trace(str(path))
        traced = ss.traced_collectives(json.loads(path.read_text()))
        path.unlink()
        t0 = time.perf_counter()
        row = {"case": name, "mesh": "2x2", "B": shape.global_batch,
               "S": shape.seq_len, "tf32": False,
               **reference_row(torch, ss, name, shape, got),
               "kernel_launches": launches,
               "counter_bytes": ss.bytes_by_kind(counts),
               "counter_count": counts["count"],
               "nccl_trace_bytes": ss.bytes_by_kind(traced["counts"]),
               "nccl_trace_count": traced["counts"]["count"],
               "nccl_trace_unknown": traced["unknown"],
               "nccl_kernel_ms": traced["kernel_ms"],
               "record_collective_ms": ss.collective_ms(counts),
               "build_s": build_s, "step_s": step_s,
               "reference_s": time.perf_counter() - t0,
               "peak_gib_per_rank": [p.item() for p in peaks]}
        if choices is not None:
            torch.cuda.reset_peak_memory_stats()
            row.update(ss.hold_choices(
                name, "cuda", got, choices, seed=SEED,
                n_micro=ss.row_groups(name, N_DATA, N_MODEL)))
            row["replay_peak_gib"] = \
                torch.cuda.max_memory_allocated() / 2 ** 30
        del got, choices
        free(torch)
    dist.barrier()
    if ss.CASES[name].logits == "f32":
        f32 = f32_row(torch, rank, mesh, name)
        if rank == 0:
            row["f32"] = f32
            row["ok"] = row["ok"] and f32["ok"]
        dist.barrier()
    return row


def reference_row(torch, ss, name, shape, got):
    """(Rank 0.) ``got`` against the step unsharded on this card over the
    ranks' row groups (``sharded_step.row_groups``; ``sharded_step.
    compare`` on the case's held rows; a train case marked ``f64`` also
    against that step in float64 on the host, ``sharded_step.truth``,
    with its seconds and the
    process's peak RSS before and after it); beside it, as ``floor``,
    that reference against itself evaluated otherwise -- a train step or a
    prefill over the whole batch in one group (a train step with LEP over
    the data ranks' row groups, as before LEP's token split), a decode
    step with its caches nudged by ``sharded_step.NUDGE`` -- and, given
    the truth, by the same float64 gate."""
    kind = shape.kind
    groups = ss.row_groups(name, N_DATA, N_MODEL)
    # The floor's results wait on the host, so that one reference at a
    # time holds the card (a train step's state and activations).
    other = {k: v.cpu() for k, v in ss.reference(
        name, "cuda", seed=SEED,
        **({"n_micro": N_DATA, "nudge": ss.NUDGE} if kind == "decode"
           else {"n_micro": N_DATA if groups != N_DATA else 1})).items()}
    free(torch)
    want = ss.reference(name, "cuda", n_micro=groups, seed=SEED)
    truth, f64 = None, {}
    if ss.CASES[name].f64:
        f64["rss_peak_gib_before"] = peak_rss_gib()
        t0 = time.perf_counter()
        truth = ss.truth(name, "cuda", n_micro=N_DATA, seed=SEED)
        f64.update(truth_s=time.perf_counter() - t0,
                   rss_peak_gib_after=peak_rss_gib(),
                   threads=torch.get_num_threads())
        free(torch)
    rows = ss.held_rows(name, shape, N_MODEL) if kind != "train" else None
    row = ss.compare(kind, got, want, TOL, rows, truth=truth)
    if truth is not None:
        row["f64"].update(f64)
    # Given the truth, the floor is held by the same float64 gate: how far
    # another float32 rounding of the same function, with no partition,
    # moves from it.
    floor = ss.compare(kind, other, want, TOL, rows, truth=truth)
    row["floor"] = {k: floor[k] for k in (
        *ss.GATED[kind], *ss.GATED["train-f64"], "leaves_over", "f64",
        "logits_err_by_row") if k in floor}
    del want, other, truth
    free(torch)
    return row


def peak_rss_gib():
    """This process's peak resident set so far, in GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def f32_row(torch, rank, mesh, name, quantize=None):
    """Case ``name``'s step again with float32 weights over the same mesh
    (every rank), against the same float32 step unsharded on rank 0's
    card, every row held (``sharded_step.compare``); with ``quantize``
    False, with an unquantized payload on both sides; rank 0's row."""
    from repro_torch.launch import sharded_step as ss

    cfg = ss.case_config(name, dtype="float32")
    _, shape, step, args = ss.case_step(name, mesh, "cuda", seed=SEED,
                                        cfg=cfg, quantize=quantize)
    out, _ = ss.run_counted(step, args)
    got = ss.step_results(shape.kind, out, keep=rank == 0)
    del out, step, args
    free(torch)
    row = None
    if rank == 0:
        want = ss.reference(name, "cuda", seed=SEED, cfg=cfg,
                            n_micro=ss.row_groups(name, N_DATA, N_MODEL),
                            quantize=quantize)
        row = {"dtype": "float32", **ss.compare(shape.kind, got, want, TOL)}
        del want, got
        free(torch)
    return row


def free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def trace_within(counter, traced):
    """Whether NCCL's bytes of each kind are within TRACE_RTOL of the
    counter's."""
    return all(abs(traced[k] - n) <= TRACE_RTOL * n if n else traced[k] == 0
               for k, n in counter.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default=None,
                    help="comma-separated cases (default: all)")
    args = ap.parse_args(argv)
    from repro_torch.launch.sharded_step import CASES

    cases = args.cases.split(",") if args.cases else \
        list(LAYER_CASES) + list(CASES)
    unknown = [c for c in cases if c not in LAYER_CASES and c not in CASES]
    if unknown:
        ap.error(f"unknown cases {unknown}")
    steps = [c for c in cases if c not in LAYER_CASES]

    import torch
    import torch.multiprocessing as mp

    if torch.cuda.device_count() < WORLD:
        print(f"torch_parallel_nccl: needs {WORLD} GPUs, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="torch_parallel_nccl_"))
    # The dry run's records of the sharded steps on a fake 2 x 2 group, in
    # a process of its own (a fake group and NCCL's cannot share one).
    records = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.sharded_step", "--cases",
         ",".join(steps), "--mesh", f"{N_DATA}x{N_MODEL}"],
        env={**os.environ, "PYTHONPATH": str(HERE / "src")}, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) if steps else None
    failed = []
    try:
        try:
            mp.spawn(run, args=(f"file://{tmp / 'rendezvous'}",
                                str(tmp / "out"), cases, str(tmp)),
                     nprocs=WORLD)
        except Exception as e:  # noqa: BLE001 -- print the rows before it
            failed.append(f"ranks: {str(e)[-3000:]}")
        recs = {}
        if records is not None:
            stdout, err = records.communicate(timeout=600)
            if records.returncode:
                raise AssertionError(f"the dry run's records: {err[-3000:]}")
            recs = json.loads(stdout.strip().splitlines()[-1])
    finally:
        if records is not None and records.poll() is None:
            records.kill()
            records.wait()
    out = tmp / "out"
    for line in (out.read_text().splitlines() if out.exists() else []):
        row = json.loads(line)
        if "payload" in row:
            if not row["ok"]:
                failed.append(f"{row['case']} ({row['payload']} payload)")
        elif row["case"] in recs:
            from repro_torch.launch.sharded_step import bytes_by_kind

            record = bytes_by_kind(recs[row["case"]])
            row["record_bytes"] = record
            row["counter_equals_record"] = row["counter_bytes"] == record
            row["nccl_trace_within_1pct"] = not row["nccl_trace_unknown"] \
                and trace_within(row["counter_bytes"],
                                 row["nccl_trace_bytes"])
            # An INT8 LEP train step is held by its choices and its replay
            # (its fixed comparison and floor are printed beside them)
            held = row["choices"]["ok"] and row["replay"]["ok"] \
                if "choices" in row else row["ok"]
            if not (held and row["counter_equals_record"]
                    and row["nccl_trace_within_1pct"]):
                failed.append(row["case"])
        print(json.dumps(row), flush=True)
    if failed:
        print(f"torch_parallel_nccl: failed {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "kind": torch.cuda.get_device_name(0),
                      "ranks": WORLD, "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
