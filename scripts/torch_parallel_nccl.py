#!/usr/bin/env python3
"""The parallel layer's collectives across four cards over NCCL.

    python3 scripts/torch_parallel_nccl.py                # needs 4 GPUs

Four ranks, one card each, over a 2 x 2 ``("data", "model")`` mesh
(``launch.mesh.make_debug_mesh``; a file rendezvous in a temporary
directory):

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

Rank 0 prints one JSON line per case, then ``{"ok": true, ...}``; any
failed check fails the run. The same collectives are held against JAX on
the CPU by ``tests/test_torch_lep2d.py`` and
``tests/test_torch_hybrid_parallel.py`` (gloo ranks).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import tempfile
from datetime import timedelta
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))

WORLD, N_DATA, N_MODEL = 4, 2, 2
DECODE_LENS = [971, 846, 300, 479, 2048, 994, 5, 296]   # 300, 5: block 0 only
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


def run(rank, init, out_path):
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.hybrid_parallel import mla_prefill_hybrid
    from repro_torch.core.lep import keep_local_experts, make_lep_moe_fn
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.mla import MLA, mla_prefill
    from repro_torch.models.moe import MoE

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=init, rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=300))
    mesh = make_debug_mesh(N_DATA, N_MODEL, "cuda")
    device = torch.device("cuda", rank)
    dtype = torch.bfloat16
    lines = []

    def cut(name):
        return dataclasses.replace(get_config(name), capacity_factor=8.0)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    # ---- 1. LEP at Kimi K2's MoE layer: the 1-D references on the whole
    # layer, then each mode on a fresh layer cut to the rank's share.
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

    # ---- 2. The hybrid MLA prefill at DeepSeek-R1's widths.
    cfg = cut("deepseek-r1")
    layer = MLA(cfg, device, dtype, gen(SEED))
    x = torch.randn((1, HYBRID_S, cfg.d_model), generator=gen(SEED + 1),
                    device=device, dtype=dtype)
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
    lines.append(decode_seq_row(torch, dist, rank, layer, cfg, gen))
    if rank == 0:
        Path(out_path).write_text("\n".join(json.dumps(r) for r in lines))
    dist.destroy_process_group()


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


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    import subprocess

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
    mp.spawn(run, args=(f"file://{tmp / 'rendezvous'}", str(tmp / "out")),
             nprocs=WORLD)
    print((tmp / "out").read_text(), flush=True)
    print(json.dumps({"ok": True, "kind": torch.cuda.get_device_name(0),
                      "ranks": WORLD}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
