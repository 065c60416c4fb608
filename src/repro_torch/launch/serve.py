"""Serving launcher: the full PDC pipeline on a batch of synthetic requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-r1 \
      --n-requests 6 --prompt-len 24 --max-new 8 [--device cpu] \
      [--mtp [--mtp-fused] [--fit-draft]] [--no-cache] \
      [--hit-aware-admission] \
      [--policy least_loaded|round_robin|queue_depth] \
      [--decode-engines 2 --decode-router least_loaded_slots|round_robin|\
       cache_affinity [--rebalance-every 4]] \
      [--autoscale --min-engines 1 --max-engines 4] \
      [--prefill-engines 2 [--stream-handoff [--stream-chunk 8]]] \
      [--joint-autoscale --min-prefill 1 --max-prefill 4 \
       --ttft-budget-ms 5] \
      [--tpot-budget-ms 15 --admission queue|shed] [--interleave] \
      [--batch-tpot-budget-ms 45 --batch-admission queue|shed \
       --interactive-frac 0.7 [--preempt-batch] [--brownout]] \
      [--decode-chunk 4 [--continuous-batching]] [--prefill-chunk 32] \
      [--poisson-rate 100 [--open-loop]] \
      [--production [--arrival-shape poisson|burst|diurnal]] \
      [--seed 0] [--trace] \
      [--fault-plan random|@plan.json|'[{...}]' [--fault-seed 0] \
       [--degrade-shed-queue-s 0.05]]

The flags, their defaults and the printed lines are the JAX package's
(``repro/launch/serve.py``); ``--device`` (default ``cuda``) is the one
addition. The model is the arch's smoke variant with random weights from
seed 0 (the draft head from seed 1). Every config of the JAX package
builds; an arch the JAX CLI cannot serve fails here with the same
exception (``hubert-xlarge``, an encoder over audio frames, has no tokens
to embed: ``KeyError: 'frames'``).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import init_mtp_params
from repro_torch.device import resolve_device
from repro_torch.mempool import EMSService, MemoryPool
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingSystem
from repro_torch.serving.faults import FaultInjector, FaultPlan
from repro_torch.serving.pool import DECODE_ROUTERS
from repro_torch.serving.scheduler import ROUTERS

def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--n-requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--shared-prefix", type=int, default=16,
                    help="tokens shared across prompts (context-cache reuse)")
    ap.add_argument("--mtp", action="store_true")
    ap.add_argument("--mtp-fused", action="store_true",
                    help="verify base+draft in one fused two-token forward "
                         "(one weight stream per MTP iteration)")
    ap.add_argument("--fit-draft", action="store_true",
                    help="distill the draft head on the model's own greedy "
                         "continuations before serving (realistic MTP "
                         "acceptance at smoke scale)")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--hit-aware-admission", action="store_true",
                    help="admission gate charges only the uncached suffix "
                         "of a request (EMS match_prefix probe at enqueue) "
                         "instead of a full slot")
    ap.add_argument("--decode-batch", type=int, default=4)
    ap.add_argument("--policy", default="least_loaded",
                    choices=sorted(ROUTERS),
                    help="prefill routing policy")
    ap.add_argument("--decode-engines", type=int, default=1,
                    help="decode pool size (independent engines behind a "
                         "routing policy, each with its own slot manager)")
    ap.add_argument("--decode-router", default="least_loaded_slots",
                    choices=sorted(DECODE_ROUTERS),
                    help="decode-pool routing policy (cache_affinity "
                         "prefers the engine holding the request's EMS "
                         "prefix blocks)")
    ap.add_argument("--rebalance-every", type=int, default=0,
                    help="every N decode turns, migrate one request's KV "
                         "from the hottest pool engine to the coldest "
                         "(0 = off)")
    ap.add_argument("--autoscale", action="store_true",
                    help="grow/shrink the decode pool between decode turns "
                         "(deterministic SLO-driven controller; "
                         "--decode-engines is the initial size)")
    ap.add_argument("--min-engines", type=int, default=1,
                    help="autoscaler lower clamp on live decode engines")
    ap.add_argument("--max-engines", type=int, default=4,
                    help="autoscaler upper clamp on live decode engines")
    ap.add_argument("--prefill-engines", type=int, default=2,
                    help="prefill pool size (spawn/park/retire lifecycle "
                         "mirrors the decode pool)")
    ap.add_argument("--joint-autoscale", action="store_true",
                    help="shift engine capacity between the prefill and "
                         "decode roles under one SLO budget (TTFT pressure "
                         "grows prefill, TPOT pressure grows decode)")
    ap.add_argument("--min-prefill", type=int, default=1,
                    help="joint-autoscale lower clamp on live prefill "
                         "instances")
    ap.add_argument("--max-prefill", type=int, default=4,
                    help="joint-autoscale upper clamp on live prefill "
                         "instances")
    ap.add_argument("--ttft-budget-ms", type=float, default=None,
                    help="TTFT SLO budget (virtual ms) driving the joint "
                         "autoscaler's prefill-pressure signal")
    ap.add_argument("--stream-handoff", action="store_true",
                    help="pipelined chunked KV handoff: stream each chunk's "
                         "KV over the RDMA plane while the next chunk "
                         "computes (TTFT charges max(prefill, transfer) + "
                         "the last chunk's wire time; token-identical to "
                         "the synchronous handoff)")
    ap.add_argument("--stream-chunk", type=int, default=None,
                    help="tokens per streamed KV chunk (default 8)")
    ap.add_argument("--seed", type=int, default=0,
                    help="PRNG seed for the synthetic request stream "
                         "(identical seed => identical trace)")
    ap.add_argument("--tpot-budget-ms", type=float, default=None,
                    help="TPOT SLO budget for the admission gate (virtual "
                         "ms); with SLO classes this is the interactive "
                         "tier's budget")
    ap.add_argument("--admission", default="queue", choices=("queue", "shed"),
                    help="hold or reject prefills that would break the SLO")
    ap.add_argument("--batch-tpot-budget-ms", type=float, default=None,
                    help="relaxed TPOT budget for the batch SLO tier "
                         "(default: share --tpot-budget-ms)")
    ap.add_argument("--batch-admission", default=None,
                    choices=("queue", "shed"),
                    help="admission mode for the batch tier "
                         "(default: share --admission)")
    ap.add_argument("--interactive-frac", type=float, default=1.0,
                    help="fraction of generated requests stamped "
                         "interactive; the rest are batch tier")
    ap.add_argument("--preempt-batch", action="store_true",
                    help="evict the youngest batch-tier decode slot when a "
                         "gate-ready interactive request would otherwise "
                         "wait (replay re-admission, token-identical)")
    ap.add_argument("--brownout", action="store_true",
                    help="climb the deterministic overload ladder under "
                         "sustained interactive pressure: shed batch "
                         "admissions -> preempt batch -> queue-age-shed "
                         "batch -> shed interactive")
    ap.add_argument("--arrival-shape", default="poisson",
                    choices=("poisson", "burst", "diurnal"),
                    help="arrival process for --production streams")
    ap.add_argument("--production", action="store_true",
                    help="production workload suite: heavy-tailed "
                         "prompt/output lengths + --interactive-frac class "
                         "mix under --arrival-shape (requires "
                         "--poisson-rate; --prompt-len/--max-new become "
                         "the length medians)")
    ap.add_argument("--interleave", action="store_true",
                    help="pair two decode microbatches per step (§4.2.3)")
    ap.add_argument("--decode-chunk", type=int, default=1,
                    help="decode iterations per host sync (scanned "
                         "device-resident decode fast path; with --mtp each "
                         "iteration speculates, so up to 2x tokens)")
    ap.add_argument("--continuous-batching", action="store_true",
                    help="adaptive scan widths + mid-scan slot refill on "
                         "the chunked fast path: shrink the next chunk to "
                         "where a finish or gate-held admission lands, and "
                         "refill freed slots between engine chunks (see "
                         "dead_slot_rate / mid_scan_refills in the summary)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="run fresh prompts through chunked prefill_continue "
                         "calls of this width (bounded compile shapes)")
    ap.add_argument("--poisson-rate", type=float, default=None,
                    help="generate Poisson arrivals at this rate (virtual "
                         "req/s) and serve open-loop")
    ap.add_argument("--open-loop", action="store_true",
                    help="arrival-time-driven serving on the virtual clock "
                         "(implied by --poisson-rate)")
    ap.add_argument("--trace", action="store_true",
                    help="dump the structured per-request trace as JSON")
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic fault schedule: 'random' (seeded by "
                         "--fault-seed), '@path/to/plan.json', or inline "
                         "JSON (a list of fault events or {'events': [...]})")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for --fault-plan random and for the "
                         "injector's derived streams")
    ap.add_argument("--degrade-shed-queue-s", type=float, default=None,
                    help="graceful degradation: shed any queued admission "
                         "held longer than this many virtual seconds "
                         "(bounds the backlog when capacity is lost)")
    ap.add_argument("--device", default="cuda",
                    help="device the engines run on (cuda, or cpu)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_variant(get_config(args.arch))
    params = init_params(cfg, seed=0, device=dev)
    cc = None
    if not args.no_cache:
        pool = MemoryPool(n_nodes=8)
        cc = EMSService(pool, block_tokens=8, model_tag=cfg.name)
    mtp_params = init_mtp_params(cfg, seed=1, device=dev) if args.mtp \
        else None

    rng = np.random.RandomState(args.seed)
    shared = min(args.shared_prefix, args.prompt_len - 1)
    open_loop = args.open_loop or args.poisson_rate is not None
    if args.production:
        if args.poisson_rate is None:
            ap.error("--production requires --poisson-rate")
        from repro_torch.serving import production_requests
        reqs = production_requests(
            args.n_requests, seed=args.seed, vocab_size=cfg.vocab_size,
            rate_rps=args.poisson_rate, arrival_shape=args.arrival_shape,
            prompt_len_median=args.prompt_len, max_new_median=args.max_new,
            interactive_frac=args.interactive_frac)
    elif args.poisson_rate is not None:
        from repro_torch.serving import poisson_requests
        reqs = poisson_requests(args.n_requests, args.poisson_rate,
                                args.prompt_len, args.max_new,
                                cfg.vocab_size, seed=args.seed,
                                shared_prefix=shared)
        for r in reqs:
            if rng.uniform() >= args.interactive_frac:
                r.slo_class = "batch"
    else:
        prefix = list(rng.randint(0, cfg.vocab_size, shared))
        reqs = [Request(i, prefix + list(rng.randint(0, cfg.vocab_size,
                                                     args.prompt_len - shared)),
                        args.max_new,
                        slo_class="interactive"
                        if rng.uniform() < args.interactive_frac
                        else "batch") for i in range(args.n_requests)]

    if args.mtp and args.fit_draft:
        # Distill on the prompts actually served: a random base model's
        # successor map is context-specific, so this is the only
        # distribution the head can meaningfully accept on (the trained-MTP
        # analogue of matching train and serve distributions).
        from repro_torch.core import fit_draft_head
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)
        mtp_params = fit_draft_head(
            params, cfg, mtp_params, gen,
            prompts=np.asarray([r.prompt for r in reqs], np.int32),
            gen_len=max(16, 2 * args.max_new))

    injector = None
    if args.fault_plan is not None:
        # Horizon estimate for the seeded random plan: enough virtual time
        # that a mid-decode crash lands while requests are still in flight.
        horizon = max(0.05, args.n_requests * args.max_new * 1.5e-3
                      / max(1, args.decode_engines))
        plan = FaultPlan.load(args.fault_plan, seed=args.fault_seed,
                              n_engines=args.decode_engines,
                              horizon_s=horizon)
        injector = FaultInjector(plan, seed=args.fault_seed)
        print(f"fault plan ({len(plan.events)} events): {plan.to_json()}")

    # Production streams draw heavy-tailed lengths up to the generator's
    # clip (256 prompt + 64 output tokens by default): size the KV slots
    # for the clip, not the medians, so long-tail requests are not all
    # capacity-rejected.
    capacity = 256 + 64 + 8 if args.production \
        else args.prompt_len + args.max_new + 8
    system = ServingSystem(params, cfg,
                           prefill_engines=args.prefill_engines,
                           decode_batch=args.decode_batch,
                           capacity=capacity,
                           decode_engines=args.decode_engines,
                           decode_router=args.decode_router,
                           decode_rebalance_every=args.rebalance_every,
                           autoscale=args.autoscale or None,
                           min_engines=args.min_engines
                           if args.autoscale or args.joint_autoscale
                           else None,
                           max_engines=args.max_engines
                           if args.autoscale or args.joint_autoscale
                           else None,
                           joint_autoscale=args.joint_autoscale or None,
                           min_prefill=args.min_prefill
                           if args.joint_autoscale else None,
                           max_prefill=args.max_prefill
                           if args.joint_autoscale else None,
                           ttft_budget_ms=args.ttft_budget_ms,
                           stream_handoff=args.stream_handoff or None,
                           stream_chunk=args.stream_chunk,
                           context_cache=cc, use_mtp=args.mtp,
                           mtp_params=mtp_params, mtp_fused=args.mtp_fused,
                           policy=args.policy,
                           tpot_budget_ms=args.tpot_budget_ms,
                           admission=args.admission,
                           batch_tpot_budget_ms=args.batch_tpot_budget_ms,
                           batch_admission=args.batch_admission,
                           preempt_batch=args.preempt_batch or None,
                           brownout=args.brownout or None,
                           interleave=args.interleave,
                           decode_chunk=args.decode_chunk,
                           continuous_batching=args.continuous_batching
                           or None,
                           prefill_chunk=args.prefill_chunk,
                           degrade_shed_queue_s=args.degrade_shed_queue_s,
                           hit_aware_admission=args.hit_aware_admission
                           or None,
                           fault_injector=injector, device=dev)
    t0 = time.time()
    results = system.serve(reqs, open_loop=open_loop)
    dt = time.time() - t0
    total_new = sum(len(r.tokens) for r in results if not r.shed)
    for r in sorted(results, key=lambda r: r.rid):
        flag = " SHED" if r.shed else ""
        print(f"rid={r.rid} prefill@{r.prefill_instance} reused={r.reused_tokens} "
              f"computed={r.computed_tokens} iters={r.decode_iters} "
              f"tokens={r.tokens}{flag}")
    print(f"\n{len(results)} requests, {total_new} tokens in {dt:.2f}s wall "
          f"({total_new/dt:.1f} tok/s on {dev.type.upper()} smoke config)")
    summary = system.scheduler.summary()
    classes = summary.pop("classes", None)
    brownout_timeline = summary.pop("brownout_timeline", None)
    print("SLO summary (virtual clock): "
          + ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                      for k, v in summary.items()))
    if classes:
        for cls, cs in sorted(classes.items()):
            print(f"  class {cls}: " + ", ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in cs.items()))
    if args.preempt_batch or args.brownout or summary.get("preemptions"):
        print(f"preemptions: {summary.get('preemptions', 0)} "
              f"(tokens replayed "
              f"{summary.get('preempt_tokens_replayed', 0)})")
    if args.brownout:
        print("brownout: level "
              + (" -> ".join(f"{to}@{t*1e3:.1f}ms"
                             for t, _frm, to in brownout_timeline)
                 if brownout_timeline else "0 throughout")
              + f" (now {summary.get('brownout_level', 0)}, peak "
              f"{summary.get('brownout_peak_level', 0)})")
    if args.decode_engines > 1 or system.pool.n > 1:
        util = summary.get("engine_util", [])
        print("decode pool: " + ", ".join(
            f"engine{st['engine']} active={st['active']} "
            f"iters={st['iters']} util={util[st['engine']] if util else 0}"
            + ("" if st["live"] else
               " (dead)" if st.get("dead") else " (parked)")
            for st in system.pool.engine_stats()))
        print(f"migrations: {system.pool.migrations} "
              f"({system.pool.migrated_bytes/2**20:.2f} MiB over RDMA plane)")
    if args.autoscale:
        sched = system.scheduler
        print("autoscale: "
              + (" -> ".join(f"{n}@{t*1e3:.1f}ms" for t, n
                             in sched.engine_count_timeline)
                 if sched.scale_events else "no scale events")
              + f" ({len(sched.scale_events)} events, live engines "
              f"{system.pool.n_live}/{system.pool.n})")
    if args.joint_autoscale:
        sched = system.scheduler
        shifts = [e for e in sched.scale_events
                  if e["action"].startswith("shift_")]
        print("joint autoscale: "
              + (" -> ".join(f"P{e['prefill_live']}/D{e['engines_live']}"
                             f"@{e['t']*1e3:.1f}ms ({e['action']})"
                             for e in shifts)
                 if shifts else "no shift events")
              + f" (prefill live {system.prefill_pool.n_live}"
              f"/{system.prefill_pool.n}, decode live "
              f"{system.pool.n_live}/{system.pool.n})")
    if args.stream_handoff:
        print(f"streamed handoff: {summary.get('stream_requests', 0)} "
              f"requests in {summary.get('stream_chunks', 0)} chunks, "
              f"{summary.get('stream_overlap_s', 0.0)*1e3:.2f} ms of "
              "transfer hidden behind prefill, max "
              f"{summary.get('stream_max_chunk_bytes', 0)/2**10:.1f} KiB "
              "in flight per chunk")
    if args.prefill_chunk:
        calls = sum(e.continue_calls for e in system.prefills)
        widths = set().union(*(e.continue_widths for e in system.prefills))
        print(f"chunked prefill: {calls} dispatches over {len(widths)} "
              f"compiled widths {sorted(widths)}")
    if cc is not None:
        print("pool:", cc.pool.stats())
        ems = cc.ems_stats()
        print("ems: "
              f"hit_rate={ems['hit_rate']:.3f} "
              f"(hbm {ems['hbm_hits']} / pool {ems['pool_hits']} / "
              f"miss {ems['fetch_misses']}), "
              f"promoted {ems['promote_bytes']/2**20:.2f} MiB, "
              f"demoted {ems['demote_bytes']/2**20:.2f} MiB, "
              f"dedup_skipped={ems['dedup_skipped']} "
              f"evictions={ems['hbm_evictions']}")
    print("transfer:", system.transfer.transfers, "handoffs,",
          f"{system.transfer.bytes_moved/2**20:.1f} MiB over RDMA plane")
    if injector is not None:
        xfer = system.transfer
        print("faults: "
              + ", ".join(f"{k}={v}" for k, v in injector.summary().items())
              + f"; recoveries={summary.get('recoveries', 0)} "
              f"tokens_replayed={summary.get('tokens_replayed', 0)} "
              f"retries={xfer.retries} timeouts={xfer.timeouts} "
              f"corruptions={xfer.corruptions}")
    if args.trace:
        print(json.dumps(system.scheduler.trace_records(), indent=1))


if __name__ == "__main__":
    main()
