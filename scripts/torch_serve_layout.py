#!/usr/bin/env python3
"""Does the decode layout alone move a bf16 serve's tokens, and what does
the fault plane cost when nothing fails?

    python3 scripts/torch_serve_layout.py      # needs one GPU

Qwen3-8B whole (bf16, random weights from ``chip_smoke.SEED``) serves
``chip_smoke``'s serve traffic three times, with no fault: (a) one decode
engine of 8 slots, as serve-dense does; (b) two engines of 4 slots, as
serve-faults does; (c) (b) with a fault injector whose plan is empty, so
that the KV transfer engine fingerprints every handoff (a CRC32 over the
cache's bytes on the host, before and after delivery) as it does under a
fault plan. For (b) and (c): the wall time, how many requests emit (a)'s
tokens, and ``chip_smoke.hold_fault_tokens``' checks (tokens against a
batch-1 prefill where its margin exceeds ``DENSE_MARGIN``, the margin where
each request first parts from (a)'s tokens). One JSON line per serve.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_layout: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.serving import FaultInjector, FaultPlan, ServingSystem

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.device_line(), flush=True)
    cfg = cs.dense_config()
    params = cs.init_model(torch, cfg, "dense")
    reqs = cs.serve_requests(cfg)
    base, _, _, tokens = cs.serve_phase(torch, cfg, params, reqs=reqs)
    print("layout: " + json.dumps({"serve": "1 engine x 8", **{
        k: base[k] for k in ("ttft_p50_s", "tpot_p50_s", "decode_step_p50_s",
                             "serve_wall_s")}}), flush=True)
    for name, extra in (("2 engines x 4", {}),
                        ("2 engines x 4, empty fault plan",
                         {"fault_injector": FaultInjector(FaultPlan([]))})):
        system = ServingSystem(params, cfg, n_prefill=1, decode_batch=4,
                               capacity=2048, decode_engines=2, **extra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = sorted(system.serve(cs.serve_requests(cfg)),
                         key=lambda r: r.rid)
        wall = time.perf_counter() - t0
        held = cs.hold_fault_tokens(torch, cfg, params, reqs, results,
                                    tokens, "cuda")
        print("layout: " + json.dumps({
            "serve": name, "serve_wall_s": wall,
            "requests_equal_1x8": sum(r.tokens == tokens[r.rid]
                                      for r in results), **held}),
              flush=True)
        del system, results
        cs.free_model(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
