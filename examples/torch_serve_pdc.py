"""The paper's serving pipeline on the PyTorch port, on batched requests:
PDC disaggregation with EMS context caching over a disaggregated memory
pool, stateless scheduling, RDMA-plane KV handoff and continuous-batched
decode (optionally MTP) -- ``examples/serve_pdc.py`` on the port's
``ServingSystem``, at the same smoke sizes. With ``--arch deepseek-r1``
every decode step runs the MLA decode-attention kernel on the card.

    PYTHONPATH=src python examples/torch_serve_pdc.py [--mtp] \\
        [--arch deepseek-r1] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import init_mtp_params
from repro_torch.device import add_device_arg, resolve_device
from repro_torch.mempool import ContextCache, MemoryPool
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingSystem


def requests(cfg, seed: int = 0) -> List[Request]:
    """A multi-turn style workload: a shared system prompt of 24 tokens and
    8 tokens per user, 6 users, 6 new tokens each."""
    rng = np.random.RandomState(seed)
    system_prompt = list(rng.randint(0, cfg.vocab_size, 24))
    return [Request(i, system_prompt + list(rng.randint(0, cfg.vocab_size,
                                                        8)), 6)
            for i in range(6)]


def serve(params, cfg, reqs: Sequence[Request], mtp=None, device=None):
    """Serve ``reqs`` through ``ServingSystem`` (2 prefill instances, a
    decode batch of 3, capacity 64) with an EMS context cache of 8-token
    blocks over a 16-node memory pool; MTP when ``mtp`` (a draft head) is
    given. Returns (results, system, pool)."""
    pool = MemoryPool(n_nodes=16)
    cc = ContextCache(pool, block_tokens=8, model_tag=cfg.name)
    system = ServingSystem(params, cfg, n_prefill=2, decode_batch=3,
                           capacity=64, context_cache=cc,
                           use_mtp=mtp is not None, mtp_params=mtp,
                           device=device)
    return system.serve(list(reqs)), system, pool


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mtp", action="store_true")
    ap.add_argument("--arch", default="qwen3-8b")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_variant(get_config(args.arch))
    params = init_params(cfg, seed=0, device=dev)
    mtp = init_mtp_params(cfg, seed=1, device=dev) if args.mtp else None
    reqs = requests(cfg)
    results, system, pool = serve(params, cfg, reqs, mtp, dev)

    print(f"{'rid':>3} {'inst':>4} {'reuse':>5} {'comp':>5} tokens")
    for r in sorted(results, key=lambda r: r.rid):
        print(f"{r.rid:>3} {r.prefill_instance:>4} {r.reused_tokens:>5} "
              f"{r.computed_tokens:>5} {r.tokens}")
    s = pool.stats()
    print(f"\npool: hit_rate={s['hit_rate']:.2f} "
          f"dram={s['dram_used'] / 2 ** 20:.0f}MiB "
          f"balance={s['load_balance']:.2f}")
    print(f"KV handoffs: {system.transfer.transfers} "
          f"({system.transfer.bytes_moved / 2 ** 20:.1f} MiB over RDMA "
          "plane)")
    comp = sum(r.computed_tokens for r in results)
    tot = sum(len(rq.prompt) for rq in reqs)
    saved = 1 - comp / tot
    print(f"prefill compute saved by context cache: {100 * saved:.0f}%")
    return {"arch": cfg.name, "mtp": args.mtp,
            "tokens": {r.rid: list(r.tokens) for r in results},
            "reused_tokens": sum(r.reused_tokens for r in results),
            "hit_rate": s["hit_rate"], "handoffs": system.transfer.transfers,
            "handoff_mib": system.transfer.bytes_moved / 2 ** 20,
            "prefill_saved": saved}


if __name__ == "__main__":
    main()
