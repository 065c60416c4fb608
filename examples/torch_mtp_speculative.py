"""MTP speculative decoding (paper §4.2.4) on the PyTorch port, step by
step: plain greedy decoding, then MTP iterations (a draft validated by the
next forward, 1 + accepted tokens each) with their acceptance, then the
fused loop (``decode_loop_mtp``: draft, verify, sample and accept on the
device, one host sync); both MTP forms must emit the greedy tokens --
``examples/mtp_speculative.py`` on the port's entry points, at the same
smoke sizes.

    PYTHONPATH=src python examples/torch_mtp_speculative.py [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import init_mtp_params
from repro_torch.core.mtp import mtp_step, propose_draft
from repro_torch.device import add_device_arg, resolve_device
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.model import decode_loop_mtp

#: tokens to emit; the caches' capacity
N_NEW, CAPACITY = 10, 64


def _prefill(params, cfg, prompt: Sequence[int], device):
    tokens = torch.tensor([list(prompt)], dtype=torch.int32, device=device)
    return prefill(params, cfg, {"tokens": tokens}, capacity=CAPACITY,
                   cache_dtype=torch.float32)


def plain_greedy(params, cfg, prompt: Sequence[int], n_new: int = N_NEW
                 ) -> List[int]:
    """``n_new`` greedy tokens after ``prompt``: a prefill, then one decode
    step per token."""
    dev = params.embed.device
    logits, caches = _prefill(params, cfg, prompt, dev)
    ref = [int(torch.argmax(logits[0, -1]))]
    cl = torch.tensor(len(prompt), dtype=torch.int32, device=dev)
    for _ in range(n_new - 1):
        tok = torch.tensor([[ref[-1]]], dtype=torch.int32, device=dev)
        lg, caches = decode_step(params, cfg, tok, caches, cl)
        ref.append(int(torch.argmax(lg[0])))
        cl = cl + 1
    return ref


def mtp_stepwise(params, mtp, cfg, prompt: Sequence[int], n_new: int = N_NEW
                 ) -> Tuple[List[int], int, int, List[bool]]:
    """MTP one iteration at a time (``mtp_step``, greedy): (the first
    ``n_new`` tokens, iterations, accepted drafts, each iteration's
    acceptance)."""
    dev = params.embed.device
    logits, caches = _prefill(params, cfg, prompt, dev)
    x = torch.argmax(logits[:, -1], -1).to(torch.int32)
    d = propose_draft(params, mtp, cfg, x)
    cl = torch.full((1,), len(prompt), dtype=torch.int32, device=dev)
    got, per_iter = [int(x[0])], []
    while len(got) < n_new:
        em, acc, x, d, caches, cl = mtp_step(params, mtp, cfg, x, d, caches,
                                             cl, greedy=True)
        got.append(int(em[0, 0]))
        per_iter.append(bool(acc[0]))
        if per_iter[-1] and len(got) < n_new:
            got.append(int(em[0, 1]))
    return got[:n_new], len(per_iter), sum(per_iter), per_iter


def mtp_fused(params, mtp, cfg, prompt: Sequence[int], n_new: int = N_NEW
              ) -> List[int]:
    """The same through ``decode_loop_mtp`` with the fused verify:
    ``n_new - 1`` iterations, enough whatever is accepted, each slot
    stopping after ``n_new - 1`` tokens."""
    dev = params.embed.device
    logits, caches = _prefill(params, cfg, prompt, dev)
    x = torch.argmax(logits[:, -1], -1).to(torch.int32)
    d = propose_draft(params, mtp, cfg, x)
    em, acc, lv, *_ = decode_loop_mtp(
        params, mtp, cfg, x, d, caches,
        torch.full((1,), len(prompt), dtype=torch.int32, device=dev),
        n_iters=n_new - 1, fused_verify=True,
        steps_left=torch.full((1,), n_new - 1, dtype=torch.int32,
                              device=dev))
    em, acc, lv = em.tolist(), acc.tolist(), lv.tolist()
    fused = [int(x[0])]
    for j in range(n_new - 1):
        if not lv[0][j]:
            break
        fused.append(em[0][j][0])
        if acc[0][j] and len(fused) < n_new:
            fused.append(em[0][j][1])
    return fused[:n_new]


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_variant(get_config("qwen3-8b"))
    params = init_params(cfg, seed=0, device=dev)
    mtp = init_mtp_params(cfg, seed=1, device=dev)
    prompt = list(np.random.RandomState(0).randint(0, cfg.vocab_size, 20))

    ref = plain_greedy(params, cfg, prompt)
    print("plain greedy :", ref, f"({N_NEW} iterations)")
    got, iters, accepts, per_iter = mtp_stepwise(params, mtp, cfg, prompt)
    print("MTP greedy   :", got, f"({iters} iterations, {accepts} accepted "
          f"drafts; per iteration {[int(a) for a in per_iter]})")
    if got != ref:
        raise AssertionError("speculative decoding must preserve greedy "
                             f"output: {got} != {ref}")
    print(f"tokens/iteration: {len(got) / iters:.2f} (untrained draft head; "
          "the paper's trained MTP reaches ~1.7)")
    fused = mtp_fused(params, mtp, cfg, prompt)
    print("fused loop   :", fused, "(decode_loop_mtp: draft + verify + "
          "sample + accept on the device, one host sync)")
    if fused != ref:
        raise AssertionError(f"the fused loop's {fused} != greedy {ref}")
    return {"greedy": ref, "mtp": got, "fused": fused, "iterations": iters,
            "accepted": accepts, "per_iteration": per_iter,
            "tokens_per_iteration": len(got) / iters,
            "equal_to_greedy": got == ref and fused == ref}


if __name__ == "__main__":
    main()
