"""Quickstart of the PyTorch port: its public API in a few functions.

Builds a reduced Qwen3, runs a forward pass, prefill + greedy decode, a
capacity-bounded MoE forward on OLMoE, and the §4.5 INT8 linear layer --
``examples/quickstart.py`` on the port's entry points, at the same smoke
sizes. On the card the INT8 linear runs the dispatch-quantize and INT8 GEMM
kernels.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.device import add_device_arg, resolve_device
from repro_torch.models import decode_step, forward, init_params, prefill
from repro_torch.quant import calibrate_linear, quantized_matmul

#: prompt rows and tokens; prefill capacity; greedy steps after the prompt
BATCH, PROMPT, CAPACITY, STEPS = 2, 24, 40, 8


def greedy_continuation(params, cfg, tokens: torch.Tensor,
                        steps: int = STEPS, capacity: int = CAPACITY
                        ) -> Tuple[Tuple[int, ...], List[int]]:
    """The forward's logits shape, and row 0's greedy continuation: the
    argmax after the prompt's prefill (float32 caches of ``capacity``),
    then ``steps`` decode steps."""
    logits, _ = forward(params, cfg, {"tokens": tokens})
    pl_logits, caches = prefill(params, cfg, {"tokens": tokens},
                                capacity=capacity, cache_dtype=torch.float32)
    tok = torch.argmax(pl_logits[:, -1], -1)[:, None].to(torch.int32)
    out = [int(tok[0, 0])]
    cache_len = torch.tensor(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    for _ in range(steps):
        dlogits, caches = decode_step(params, cfg, tok, caches, cache_len)
        tok = torch.argmax(dlogits, -1)[:, None].to(torch.int32)
        out.append(int(tok[0, 0]))
        cache_len = cache_len + 1
    return tuple(logits.shape), out


def moe_forward(params, cfg, tokens: torch.Tensor
                ) -> Tuple[Tuple[int, ...], float]:
    """The MoE forward's logits shape and its load-balance loss."""
    logits, aux = forward(params, cfg, {"tokens": tokens % cfg.vocab_size})
    return tuple(logits.shape), float(aux["aux_loss"])


def int8_linear(w: torch.Tensor, x: torch.Tensor) -> float:
    """The relative error of the calibrated INT8 linear layer against
    ``x @ w`` (Frobenius norms)."""
    ql = calibrate_linear(w, x)
    ref = x @ w
    return float(torch.linalg.norm(quantized_matmul(x, ql) - ref)
                 / torch.linalg.norm(ref))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)

    cfg = smoke_variant(get_config("qwen3-8b"))
    params = init_params(cfg, seed=0, device=dev)
    n_par = sum(p.numel() for p in params.parameters())
    print(f"{cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"params={n_par / 1e6:.1f}M")
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=dev,
                           generator=gen)
    shape, greedy = greedy_continuation(params, cfg, tokens)
    print("forward:", shape)
    print("greedy continuation:", greedy)

    moe_cfg = smoke_variant(get_config("olmoe-1b-7b"))
    moe_params = init_params(moe_cfg, seed=2, device=dev)
    moe_shape, aux = moe_forward(moe_params, moe_cfg, tokens)
    print(f"MoE forward: {moe_shape}, aux loss {aux:.3f}")

    w = torch.randn((64, 32), device=dev, generator=gen) * 0.1
    x = torch.randn((16, 64), device=dev, generator=gen)
    err = int8_linear(w, x)
    print(f"INT8 linear rel-error: {err:.4f}")
    print("quickstart OK")
    return {"forward_shape": list(shape), "greedy": greedy,
            "moe_aux_loss": aux, "int8_rel_err": err}


if __name__ == "__main__":
    main()
