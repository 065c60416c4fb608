"""End-to-end training on the PyTorch port: a 110M-parameter OLMoE-style
MoE (8 experts, top-2) trained on the seeded synthetic packed corpus with
AdamW, then checkpointed in the JAX package's file layout --
``examples/train_moe_100m.py`` on the port's entry points, at the same
sizes (300 steps of 8 x 128 tokens by default).

    PYTHONPATH=src python examples/torch_train_moe_100m.py [--steps 300] \\
        [--ckpt DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import make_batch_iter
from repro_torch.device import add_device_arg, resolve_device
from repro_torch.models import init_params
from repro_torch.train import OptConfig, train

#: tokens a row and rows a step; the learning rate and its warmup
SEQ, BATCH, LR, WARMUP = 128, 8, 6e-4, 30


#: the fields of OLMoE-1B-7B's config that the example replaces
MOE_100M = dict(name="olmoe-100m", num_layers=4, d_model=256, num_heads=4,
                num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=50304,
                num_experts=8, num_experts_per_tok=2, dtype="float32")


def moe_100m_config():
    """The ~100M-parameter MoE of the OLMoE family that the example
    trains."""
    return dataclasses.replace(get_config("olmoe-1b-7b"), **MOE_100M)


def train_moe(params, cfg, steps: int, seed: int = 0, log_every: int = 20,
              device=None) -> Tuple[object, List[Dict]]:
    """``steps`` AdamW steps (warmup then cosine over ``steps``) on the
    synthetic corpus of ``seed``; (params trained in place, history)."""
    batches = make_batch_iter(cfg.vocab_size, seq_len=SEQ,
                              global_batch=BATCH, seed=seed)
    opt = OptConfig(lr=LR, warmup_steps=WARMUP, total_steps=steps)
    return train(params, cfg, batches, steps, opt, log_every=log_every,
                 device=device)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_moe_100m"))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = moe_100m_config()
    print(f"{cfg.name}: total={cfg.param_count() / 1e6:.1f}M "
          f"active={cfg.param_count(True) / 1e6:.1f}M")
    params = init_params(cfg, seed=0, device=dev)
    params, hist = train_moe(params, cfg, args.steps, device=dev)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    if not last < first:
        raise AssertionError(f"the loss did not fall: {first} -> {last}")
    save_checkpoint(args.ckpt, params, args.steps, meta={"arch": cfg.name},
                    device=dev)
    print(f"final loss {last:.3f} (from {first:.3f}); checkpoint at "
          f"{args.ckpt}")
    return {"steps": args.steps, "first_loss": first, "final_loss": last,
            "params_m": cfg.param_count() / 1e6, "ckpt": args.ckpt}


if __name__ == "__main__":
    main()
