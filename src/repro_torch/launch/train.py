"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --steps 5 [--batch 8 --seq 64] [--lr 3e-4] [--n-micro 2] [--full] \
      [--ckpt DIR] [--device cpu]

The flags, their defaults and the printed lines are the JAX package's
(``repro/launch/train.py``); ``--device`` (default ``cuda``) is the one
addition. The model is the arch's smoke variant unless ``--full``, with
random weights from seed 0; batches come from the seeded synthetic corpus.
``--ckpt`` writes a checkpoint that the JAX package's ``load_checkpoint``
reads (a float32 model; see ``repro_torch/checkpoint/ckpt.py``).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import make_batch_iter
from repro_torch.device import add_device_arg, resolve_device
from repro_torch.models import init_params
from repro_torch.train import OptConfig, train


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="full-size config")
    ap.add_argument("--ckpt", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = smoke_variant(cfg)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.param_count(True)/1e6:.1f}M active)")
    params = init_params(cfg, seed=0, device=dev)
    batches = make_batch_iter(cfg.vocab_size, args.seq, args.batch)
    opt = OptConfig(lr=args.lr, total_steps=args.steps,
                    warmup_steps=max(1, args.steps // 10))
    params, history = train(params, cfg, batches, args.steps, opt,
                            n_micro=args.n_micro, device=dev)
    if args.ckpt:
        save_checkpoint(args.ckpt, params, args.steps,
                        meta={"arch": cfg.name}, device=dev)
        print(f"checkpoint saved to {args.ckpt}")


if __name__ == "__main__":
    main()
