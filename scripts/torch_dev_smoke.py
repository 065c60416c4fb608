#!/usr/bin/env python3
"""Development smoke of the PyTorch port: every config's smoke variant
through ``forward`` and ``lm_loss``, and, for the decoders, a prefill whose
logits must equal the forward's (2e-3, as ``scripts/dev_smoke.py`` holds
JAX's) and one decode step -- the port's counterpart of ``make smoke``. On
the card the Mamba2 and Zamba2 prefills run the ``ssd_scan`` kernel.

    PYTHONPATH=src python3 scripts/torch_dev_smoke.py [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import (get_config, list_configs,  # noqa: E402
                                 smoke_variant)
from repro_torch.device import add_device_arg, resolve_device  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_params, lm_loss, prefill)

#: rows and positions of the smoke batch; its seed; the weights' seed
B, S, SEED, PARAM_SEED = 2, 16, 0, 42
#: prefill logits against the forward's (absolute and relative)
AGREE_TOL = 2e-3


def batch_for(cfg, b: int = B, s: int = S, seed: int = SEED,
              device=None) -> Dict[str, torch.Tensor]:
    """A batch of ``s`` positions: audio frames, or tokens (a VLM's after
    its prefix embeddings), and labels, drawn from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch, n_tok = {}, s
    if cfg.frontend == "audio_frames":
        batch["frames"] = torch.randn((b, s, cfg.d_model), device=dev,
                                      generator=gen)
    else:
        if cfg.frontend == "vision_patches":
            p = cfg.num_prefix_embeddings
            batch["prefix_emb"] = torch.randn((b, p, cfg.d_model),
                                              device=dev, generator=gen)
            n_tok = s - p
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (b, n_tok),
                                        device=dev, generator=gen)
    batch["labels"] = torch.randint(0, cfg.vocab_size, (b, n_tok),
                                    device=dev, generator=gen)
    return batch


def smoke_one(params, cfg, batch: Dict[str, torch.Tensor]) -> Dict:
    """``forward`` and ``lm_loss`` of one config; for a decoder, a prefill
    (float32 caches, 8 spare slots) held to the forward's logits and one
    decode step of its argmax. Raises on NaN logits or a prefill that
    parts from the forward."""
    name = cfg.name
    with torch.no_grad():
        logits, _ = forward(params, cfg, batch)
        if torch.isnan(logits).any():
            raise AssertionError(f"{name}: NaN logits")
        loss, _ = lm_loss(params, cfg, batch)
        row = {"name": name, "forward": list(logits.shape),
               "loss": float(loss)}
        if cfg.supports_decode:
            s = logits.shape[1]
            pl_logits, caches = prefill(params, cfg, batch, capacity=s + 8,
                                        cache_dtype=torch.float32)
            tok = torch.argmax(pl_logits[:, -1, :], -1)[:, None].to(
                torch.int32)
            dl, _ = decode_step(params, cfg, tok, caches,
                                torch.tensor(s, dtype=torch.int32,
                                             device=tok.device))
            if torch.isnan(dl).any():
                raise AssertionError(f"{name}: NaN decode")
            torch.testing.assert_close(pl_logits, logits, rtol=AGREE_TOL,
                                       atol=AGREE_TOL)
            row["decode"] = list(dl.shape)
            row["prefill_err"] = float((pl_logits - logits).abs().max())
    return row


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    for name in list_configs():
        cfg = smoke_variant(get_config(name))
        params = init_params(cfg, seed=PARAM_SEED, device=dev)
        n_par = sum(p.numel() for p in params.parameters())
        row = smoke_one(params, cfg, batch_for(cfg, device=dev))
        row["params_m"] = n_par / 1e6
        msg = (f"{name:22s} params={n_par / 1e6:6.2f}M "
               f"fwd={tuple(row['forward'])} loss={row['loss']:.3f}")
        if "decode" in row:
            msg += f" decode={tuple(row['decode'])}"
        print(msg, flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
