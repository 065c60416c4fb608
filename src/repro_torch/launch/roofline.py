"""Roofline terms of a step: the port of the roofline half of the JAX
package's ``launch/hlo_analysis.py``.

The step time is bounded below by three terms: compute (FLOPs over the
peak rate), memory (bytes over the HBM rate) and collectives (bytes over
the links' rate); the largest dominates. The defaults are the data-sheet
rates of an NVIDIA H100 SXM5 80GB HBM3 at its 700 W power limit: 989
TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3, and 450 GB/s a
direction over NVLink 4 (18 links of 25 GB/s). They are arguments, so a
caller can pass another card's rates.

The collective bytes come from the caller, keyed by ``COLLECTIVE_OPS``. The
JAX package parses them out of compiled HLO text (``collective_bytes``);
the port's dry run (``launch/dryrun.py``) counts them as its traced step
issues them (``launch/collectives.py``) and writes its records, these
terms included, to ``experiments/dryrun_torch/``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12        # bf16 dense, H100 SXM5 80GB, 700 W
HBM_BW = 3.35e12           # bytes/s, HBM3, H100 SXM5 80GB, 700 W
LINK_BW = 450e9            # bytes/s a direction, NVLink 4, H100 SXM5

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


@dataclasses.dataclass
class Roofline:
    flops: float               # per-device flops
    hbm_bytes: float           # per-device bytes accessed (unfused bound)
    struct_bytes: float        # args + temps + outputs (fused bound)
    coll_bytes: float          # per-device collective bytes
    compute_s: float
    memory_s: float            # from struct_bytes (primary)
    memory_hlo_s: float        # from bytes accessed (pessimistic)
    collective_s: float
    dominant: str
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def roofline_terms(cost: Dict, coll: Dict[str, int], n_devices: int,
                   model_flops_total: Optional[float] = None,
                   struct_bytes: float = 0.0, links: int = 1, *,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> Roofline:
    """``cost``: a device's ``{"flops", "bytes accessed"}``; ``coll``: its
    collective bytes by kind. compute = FLOPs / peak; collective = bytes /
    (links x link rate); memory from the structural bytes (what a fused
    program streams), and, pessimistic, from the bytes accessed. NVLink's
    rate is already all links' together, so ``links`` is 1 by default
    (JAX's call passes 4 TPU ICI links)."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    cbytes = float(sum(coll[k] for k in COLLECTIVE_OPS))
    compute_s = flops / peak_flops
    memory_s = struct_bytes / hbm_bw
    memory_hlo_s = nbytes / hbm_bw
    coll_s = cbytes / (links * link_bw)
    dom = max(
        (("compute", compute_s), ("memory", memory_s), ("collective", coll_s)),
        key=lambda kv: kv[1])[0]
    mf = model_flops_total / n_devices if model_flops_total else None
    ratio = (mf / flops) if (mf and flops) else None
    return Roofline(flops, nbytes, struct_bytes, cbytes, compute_s, memory_s,
                    memory_hlo_s, coll_s, dom, mf, ratio)


def model_flops(cfg, n_tokens: int, kind: str) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for a forward pass (N = the
    active parameters of a MoE)."""
    n_active = cfg.param_count(active_only=True)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * n_tokens
