"""Load the JAX package's weights into the port's modules.

The JAX ``init_params`` pytree (``repro/models/model.py:113``) stacks each
segment's layer weights on a leading axis. :func:`params_from_jax_numpy`
takes that tree with numpy arrays at the leaves and unstacks it into one
module per layer, so both sides of a test run the same weights.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model, build_plan


def _load(param: torch.nn.Parameter, value: np.ndarray, what: str) -> None:
    value = np.asarray(value)
    if tuple(param.shape) != value.shape:
        raise ValueError(f"{what}: port shape {tuple(param.shape)} != JAX "
                         f"shape {value.shape}")
    param.data.copy_(torch.from_numpy(np.array(value)))


def _load_module(module: torch.nn.Module, tree: Dict[str, Any], layer: int,
                 what: str) -> None:
    names = dict(module.named_parameters(recurse=False))
    if set(names) != set(tree):
        raise ValueError(f"{what}: port weights {sorted(names)} != JAX "
                         f"weights {sorted(tree)}")
    for name, param in names.items():
        _load(param, tree[name][layer], f"{what}.{name}")


def params_from_jax_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                          device: DeviceLike = None) -> Model:
    """A :class:`Model` on ``device`` holding the weights of the JAX pytree
    ``tree`` (numpy leaves, e.g. ``jax.tree.map(np.asarray, params)``)."""
    model = Model(cfg, resolve_device(device))
    _load(model.embed, tree["embed"], "embed")
    _load(model.final_norm, tree["final_norm"], "final_norm")
    if not cfg.tie_embeddings:
        _load(model.lm_head, tree["lm_head"], "lm_head")
    for seg in build_plan(cfg):
        seg_tree = tree["segments"][seg.name]
        for li, blk in enumerate(model.segments[seg.name]):
            what = f"segments.{seg.name}[{li}]"
            _load_module(blk.attn, seg_tree["attn"], li, what + ".attn")
            ffn = "moe" if blk.kind == "moe" else "mlp"
            _load_module(getattr(blk, ffn), seg_tree[ffn], li,
                         f"{what}.{ffn}")
    return model
