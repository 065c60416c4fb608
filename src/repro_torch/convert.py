"""Carry the JAX package's weights and quantized tensors into the port.

The JAX ``init_params`` pytree (``repro/models/model.py:113``) stacks each
segment's layer weights on a leading axis (a hybrid's ``mamba_groups``
too: its scan reshapes that axis to (groups, per_group), so group ``i``,
layer ``j`` is index ``i * per_group + j``, the port's layer order), and a
hybrid's ``shared_attn`` leaves carry a leading axis of 1.
:func:`params_from_jax_numpy` takes that tree with numpy arrays at the
leaves and unstacks it into one module per layer, so both sides of a test
run the same weights;
:func:`param_tree` goes the other way and lays a port model's weights out
as that tree. :func:`mtp_from_jax_numpy` carries the draft head of
``repro/core/mtp.py`` across. :func:`quantized_linear_from_jax_numpy` and
:func:`quantized_tree_from_jax_numpy` carry the outputs of the JAX
package's ``quant/int8.py`` across.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mtp import MTPHead
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import MAMBA_KINDS, Model, build_plan
from repro_torch.models.moe import MoE
from repro_torch.quant.int8 import QuantizedLinear


def _load(param: torch.nn.Parameter, value: Any, what: str) -> None:
    """Copy ``value`` (a numpy array, or a tensor for a dtype numpy lacks,
    such as a checkpoint's bfloat16 leaf) into ``param``, cast to its
    dtype."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value))
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"{what}: port shape {tuple(param.shape)} != JAX "
                         f"shape {tuple(value.shape)}")
    param.data.copy_(value)


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
    ``tree`` (numpy leaves, e.g. ``jax.tree.map(np.asarray, params)``, or
    CPU tensors)."""
    model = Model(cfg, resolve_device(device))
    _load(model.embed, tree["embed"], "embed")
    _load(model.final_norm, tree["final_norm"], "final_norm")
    if not cfg.tie_embeddings:
        _load(model.lm_head, tree["lm_head"], "lm_head")
    for seg in build_plan(cfg):
        seg_tree = tree["segments"][seg.name]
        for li, blk in enumerate(model.segments[seg.name]):
            what = f"segments.{seg.name}[{li}]"
            for part in _parts(seg.kind):
                _load_module(getattr(blk, part), seg_tree[part], li,
                             f"{what}.{part}")
    if cfg.is_hybrid:
        for part in _parts("dense"):
            _load_module(getattr(model.shared_attn, part),
                         tree["shared_attn"][part], 0, f"shared_attn.{part}")
    return model


def _parts(kind: str):
    """The sub-modules of a layer of segment kind ``kind``, under the JAX
    tree's keys."""
    if kind in MAMBA_KINDS:
        return ("mamba",)
    return ("attn", "moe" if kind == "moe" else "mlp")


def mtp_from_jax_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                       device: DeviceLike = None) -> MTPHead:
    """The draft head of the JAX package's ``init_mtp_params`` /
    ``fit_draft_head`` (numpy leaves ``ln``, ``mix``, ``proj``) as an
    :class:`MTPHead` on ``device``."""
    head = MTPHead(cfg, resolve_device(device))
    names = dict(head.named_parameters())
    if set(names) != set(tree):
        raise ValueError(f"mtp: port weights {sorted(names)} != JAX weights "
                         f"{sorted(tree)}")
    for name, param in names.items():
        _load(param, tree[name], f"mtp.{name}")
    return head


def moe_from_jax_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                       layer: int = 0, device: DeviceLike = None) -> MoE:
    """One MoE layer on ``device``, in ``cfg.dtype``, holding layer
    ``layer`` of the JAX package's stacked MoE weights (``init_moe_params``,
    numpy leaves)."""
    moe = MoE(cfg, resolve_device(device), getattr(torch, cfg.dtype))
    _load_module(moe, tree, layer, "moe")
    return moe


def _tensor(value: Any, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(value)).to(device)


def _k_major_tensor(value: Any, device: torch.device) -> torch.Tensor:
    """INT8 codes (..., K, N) on ``device``, stored K-major as the port's
    quantizer stores them (the transpose is taken on the host)."""
    nk = np.ascontiguousarray(np.swapaxes(np.asarray(value), -1, -2))
    return torch.from_numpy(nk).to(device).transpose(-1, -2)


def quantized_linear_from_jax_numpy(ql: Any, device: DeviceLike = None
                                    ) -> QuantizedLinear:
    """The port's :class:`QuantizedLinear` from the JAX package's (its
    fields as numpy arrays or ``None``), ``w_q`` stored K-major."""
    dev = resolve_device(device)
    return QuantizedLinear(
        _k_major_tensor(ql.w_q, dev),
        *(None if v is None else _tensor(v, dev)
          for v in (ql.w_scale, ql.eq, ql.bias_corr)))


def quantized_tree_from_jax_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A tree from the JAX package's ``quantize_param_tree`` (numpy leaves)
    as the same nested dicts of tensors on ``device``, the ``__q__`` codes
    stored K-major as the port's ``quantize_param_tree`` stores them."""
    dev = resolve_device(device)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return _k_major_tensor(node, dev) if key == "__q__" \
            else _tensor(node, dev)

    return walk(tree)


def _stacked(blocks, kind: str) -> Dict[str, Any]:
    """The weights of layers ``blocks`` of segment kind ``kind`` under the
    JAX tree's keys, each stacked on a leading layer axis."""
    out = {}
    for part in _parts(kind):
        params = [dict(getattr(b, part).named_parameters(recurse=False))
                  for b in blocks]
        out[part] = {name: torch.stack([p[name].data for p in params])
                     for name in params[0]}
    return out


def param_tree(model: Model) -> Dict[str, Any]:
    """The weights of ``model`` in the JAX ``init_params`` layout: nested
    dicts under the same keys, each segment's per-layer weights stacked on
    a leading axis, a hybrid's shared block on an axis of 1 (a copy)."""
    cfg = model.cfg
    tree: Dict[str, Any] = {"embed": model.embed.data,
                            "final_norm": model.final_norm.data}
    if not cfg.tie_embeddings:
        tree["lm_head"] = model.lm_head.data
    tree["segments"] = {seg.name: _stacked(model.segments[seg.name], seg.kind)
                        for seg in build_plan(cfg)}
    if cfg.is_hybrid:
        tree["shared_attn"] = _stacked([model.shared_attn], "dense")
    return tree
