"""AdamW with a cosine schedule and linear warmup, as the JAX package's
``train/optimizer.py``: global-norm clip (the norm reported before the
clip), moments in float32, bias correction, decoupled weight decay on
matrices only, and the update cast back to each parameter's dtype.

``params`` is a :class:`~repro_torch.models.model.Model` or a tree (nested
dicts, lists, tuples) of tensors. The JAX package decides "matrix" by the
leaf's rank in its ``init_params`` tree, where each segment's layers are
stacked on a leading axis: so for a ``Model`` a parameter under
``segments`` or ``shared_attn`` counts one axis more than it has (a
layer's norm gain decays, ``final_norm`` does not), as in JAX.

Where JAX returns new arrays, :func:`adamw_update` writes the parameters
and the moments in place (under ``no_grad``) and returns them: a full-width
model's moments are gigabytes, and a second copy would double them.

Over DTensors (a step traced or run over a mesh) the gradients come placed
as their parameters and the moments are placed so too (JAX's ``o_spec``):
each rank updates its own blocks with no collective, and the global norm is
each rank's sum of squares of its blocks, all-reduced as one scalar
(:func:`repro_torch.dtensor.global_norm`), as XLA partitions JAX's update.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, NamedTuple, Tuple

import torch
from torch import nn

from repro_torch import dtensor as dt
from repro_torch.device import DeviceLike, check_on, resolve_device
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: Any              # float32, one per parameter leaf
    nu: Any


def lr_at(cfg: OptConfig, step: Any) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an int tensor): linear
    warmup to ``cfg.lr``, then a cosine down to ``min_lr_frac`` of it.
    float32, on ``step``'s device."""
    step = torch.as_tensor(step)
    s = step.float()
    warm = cfg.lr * (s + 1) / cfg.warmup_steps
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0, 1)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos).float()


def _leaves(params: Any) -> List[Tuple[torch.Tensor, int]]:
    """(tensor, its rank in the JAX ``init_params`` layout) per leaf."""
    if isinstance(params, nn.Module):
        return [(p, p.ndim + name.startswith(("segments.", "shared_attn.")))
                for name, p in params.named_parameters()]
    return [(p, p.ndim) for p in tree_leaves(params)]


def _tree(params: Any) -> Any:
    return list(params.parameters()) if isinstance(params, nn.Module) \
        else params


def init_opt_state(params: Any, device: DeviceLike = None) -> OptState:
    """Zero float32 moments shaped as ``params`` (for a ``Model``, a list
    in ``parameters()`` order) on ``device``: CUDA unless the caller names
    another; raises when CUDA is absent or a parameter lives elsewhere."""
    dev = resolve_device(device)
    for p, _ in _leaves(params):
        check_on(dev, p, "a parameter")
    mu, nu = (tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                             device=dev), _tree(params))
              for _ in range(2))
    return OptState(torch.zeros((), dtype=torch.int32, device=dev), mu, nu)


def _global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if dt.is_dtensor(leaves[0]):
        return dt.global_norm(leaves)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def adamw_update(cfg: OptConfig, params: Any, grads: Any, state: OptState
                 ) -> Tuple[Any, OptState, dict]:
    """One AdamW step. ``grads`` matches ``params`` leaf for leaf (for a
    ``Model``, a list in ``parameters()`` order). Writes the parameters and
    moments in place and returns (params, the new state, {"grad_norm": the
    norm before the clip, "lr"})."""
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, state.step)
    bc1 = 1 - torch.pow(cfg.b1, step.float())
    bc2 = 1 - torch.pow(cfg.b2, step.float())
    # A replicated DTensor step's scalars meet each rank's blocks as its own.
    lr_, bc1, bc2 = (t.to_local() if dt.is_dtensor(t) else t
                     for t in (lr, bc1, bc2))
    with torch.no_grad():
        for (p, rank), g, m, v in zip(_leaves(params), tree_leaves(grads),
                                      tree_leaves(state.mu),
                                      tree_leaves(state.nu)):
            if dt.is_dtensor(p):        # this rank's blocks, placed alike
                p, g, m, v = (t.to_local() for t in (p, g, m, v))
            g = g.float() * scale
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if rank >= 2:                 # decoupled decay, matrices only
                u = u + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr_ * u).to(p.dtype))
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm,
                                                         "lr": lr}
