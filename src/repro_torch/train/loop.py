"""Training loop, as the JAX package's ``train/loop.py``: a train step
(loss, gradients, AdamW) with optional rematerialization and
microbatching, and the ``train`` loop with JAX's history records and
printed line.

The model's weights are frozen parameters (``requires_grad=False``), so
serving never builds an autograd graph. A train step turns gradients on
for the step alone (:func:`trainable`) and off again, so a model that was
trained serves as before. PyTorch runs eagerly: there is no ``jit``, and
``remat`` is ``torch.utils.checkpoint``.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Iterator, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import dtensor as dt
from repro_torch.configs.base import ModelConfig
from repro_torch.core.microbatch import microbatched_loss
from repro_torch.device import DeviceLike, check_on, resolve_device
from repro_torch.models import model as model_mod
from repro_torch.train.optimizer import (OptConfig, OptState, adamw_update,
                                         init_opt_state)


@contextlib.contextmanager
def trainable(model: nn.Module) -> Iterator[List[nn.Parameter]]:
    """Turn on ``requires_grad`` for every parameter of ``model`` inside the
    block (yielding them in ``parameters()`` order) and freeze them again on
    the way out."""
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    try:
        yield params
    finally:
        for p in params:
            p.requires_grad_(False)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, moe_fn=None,
                    remat: bool = False, n_micro: int = 1) -> Callable:
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: ``lm_loss`` (mean over ``n_micro`` batch splits), its
    gradients for every parameter (zero for one the loss does not reach),
    and one :func:`adamw_update` in place. ``metrics`` holds ``loss``,
    ``nll``, ``aux_loss``, ``grad_norm`` and ``lr`` as tensors."""
    def loss_fn(params, batch):
        return model_mod.lm_loss(params, cfg, batch, moe_fn)

    if remat:
        loss_fn = functools.partial(checkpoint, loss_fn, use_reentrant=False)
    loss_fn = microbatched_loss(loss_fn, n_micro)

    def train_step(params: nn.Module, opt_state: OptState,
                   batch: Dict[str, torch.Tensor]):
        with trainable(params) as leaves:
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # Over DTensors each gradient is placed once as its parameter (a
        # pending sum reduce-scattered onto a shard or all-reduced onto a
        # replica), so the update runs on each rank's blocks.
        grads = [torch.zeros_like(p) if g is None else dt.placed_like(g, p)
                 for p, g in zip(leaves, grads)]
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, params, grads, opt_state)
        return params, opt_state, {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}

    return train_step


def train(params: nn.Module, cfg: ModelConfig, batches: Iterator[Dict],
          steps: int, opt_cfg: Optional[OptConfig] = None, moe_fn=None,
          log_every: int = 10, jit: bool = True, n_micro: int = 1,
          device: DeviceLike = None):
    """Train ``params`` (a ``Model``, updated in place) for ``steps`` steps
    on numpy batches from ``batches``; returns (params, history), a record
    of every metric at every ``log_every``-th step and the last, and prints
    JAX's line for each. Runs on ``device``: CUDA unless the caller names
    another; raises when CUDA is absent or the weights live elsewhere.
    ``jit`` is kept for the JAX package's signature: PyTorch runs eagerly,
    so it changes nothing."""
    dev = resolve_device(device)
    for p in params.parameters():
        check_on(dev, p, "a parameter")
    opt_cfg = opt_cfg or OptConfig(total_steps=steps,
                                   warmup_steps=max(1, steps // 10))
    step_fn = make_train_step(cfg, opt_cfg, moe_fn, n_micro=n_micro)
    opt_state = init_opt_state(params, dev)
    history = []
    for i in range(steps):
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in next(batches).items()}
        params, opt_state, m = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            rec = {k: float(v) for k, v in m.items()}
            rec["step"] = i
            history.append(rec)
            print(f"step {i:5d} loss={rec['loss']:.4f} "
                  f"nll={rec.get('nll', 0):.4f} "
                  f"lr={rec['lr']:.2e} gnorm={rec['grad_norm']:.2f}",
                  flush=True)
    return params, history
