"""Microbatch-based pipelining (paper §4.2.3 decode, §4.3.2 prefill).

The paper splits each batch into two interleaved microbatches so one
stream's attention overlaps the other's MoE dispatch/combine. The port keeps
the JAX package's *structure*: the batch is split along the same axes and
the microbatch steps run one after the other on the current stream (putting
them on two CUDA streams is later work). Leaves are split as views, so a
step that writes its caches in place writes into the full batch; where
every microbatch step hands back the very view it was given, the joined
result is the full leaf itself, not a concatenated copy (a full-width
Mamba2 state is hundreds of MB).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import tree_map


def _batch_axis(leaf: torch.Tensor) -> int:
    """Caches carry a leading layer axis, so batch is axis 1 for rank>=3
    leaves and axis 0 for rank<=2 leaves (tokens, lengths)."""
    return 0 if leaf.ndim <= 2 else 1


def _split_batch(tree: Any, n: int, i: int) -> Any:
    """Microbatch i of n along the batch axis of every batched leaf;
    scalars and leaves whose batch does not divide by n pass through."""
    def f(leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0:
            return leaf
        axis = _batch_axis(leaf)
        b = leaf.shape[axis]
        if b % n:
            return leaf
        step = b // n
        return leaf.narrow(axis, i * step, step)
    return tree_map(f, tree)


def _cat(*leaves):
    l0 = leaves[0]
    if not isinstance(l0, torch.Tensor) or l0.ndim == 0:
        return l0
    return torch.cat(leaves, dim=_batch_axis(l0))


def _concat_batch(trees):
    return tree_map(_cat, *trees)


def _join_batch(full, given, returned):
    """``returned`` microbatch trees joined along the batch: a leaf that
    every step returned as the very view of ``full`` it was given (written
    in place) is ``full``'s leaf; any other is concatenated."""
    n = len(given)

    def f(leaf, *pairs):
        if isinstance(leaf, torch.Tensor) and leaf.ndim and all(
                r is g for g, r in zip(pairs[:n], pairs[n:])):
            return leaf
        return _cat(*pairs[n:])
    return tree_map(f, full, *given, *returned)


def microbatched(step_fn: Callable, n_micro: int = 2):
    """Wrap a (tokens, caches, ...) -> (out, caches) step into n microbatch
    steps over disjoint slices of the batch."""
    if n_micro == 1:
        return step_fn

    def wrapped(tokens, caches, *args, **kwargs):
        outs, given, new_caches = [], [], []
        for i in range(n_micro):
            t_i = _split_batch(tokens, n_micro, i)
            c_i = _split_batch(caches, n_micro, i)
            o_i, nc_i = step_fn(t_i, c_i, *args, **kwargs)
            outs.append(o_i)
            given.append(c_i)
            new_caches.append(nc_i)
        return _concat_batch(outs), _join_batch(caches, given, new_caches)

    return wrapped


def microbatched_loss(loss_fn: Callable, n_micro: int = 2):
    """The training analogue, as the JAX package's: ``loss_fn(params,
    batch)`` run on ``n_micro`` splits of the batch (axis 0 of rank <= 2
    leaves, axis 1 of higher ranks, as :func:`_split_batch` cuts them), the
    loss and every metric averaged over the splits. Autograd differentiates
    the mean, as ``jax.value_and_grad`` does."""
    if n_micro == 1:
        return loss_fn

    def wrapped(params, batch, *args, **kwargs):
        total, metrics = None, None
        for i in range(n_micro):
            l_i, m_i = loss_fn(params, _split_batch(batch, n_micro, i),
                               *args, **kwargs)
            total = l_i if total is None else total + l_i
            metrics = m_i if metrics is None else tree_map(
                lambda x, y: x + y, metrics, m_i)
        inv = 1.0 / n_micro
        return total * inv, tree_map(lambda x: x * inv, metrics)

    return wrapped
