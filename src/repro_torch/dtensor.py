"""Helpers for a step traced over DTensors.

The dry run (``launch/dryrun.py``) traces rank 0's step with every weight,
cache and input a DTensor placed by ``launch/sharding.py``'s specs, so that
DTensor's sharding propagation inserts the collectives that JAX's SPMD
partitioner inserts. Where the model writes into a cache in place, or
enters a parallel path written over explicit collectives (LEP, the hybrid
MLA prefill), it works on this rank's shard through these helpers, as a
``shard_map`` body works on its block. On plain tensors nothing here runs,
and ``torch.distributed.tensor`` (a second to import) is not imported.
"""
from __future__ import annotations

import sys
from typing import TYPE_CHECKING, Sequence, Tuple

import torch

if TYPE_CHECKING:
    from torch.distributed.tensor import DTensor


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (none can exist before DTensor's module
    is imported, so this does not import it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def replicated(mesh) -> Tuple:
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def local(x: torch.Tensor, mesh, placements: Sequence) -> torch.Tensor:
    """This rank's block of ``x`` placed as ``placements`` over ``mesh``
    (``x`` redistributed first when it is placed otherwise); a plain tensor,
    the same on every rank, as it is."""
    if not is_dtensor(x):
        return x
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(mesh, tuple(placements))
    return x.to_local()


def shard_offsets(x: DTensor) -> Tuple[int, ...]:
    """The global index of the first element of this rank's block of
    ``x``, per dimension."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    _, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return tuple(offset)


def without_shard(placements: Sequence, dim: int) -> Tuple:
    """``placements`` with dimension ``dim`` replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in placements)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every pending sum over a mesh dimension done (an
    all-reduce), its other placements kept; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    placements = tuple(Replicate() if p.is_partial() else p
                       for p in x.placements)
    return x.redistribute(x.device_mesh, placements)


def fit_heads(x, n: int, dim: int = -1):
    """``x`` ready to have dimension ``dim`` (of n * d) viewed as (n, d): a
    DTensor sharded on it over ranks that do not divide ``n`` is replicated
    on it first (DTensor cannot cut a head); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard

    dim = dim % x.ndim
    mesh = x.device_mesh
    if any(isinstance(p, Shard) and p.dim == dim and n % mesh.size(m)
           for m, p in enumerate(x.placements)):
        x = x.redistribute(mesh, without_shard(x.placements, dim))
    return x


def take_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, index[..., None])[..., 0]``. On a DTensor
    sharded on its last dimension (a vocabulary) each rank picks the
    indices that fall in its block, 0 elsewhere, and the picks are summed
    over the shards (an all-reduce), as XLA partitions the gather."""
    last = x.ndim - 1
    if not is_dtensor(x) or not any(p.is_shard(last) for p in x.placements):
        return torch.gather(x, -1, index[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    v0 = shard_offsets(x)[last]

    def pick(block, idx):
        rel = idx - v0
        ok = (rel >= 0) & (rel < block.shape[-1])
        got = torch.gather(block, -1, rel.clamp(0, block.shape[-1] - 1)
                           [..., None])[..., 0]
        return (torch.where(ok, got, torch.zeros_like(got)),)

    out = tuple(Partial() if isinstance(p, Shard) and p.dim == last else p
                for p in x.placements)
    return reduce_partial(local_map(
        pick, out_placements=(out,),
        in_placements=(tuple(x.placements),
                       without_shard(x.placements, last)),
        redistribute_inputs=True, device_mesh=x.device_mesh)(x, index)[0])


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``torch.softmax``. On a DTensor that needs a gradient it is taken as
    ``exp(x - max) / sum``, whose backward is elementwise: DTensor works
    out the shape of ``_softmax_backward_data`` by running it on fake
    tensors of the mesh's device, which fails where that device is not
    built in (a CUDA mesh traced on a CPU-only PyTorch)."""
    if not (is_dtensor(x) and x.requires_grad):
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True).detach())
    return e / e.sum(dim=dim, keepdim=True)


def batch_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` with its first dimension placed as ``ref``'s (a query meeting
    a cache sharded over fewer batch axes, as a multi-pod mesh's batch
    over ``("pod", "data")`` meets a cache's over ``"data"``), its other
    placements kept; anything but two DTensors as it is."""
    if not (is_dtensor(x) and is_dtensor(ref)):
        return x
    from torch.distributed.tensor import Replicate, Shard

    def on_batch(p):
        return isinstance(p, Shard) and p.dim == 0

    placements = tuple(
        Shard(0) if on_batch(r) else Replicate() if on_batch(p) else p
        for p, r in zip(x.placements, ref.placements))
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def embedding(tokens: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, weight)`` for a DTensor table: each rank looks
    its tokens up in its block of rows (0 for a token outside it) and the
    lookups are summed over the row shards (an all-reduce), as XLA
    partitions the gather; never a gather of the whole table."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    tokens = tokens if is_dtensor(tokens) else DTensor.from_local(
        tokens, weight.device_mesh, replicated(weight.device_mesh),
        run_check=False)
    v0 = shard_offsets(weight)[0]
    out = []
    for wp, tp in zip(weight.placements, tokens.placements):
        if isinstance(wp, Shard):
            if isinstance(tp, Shard):
                raise ValueError("tokens and the table's rows or columns "
                                 "are sharded over the same mesh axis")
            out.append(Partial() if wp.dim == 0 else Shard(tokens.ndim))
        else:
            out.append(tp)

    def look(tok, block):
        rel = tok.long() - v0
        ok = (rel >= 0) & (rel < block.shape[0])
        rows = torch.nn.functional.embedding(
            rel.clamp(0, block.shape[0] - 1), block)
        return (torch.where(ok[..., None], rows, torch.zeros_like(rows)),)

    return reduce_partial(local_map(
        look, out_placements=(tuple(out),),
        in_placements=(tuple(tokens.placements), tuple(weight.placements)),
        redistribute_inputs=True, device_mesh=weight.device_mesh)(
        tokens, weight)[0])
