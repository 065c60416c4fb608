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


def shard_axes(x, dim: int) -> Tuple[str, ...]:
    """The mesh axes over which the DTensor ``x`` shards dimension
    ``dim``, in the mesh's order."""
    from torch.distributed.tensor import Shard

    dim = dim % x.ndim
    return tuple(a for a, p in zip(x.device_mesh.mesh_dim_names, x.placements)
                 if isinstance(p, Shard) and p.dim == dim)


def head_axes(mesh, n: int) -> Tuple[str, ...]:
    """The axes ``n`` heads shard over: ``model`` when they divide over
    it, as the specs shard the head projections' columns, else none."""
    names = tuple(mesh.mesh_dim_names)
    if "model" in names and n % mesh.size(names.index("model")) == 0:
        return ("model",)
    return ()


def blockwise(fn, mesh, args: Sequence, dims: Sequence, out_dims: Sequence,
              batch: Sequence[str], parts: Sequence[str]):
    """``fn`` on this rank's blocks of ``args``, entered through
    ``local_map`` as a ``shard_map`` body: ``dims[i]`` is (batch dimension,
    part dimension) of ``args[i]``, either None; each argument is placed
    with its batch dimension sharded over the axes ``batch`` and its part
    dimension (a mixer's heads or channels) over the axes ``parts`` (an
    axis in both is a part axis),
    replicated over the rest (a plain tensor is taken as replicated).
    ``fn`` issues its collectives itself. An argument that is whole over
    some of those axes, while others are cut over them, is used by each
    rank for its own share of the work: its gradient is summed over them
    (``core/parallel.grad_sum``). The outputs are DTensors placed by
    ``out_dims`` likewise."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core import parallel as par

    names = tuple(mesh.mesh_dim_names)
    batch = tuple(a for a in batch if a not in parts)

    def placed(bd, pd):
        return tuple(Shard(bd) if a in batch and bd is not None else
                     Shard(pd) if a in parts and pd is not None else
                     Replicate() for a in names)

    def whole_over(bd, pd):
        return tuple(a for a in names
                     if (a in batch and bd is None)
                     or (a in parts and pd is None))

    groups = [par.axes_group(mesh, whole_over(*d)) for d in dims]

    def body(*blocks):
        got = fn(*(_prepared(x, g) for x, g in zip(blocks, groups)))
        return got if isinstance(got, tuple) else (got,)

    args = [DTensor.from_local(a, mesh, replicated(mesh), run_check=False)
            if not is_dtensor(a) else a for a in args]
    got = local_map(
        body, out_placements=tuple(placed(*d) for d in out_dims),
        in_placements=tuple(placed(*d) for d in dims),
        redistribute_inputs=True, device_mesh=mesh)(*args)
    return got if len(out_dims) > 1 else got[0]


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    block's gradient leaves ``local_map`` as a DTensor's local tensor,
    which the DTensor ops before it view as it is laid out."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _prepared(x, group):
    """A block for :func:`blockwise`'s ``fn``: with a gradient, one that
    leaves contiguous and, where the block is whole over axes that cut
    others, summed over them (``group``)."""
    from repro_torch.core import parallel as par

    if not (isinstance(x, torch.Tensor) and x.requires_grad):
        return x
    return par.grad_sum(_ContiguousGrad.apply(x), group)


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
