"""Helpers for a step traced over DTensors.

The dry run (``launch/dryrun.py``) traces rank 0's step with every weight,
cache and input a DTensor placed by ``launch/sharding.py``'s specs. Where
XLA's partitioning of JAX's step decides a collective -- the projections
(:func:`linear`), the mixers (:func:`blockwise`), the vocabulary's
reductions, the embedding, the global norm -- these helpers run the op on
each rank's blocks through ``local_map`` and issue that collective
themselves (``core/parallel.py``), as a ``shard_map`` body works on its
block; elementwise ops between blocks placed alike are left to DTensor,
and move nothing. A cache written in place and LEP and the hybrid MLA
prefill work on this rank's shard likewise. On plain tensors nothing here
runs, and ``torch.distributed.tensor`` (a second to import) is not
imported.
"""
from __future__ import annotations

import sys
from typing import TYPE_CHECKING, Optional, Sequence, Tuple

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


def whole_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its last dimension whole on every rank (an all-gather
    where it is cut), its other placements kept; a plain tensor as it
    is."""
    if not is_dtensor(x):
        return x
    x = reduce_partial(x)
    return x.redistribute(x.device_mesh,
                          without_shard(x.placements, x.ndim - 1))


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every pending sum over a mesh dimension done (an
    all-reduce), its other placements kept; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    placements = tuple(Replicate() if p.is_partial() else p
                       for p in x.placements)
    return x.redistribute(x.device_mesh, placements)


def placed_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` placed as ``ref`` (one redistribution: a pending sum is
    reduce-scattered onto a shard, all-reduced onto a replica); anything
    but two DTensors as it is."""
    if not (is_dtensor(x) and is_dtensor(ref)) \
            or tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, tuple(ref.placements))


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The square root of the sum of squares of every element of the
    DTensors ``leaves`` (over one mesh), a plain scalar, the same on every
    rank: each rank sums the squares of its blocks, a block that is
    replicated over some axes only on the ranks at coordinate 0 of them
    (so each element counts once), and one all-reduce over the mesh sums
    the scalars."""
    from repro_torch.core import parallel as par

    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    local = [x.to_local() for x in leaves]
    total = torch.zeros((), dtype=torch.float32, device=local[0].device)
    for x, block in zip(leaves, local):
        if all(c == 0 for c, p in zip(coord, x.placements)
               if not p.is_shard()):
            total = total + torch.sum(torch.square(block.float()))
    group = par.axes_group(mesh, tuple(mesh.mesh_dim_names))
    return torch.sqrt(par.sum_replicated(total, group))


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


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, dim=-1)``. On a DTensor cut on its last
    dimension (a vocabulary) each rank reduces its block, and the rows'
    max and sums of exponentials are all-reduced over the cut, as XLA
    partitions the reduction: a value per row moves, never the rows."""
    last = x.ndim - 1
    if not is_dtensor(x) or not any(p.is_shard(last) for p in x.placements):
        return torch.logsumexp(x, dim=-1)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core import parallel as par

    mesh = x.device_mesh
    group = par.axes_group(mesh, shard_axes(x, last))

    def body(block):
        block = _prepared(block, None)
        m = par.max_replicated(block.amax(dim=-1), group)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        total = par.sum_replicated(
            torch.exp(block - m[..., None]).sum(dim=-1), group)
        return (m + torch.log(total),)

    out = tuple(Replicate() if p.is_shard(last) else p for p in x.placements)
    return local_map(body, out_placements=(out,),
                     in_placements=(tuple(x.placements),),
                     redistribute_inputs=True, device_mesh=mesh)(x)[0]


def shard_axes(x, dim: int) -> Tuple[str, ...]:
    """The mesh axes over which the DTensor ``x`` shards dimension
    ``dim``, in the mesh's order."""
    from torch.distributed.tensor import Shard

    dim = dim % x.ndim
    return tuple(a for a, p in zip(x.device_mesh.mesh_dim_names, x.placements)
                 if isinstance(p, Shard) and p.dim == dim)


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


def linear(x: torch.Tensor, w: torch.Tensor,
           parts: Optional[Sequence[int]] = None):
    """``x @ w``, x (..., K) with its rows (dim 0: a batch or token axis)
    and w (K, N); with ``parts`` (column counts summing to N), the tuple of
    the products with each part's columns. For a DTensor weight the product
    runs on each rank's blocks through ``local_map``, with the collectives
    XLA's partitioner gives the same product, decided per mesh axis:

    * an axis that cuts x's rows and w (its FSDP shard, either dim): w is
      all-gathered over it in the forward and its gradient reduce-scattered
      back in the backward (ZeRO-3), so the activations stay cut over
      their rows and never move;
    * an axis that cuts x's rows and not w: w's gradient is summed over it;
    * an axis that cuts w's columns and not x: the output is cut on its
      last dim over it, and x's gradient summed over it;
    * an axis that cuts w's columns and x's last dim: x is all-gathered
      over it first (its gradient reduce-scattered back), then as above;
    * an axis that cuts w's rows (a row-parallel product): x's last dim is
      cut alike where it is not (each rank takes its block), and the
      partial products are summed over it (an all-reduce).

    With ``parts``, each rank computes its block of every part's columns,
    so each part comes out cut on its last dim as a product of its own
    would: from w gathered whole over the axes that cut its columns (its
    gradient reduce-scattered back) where w's rows are fewer than x's (a
    training step's tokens), else from the product's own columns gathered
    over them (a decode step's few rows). x's pending sums are taken
    first. A plain weight, a layout none of these covers, or parts that do
    not divide over the ranks, is ``x @ w`` as DTensor partitions it (and
    sliced)."""
    if not is_dtensor(w):
        y = x @ w
        return y if parts is None else _split_last(y, parts)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core import parallel as par

    mesh = w.device_mesh
    names = tuple(mesh.mesh_dim_names)
    x = reduce_partial(x) if is_dtensor(x) else DTensor.from_local(
        x, mesh, replicated(mesh), run_check=False)
    last = x.ndim - 1
    w_gather, w_sum, x_sum, x_gather, x_split, row_sum, out = \
        [], [], [], [], [], [], []
    for a, xp, wp in zip(names, x.placements, w.placements):
        if xp.is_shard(0) and isinstance(wp, Shard):
            w_gather.append((a, wp.dim))
        elif xp.is_shard(0) and wp.is_replicate():
            w_sum.append(a)
        elif xp.is_replicate() and wp.is_shard(1):
            x_sum.append(a)
        elif xp.is_shard(last) and wp.is_shard(1):
            x_gather.append(a)
        elif xp.is_replicate() and wp.is_shard(0):
            x_split.append(a)
        elif xp.is_shard(last) and wp.is_shard(0):
            row_sum.append(a)
        elif not (xp.is_replicate() and wp.is_replicate()):
            return _split_last(x @ w, parts) if parts else x @ w
        out.append(Shard(0) if xp.is_shard(0) else
                   Shard(last) if wp.is_shard(1) else Replicate())
    n_cols = par.axis_size(mesh, x_sum)
    if parts and (x_gather or x_split or row_sum
                  or any(n % n_cols for n in parts)):
        return _split_last(linear(x, w), parts)
    group = lambda axes: par.axes_group(mesh, axes)  # noqa: E731
    i_cols = par.axis_index(mesh, x_sum)
    rows = x.to_local().numel() // x.shape[-1]
    whole_w = w.shape[0] * w.element_size() <= rows * x.element_size()

    def body(xb, wb):
        xb, wb = _prepared(xb, group(x_sum)), _prepared(wb, group(w_sum))
        for a in reversed(x_gather):         # innermost axis first
            xb = par.all_gather(xb, group((a,)), dim=-1)
        for a in x_split:                    # outermost axis first
            xb = par.split_replicated(xb, group((a,)), dim=-1)
        for a, d in reversed(w_gather):
            wb = par.all_gather(wb, group((a,)), dim=d)
        if parts is None:
            return (par.sum_replicated(xb @ wb, group(row_sum + x_split)),)
        if whole_w:
            wb = par.all_gather(wb, group(x_sum), dim=1)
        else:
            y = par.all_gather(xb @ wb, group(x_sum), dim=-1)
        blocks, lo = [], 0
        for n in parts:
            cut = slice(lo + i_cols * (n // n_cols),
                        lo + (i_cols + 1) * (n // n_cols))
            blocks.append(xb @ wb[:, cut] if whole_w else y[..., cut])
            lo += n
        return tuple(blocks)

    n_out = 1 if parts is None else len(parts)
    got = local_map(body, out_placements=(tuple(out),) * n_out,
                    in_placements=(tuple(x.placements),
                                   tuple(w.placements)),
                    redistribute_inputs=True, device_mesh=mesh)(x, w)
    return got[0] if parts is None else tuple(got)


def _split_last(y: torch.Tensor, parts: Sequence[int]) -> Tuple:
    """``y`` cut into ``parts`` along its last dimension."""
    out, lo = [], 0
    for n in parts:
        out.append(y[..., lo:lo + n])
        lo += n
    return tuple(out)


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
    partitions the gather; never a gather of the whole table. The table's
    gradient is summed over the axes that cut the tokens (each rank saw
    its own)."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    tokens = tokens if is_dtensor(tokens) else DTensor.from_local(
        tokens, weight.device_mesh, replicated(weight.device_mesh),
        run_check=False)
    from repro_torch.core import parallel as par

    v0 = shard_offsets(weight)[0]
    out, token_axes = [], []
    for a, wp, tp in zip(weight.device_mesh.mesh_dim_names,
                         weight.placements, tokens.placements):
        if isinstance(wp, Shard):
            if isinstance(tp, Shard):
                raise ValueError("tokens and the table's rows or columns "
                                 "are sharded over the same mesh axis")
            out.append(Partial() if wp.dim == 0 else Shard(tokens.ndim))
        else:
            out.append(tp)
            if isinstance(tp, Shard):
                token_axes.append(a)
    group = par.axes_group(weight.device_mesh, token_axes)

    def look(tok, block):
        block = _prepared(block, group)
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
