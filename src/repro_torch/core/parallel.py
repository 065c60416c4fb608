"""The current device mesh, its axes, and the collectives of the port's
parallel paths (LEP in 1-D and 2-D, the hybrid MLA prefill).

The port of the JAX package's ``core/parallel.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions
(``("data", "model")``, with ``"pod"`` in front for a multi-pod layout).
Where only the shape matters (:func:`pick_lep_plan
<repro_torch.core.lep.pick_lep_plan>`, the sharding specs) a mapping of
axis name to size stands in for it, so that the production shapes can be
planned without their ranks.

The port runs activations replicated on every rank and shards only inside
its parallel paths, so every collective there is explicit. The ones below
carry the gradient rules that this layout needs, so a training step through
LEP gets the gradient of the one global loss, as JAX's ``shard_map``
transposes give it:

* ``all_to_all``, ``all_gather`` and ``reduce_scatter`` move sharded data;
  each one's backward is its transpose (an ``all_to_all``, a reduce-scatter,
  an all-gather).
* ``split_replicated`` takes this rank's rows of a replicated tensor; its
  backward gathers every rank's rows of the gradient.
* ``gather_replicated`` and ``sum_replicated`` make a replicated result from
  sharded parts; every rank then holds the same upstream gradient, so the
  backward passes each rank its own part of it.
* ``grad_sum`` marks a replicated weight that each rank uses on its own
  share of the work: the identity forward, an all-reduce of the gradient.
* ``max_replicated`` is the elementwise max over the ranks (an all-reduce)
  of a softmax's running statistics; it carries no gradient, as the max a
  softmax subtracts is a constant of its derivative.
* ``send_recv`` moves blocks point to point (a collective permute: LEP's
  expert redundancy); it carries no gradient.

Each collective on a group of one rank is skipped (``group`` is then None):
an axis of one rank moves and copies nothing.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Dict, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist

_MESH = None
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Any] = {}
#: batches that :func:`send_recv` has begun in this process: a counter of
#: collectives tells one permute from the next by it
p2p_batches = 0


def set_current_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_current_mesh():
    return _MESH


@contextmanager
def mesh_context(mesh):
    """``mesh`` is the current mesh inside the block."""
    prev = get_current_mesh()
    set_current_mesh(mesh)
    try:
        yield mesh
    finally:
        set_current_mesh(prev)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order, of a ``DeviceMesh`` or of a
    mapping of axis sizes."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(mesh=None) -> Tuple[str, ...]:
    """Axes the global batch is sharded over (pod joins data when present)."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None:
        return ()
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def all_axes(mesh=None) -> Tuple[str, ...]:
    mesh = mesh if mesh is not None else _MESH
    return tuple(mesh_shape(mesh)) if mesh is not None else ()


def axis_size(mesh, axes: Sequence[str]) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes)


def constrain(x, *spec):
    """The identity. JAX's counterpart is a sharding hint to XLA; eager
    PyTorch has none, and the port's collectives are explicit."""
    return x


def axis_index(mesh, axes: Sequence[str]) -> int:
    """This rank's coordinate over ``axes`` flattened in the mesh's order
    (the first axis major), as ``jax.lax.axis_index`` counts a tuple."""
    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx = 0
    for a in axes:
        idx = idx * shape[a] + coord[a]
    return idx


def axes_group(mesh, axes: Sequence[str]):
    """The process group of this rank's ranks along ``axes`` (their other
    coordinates equal), its ranks in the mesh's order; None when the axes
    hold one rank. Called collectively: a group over several axes is made
    on first use, by every rank."""
    axes = tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    if axis_size(mesh, axes) == 1:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"axes {axes} must follow the mesh's order "
                             f"{names}")
        rest = [i for i in range(len(names)) if i not in dims]
        n = axis_size(mesh, axes)
        lists = mesh.mesh.permute(*rest, *dims).reshape(-1, n).tolist()
        if any(ranks != sorted(ranks) for ranks in lists):
            raise ValueError("the mesh's ranks must grow along its axes "
                             "(make_debug_mesh lays them out so)")
        if lists == [list(range(dist.get_world_size()))]:
            group = dist.group.WORLD
        else:
            group, _ = dist.new_subgroups_by_enumeration(lists)
        _GROUPS[key] = group
    return _GROUPS[key]


# ---------------------------------------------------------------------------
# Collectives on dim 0, with the gradient rules above
# ---------------------------------------------------------------------------


def _a2a(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _gather0(x, group):
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _scatter0(x, group):
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def _chunk0(x, group):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    rows = x.shape[0] // n
    return x[r * rows:(r + 1) * rows]


def _sum(x, group):
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


class _Collective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, fwd, bwd):
        ctx.group, ctx.bwd = group, bwd
        return fwd(x, group)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g, ctx.group), None, None, None


def _identity(x, group):
    return x.view_as(x)


_RULES = {"all_to_all": (_a2a, _a2a), "all_gather": (_gather0, _scatter0),
          "reduce_scatter": (_scatter0, _gather0),
          "split_replicated": (_chunk0, _gather0),
          "gather_replicated": (_gather0, _chunk0),
          "sum_replicated": (_sum, _identity),
          "grad_sum": (_identity, _sum)}


def _apply(kind, x, group, dim=0):
    if group is None:
        return x
    fwd, bwd = _RULES[kind]
    if dim == 0:
        return _Collective.apply(x, group, fwd, bwd)
    return _Collective.apply(x.movedim(dim, 0), group, fwd, bwd).movedim(
        0, dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of dim 0 goes to rank i; chunk i of the result came from
    rank i (``jax.lax.all_to_all(x, axes, 0, 0)``)."""
    return _apply("all_to_all", x, group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order
    (``jax.lax.all_gather(..., axis=dim, tiled=True)``)."""
    return _apply("all_gather", x, group, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over ranks, cut along ``dim``; rank i keeps piece i
    (``jax.lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``)."""
    return _apply("reduce_scatter", x, group, dim)


def split_replicated(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return _apply("split_replicated", x, group, dim)


def gather_replicated(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return _apply("gather_replicated", x, group, dim)


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return _apply("sum_replicated", x, group)


def grad_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _apply("grad_sum", x, group)


def max_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``group`` (``x``
    itself for a group of one), detached from the graph."""
    x = x.detach()
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def send_recv(sends: Sequence[Tuple[torch.Tensor, int]],
              recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """Point to point, as one batch: each ``(tensor, peer)`` of ``sends``
    goes to the global rank ``peer``, each ``(buffer, peer)`` of ``recvs``
    is filled from ``peer``, in place; returns when all are done. Peers
    must list each other's transfers in the same order. A batch
    (``dist.batch_isend_irecv``) keeps two ranks that send to each other
    from waiting on each other; on meta tensors (a step traced on a fake
    group, which has no backend for them) the ops go one by one."""
    global p2p_batches
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, buf, peer) for buf, peer in recvs]
    if not ops:
        return
    p2p_batches += 1
    if ops[0].tensor.is_meta:
        works = [op.op(op.tensor, op.peer) for op in ops]
    else:
        works = dist.batch_isend_irecv(ops)
    for work in works:
        if work is not None:
            work.wait()
