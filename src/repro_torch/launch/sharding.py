"""Sharding rules: the mesh axes of every weight, cache and input leaf per
(config x mesh), the port of the JAX package's ``launch/sharding.py``.

A spec is a tuple with one entry per dimension: None (replicated), an
axis name, or a tuple of axis names, as ``tuple(PartitionSpec(...))``
reads in JAX (a one-name tuple reads as the name). Specs are pure Python
over a mesh's shape (a ``DeviceMesh`` or a mapping of axis sizes), so the
production shapes of ``launch/mesh.py`` can be planned without their
ranks; :func:`to_placements` turns a spec into DTensor placements over a
real mesh, and :func:`meta_dtensor`, :func:`shard_tree` and
:func:`shard_model` make meta DTensors (shapes only, no memory) of a
model's weights, a cache tree and a batch, for the dry run
(``launch/dryrun.py``); :func:`distribute` (and ``shard_tree`` and
``shard_model``, given tensors that hold values) places real values the
same way, for a step run over a real mesh.

Policy:
* the batch over ``("pod", "data")``; tensor parallelism (heads, FFN
  columns) over ``"model"``;
* training adds FSDP: the d_model dimension of the big matrices over
  ``"data"`` (ZeRO-3);
* MoE experts as :func:`repro_torch.core.lep.pick_lep_plan` says: full-mesh
  EP when the experts divide the pod, else model-axis EP with the FFN over
  ``"data"`` when replication would not fit (Kimi K2);
* decode caches: the batch over ``"data"``, the sequence (or the SSM heads)
  over ``"model"``.

Leaves are walked in the JAX tree's layout (``convert.param_tree``; every
segment's layers stacked on a leading axis), so each spec keeps JAX's rank.
A per-layer weight of the port's modules takes the spec without its
leading None (the layer axis, never sharded).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lep import pick_lep_plan
from repro_torch.core.parallel import mesh_shape
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import SSMState
from repro_torch.models.model import build_plan

Spec = Tuple[Any, ...]


def spec(*entries) -> Spec:
    """A spec tuple, with a one-name tuple read as the name (as JAX's
    ``PartitionSpec`` normalizes it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def dp_axes(mesh) -> Tuple[str, ...]:
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _div(n: int, mesh, axes) -> bool:
    if not axes:
        return False
    shape = mesh_shape(mesh)
    axes = axes if isinstance(axes, tuple) else (axes,)
    return n % math.prod(shape[a] for a in axes) == 0


def _maybe(axis, n, mesh):
    """``axis`` only if dimension ``n`` divides over it (else replicate)."""
    return axis if axis and _div(n, mesh, axis) else None


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The weight tree of ``cfg`` in the JAX layout, as meta tensors (no
    memory), for :func:`param_pspecs`."""
    from repro_torch.convert import param_tree
    from repro_torch.models.model import Model

    return param_tree(Model(cfg, torch.device("meta"), None))


def param_pspecs(cfg: ModelConfig, mesh, params_shape: Any,
                 train: bool = False,
                 expert_axes: Optional[Tuple[str, ...]] = None) -> Any:
    """A spec for every leaf of ``params_shape`` (a tree in the JAX layout,
    leaves with ``.shape``: ``param_shapes(cfg)``), in the same nesting.
    The routed experts are cut over ``pick_lep_plan``'s EP axes, or over
    ``expert_axes`` where given (a serving plan with redundancy whose
    slots span more ranks than the experts are cut over, as on the
    production mesh)."""
    fsdp = "data" if train else None
    lep = pick_lep_plan(cfg, mesh) if cfg.is_moe else None
    if lep is not None and expert_axes is not None:
        lep = dict(lep, ep_axes=tuple(expert_axes))

    def attn_spec(name: str, shape) -> Spec:
        d = cfg.d_model
        if name in ("wq", "wk", "wv"):
            return spec(None, _maybe(fsdp, d, mesh),
                        _maybe("model", shape[-1], mesh))
        if name == "wo":
            return spec(None, _maybe("model", shape[1], mesh),
                        _maybe(fsdp, d, mesh))
        if name in ("bq", "bk", "bv"):
            return spec(None, _maybe("model", shape[-1], mesh))
        if name == "wq_a":
            return spec(None, _maybe(fsdp, d, mesh),
                        _maybe("model", shape[-1], mesh))
        if name in ("wq_b", "wk_b", "wv_b"):
            return spec(None, None, _maybe("model", shape[-1], mesh))
        if name == "wkv_a":
            return spec(None, _maybe(fsdp, d, mesh), None)
        return spec()                     # norms, gains

    def moe_spec(name: str, shape) -> Spec:
        ep, ffn = lep["ep_axes"], lep["ffn_shard_axis"]
        if name in ("w_gate", "w_up"):
            return spec(None, ep, None, _maybe(ffn, shape[-1], mesh))
        if name == "w_down":
            return spec(None, ep, _maybe(ffn, shape[2], mesh), None)
        if name in ("shared_gate", "shared_up"):
            return spec(None, _maybe(fsdp, shape[1], mesh),
                        _maybe("model", shape[-1], mesh))
        if name == "shared_down":
            return spec(None, _maybe("model", shape[1], mesh),
                        _maybe(fsdp, shape[-1], mesh))
        return spec()                     # router, ln: replicated

    def mamba_spec(name: str, shape) -> Spec:
        if name == "in_proj":
            return spec(None, _maybe(fsdp, shape[1], mesh),
                        _maybe("model", shape[-1], mesh))
        if name == "out_proj":
            return spec(None, _maybe("model", shape[1], mesh),
                        _maybe(fsdp, shape[-1], mesh))
        return spec()

    def spec_of(names: Sequence[str], shape) -> Spec:
        leaf = names[-1]
        if leaf == "embed":
            return spec(_maybe("model", shape[0], mesh), None)
        if leaf == "lm_head":
            return spec(None, _maybe("model", shape[-1], mesh))
        # The enclosing keys decide, in JAX's order: a segment named "moe"
        # puts its attention under moe_spec too (replicated).
        if "moe" in names:
            return moe_spec(leaf, shape)
        if "mamba" in names:
            return mamba_spec(leaf, shape)
        if "attn" in names:
            return attn_spec(leaf, shape)
        if "mlp" in names:
            if leaf in ("w_gate", "w_up"):
                return spec(None, _maybe(fsdp, shape[1], mesh),
                            _maybe("model", shape[-1], mesh))
            if leaf == "w_down":
                return spec(None, _maybe("model", shape[1], mesh),
                            _maybe(fsdp, shape[-1], mesh))
        return spec()

    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names + (k,)) for k, v in tree.items()}
        return spec_of(names, tuple(tree.shape))

    return walk(params_shape, ())


def cache_pspecs(cfg: ModelConfig, mesh, caches_shape: Any) -> Any:
    """Decode caches (``make_caches``'s tree, leaves with ``.shape``): the
    batch over data, the sequence or wide dimensions over model."""
    specs: Dict[str, Any] = {}
    for seg in build_plan(cfg):
        c = caches_shape[seg.name]
        if seg.kind in ("dense", "moe"):
            if cfg.attention_kind == "mla":
                arr = c["mla"]
                specs[seg.name] = {
                    "mla": spec(None, _maybe("data", arr.shape[1], mesh),
                                _maybe("model", arr.shape[2], mesh), None),
                    "length": spec(),
                }
            else:
                sh = c.k.shape
                kv = spec(None, _maybe("data", sh[1], mesh),
                          _maybe("model", sh[2], mesh), None, None)
                specs[seg.name] = KVCache(kv, kv, spec())
        elif seg.kind == "mamba_tail":
            hsh, csh = c.h.shape, c.conv.shape
            specs[seg.name] = SSMState(
                spec(None, _maybe("data", hsh[1], mesh),
                     _maybe("model", hsh[2], mesh), None, None),
                spec(None, _maybe("data", csh[1], mesh), None,
                     _maybe("model", csh[-1], mesh)),
                spec())
        else:
            hsh = c["ssm"]["h"].shape
            csh = c["ssm"]["conv"].shape
            ksh = c["shared_kv"].k.shape
            kv = spec(None, _maybe("data", ksh[1], mesh),
                      _maybe("model", ksh[2], mesh), None, None)
            specs[seg.name] = {
                "ssm": {
                    "h": spec(None, None, _maybe("data", hsh[2], mesh),
                              _maybe("model", hsh[3], mesh), None, None),
                    "conv": spec(None, None, _maybe("data", csh[2], mesh),
                                 None, _maybe("model", csh[-1], mesh)),
                    "length": spec(),
                },
                "length": spec(),
                "shared_kv": KVCache(kv, kv, spec()),
            }
    return specs


def batch_pspecs(cfg: ModelConfig, mesh,
                 batch_shape: Dict[str, Any]) -> Dict[str, Spec]:
    dp = dp_axes(mesh)
    out = {}
    for k, v in batch_shape.items():
        b = v.shape[0]
        ax = dp if _div(b, mesh, dp) else (
            ("data",) if _div(b, mesh, ("data",)) else None)
        out[k] = spec(ax, *([None] * (len(v.shape) - 1)))
    return out


def to_placements(mesh, entries: Spec) -> Tuple[Any, ...]:
    """DTensor placements over ``mesh`` (a ``DeviceMesh``) for a spec: one
    per mesh dimension, ``Shard(d)`` where tensor dimension d names it,
    else ``Replicate()``. A dimension sharded over several axes lists them
    major first, as DTensor shards it over mesh dimensions in order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    by_axis: Dict[str, int] = {}
    for dim, entry in enumerate(entries):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        if [names.index(a) for a in axes] != sorted(
                names.index(a) for a in axes):
            raise ValueError(f"axes {axes} of dimension {dim} must follow "
                             f"the mesh's order {names}")
        for a in axes:
            if a in by_axis:
                raise ValueError(f"axis {a!r} shards two dimensions")
            by_axis[a] = dim
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                 for a in names)



def meta_dtensor(shape, dtype: torch.dtype, mesh, entries: Spec):
    """A DTensor of global ``shape`` over ``mesh`` (a ``DeviceMesh``) placed
    by the spec ``entries``, its local shard a meta tensor: the global shape
    divided per ``Shard``. An axis of one rank replicates (a shard over it
    is the whole tensor, and some DTensor versions cannot view one).
    Raises when a sharded dimension does not divide (the specs replicate
    such a dimension, so none should)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = tuple(Replicate() if mesh.size(m) == 1 else p for m, p in
                       enumerate(to_placements(mesh, entries)))
    local = list(shape)
    for mdim, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(mdim)
            if local[p.dim] % n:
                raise ValueError(f"dimension {p.dim} of {tuple(shape)} "
                                 f"({local[p.dim]} left) does not divide "
                                 f"over {n} ranks of "
                                 f"{mesh.mesh_dim_names[mdim]!r}")
            local[p.dim] //= n
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                              mesh, placements, run_check=False, shape=shape,
                              stride=stride)


def distribute(t: torch.Tensor, mesh, entries: Spec, local: bool = False):
    """``t`` (the same on every rank) as a DTensor over ``mesh`` placed by
    the spec ``entries``, each rank keeping its block; an axis of one rank
    replicates, as :func:`meta_dtensor` places it. Rank 0's ``t`` is
    scattered, or, with ``local``, each rank cuts its block from its own
    ``t`` and no collective runs (a step's own zeros, made alike on every
    rank)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    placements = tuple(Replicate() if mesh.size(m) == 1 else p for m, p in
                       enumerate(to_placements(mesh, entries)))
    return distribute_tensor(t, mesh, placements,
                             src_data_rank=None if local else 0)


def shard_tree(tree: Any, specs: Any, mesh, local: bool = False) -> Any:
    """Every tensor leaf of ``tree`` (nested dicts and NamedTuples, such as
    ``make_caches``' tree or a batch) as a DTensor placed by the leaf of
    ``specs`` at the same place: a meta DTensor for a meta leaf, else the
    leaf's values (:func:`distribute`, ``local`` as there)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, local)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(shard_tree(v, s, mesh, local)
                            for v, s in zip(tree, specs)))
    if tree.is_meta:
        return meta_dtensor(tree.shape, tree.dtype, mesh, specs)
    return distribute(tree, mesh, specs, local)


def leaf_specs(model, specs: Any) -> Dict[str, Spec]:
    """The spec of every weight of ``model`` (a ``Model``) by its name in
    ``named_parameters``, from :func:`param_pspecs` of the model's tree: a
    per-layer weight takes its segment's spec without the leading layer
    None, a hybrid's shared block likewise."""
    out = {name: specs[name]
           for name, _ in model.named_parameters(recurse=False)}

    def add(prefix, module, seg):
        for name, _ in module.named_parameters(recurse=False):
            out[f"{prefix}.{name}"] = seg[name][1:]

    for seg_name, blocks in model.segments.items():
        for i, blk in enumerate(blocks):
            for part, module in blk.named_children():
                add(f"segments.{seg_name}.{i}.{part}", module,
                    specs["segments"][seg_name][part])
    if hasattr(model, "shared_attn"):
        for part, module in model.shared_attn.named_children():
            add(f"shared_attn.{part}", module, specs["shared_attn"][part])
    return out


def shard_model(model, mesh, specs: Any):
    """Replace every weight of ``model`` (a ``Model``), in place and one at
    a time, by a DTensor placed by ``specs`` (:func:`param_pspecs` of the
    model's tree; :func:`leaf_specs`): a meta DTensor for a meta weight,
    else the weight's values, each rank keeping its block
    (:func:`distribute`), the whole weight dropped before the next is
    placed. Returns the model."""
    for name, entries in leaf_specs(model, specs).items():
        prefix, _, leaf = name.rpartition(".")
        module = model.get_submodule(prefix)
        p = getattr(module, leaf)
        placed = meta_dtensor(p.shape, p.dtype, mesh, entries) if p.is_meta \
            else distribute(p.detach(), mesh, entries)
        setattr(module, leaf, torch.nn.Parameter(
            placed, requires_grad=p.requires_grad))
    return model
