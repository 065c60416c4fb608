"""Dry run: trace rank 0's step of every (architecture x input shape x mesh)
pair on shapes alone, and record its memory, compute and collective terms
for the roofline: the port of the JAX package's ``launch/dryrun.py``.

JAX compiles each step under ``in_shardings`` on 512 placeholder CPU
devices and reads XLA's memory and cost analyses and the collectives of the
per-device HLO. PyTorch has no SPMD compiler; the port traces instead:

* the process joins a fake process group of 256 ranks (16 x 16 over
  ``("data", "model")``) or 512 (2 x 16 x 16, ``"pod"`` in front) as rank
  0, over a ``"cuda"`` ``DeviceMesh`` (on a ``"cpu"`` mesh DTensor would
  turn every shard-to-shard all-to-all into an all-gather), so it needs its
  own process, and callers spawn it;
* every weight, cache and input is a DTensor over that mesh, placed by the
  specs of ``launch/sharding.py``, its local block a meta tensor: nothing
  is allocated and nothing is computed, and no card is needed;
* the collectives are those XLA's partitioner gives JAX's step, issued by
  the port itself: the projections, mixers, vocabulary reductions and the
  global norm run on each rank's blocks through ``local_map``
  (``dtensor.py``), each gradient is placed once as its parameter before
  AdamW updates each rank's blocks, and LEP (its expert redundancy a
  permute) and the hybrid MLA prefill are entered from the DTensor batch
  through ``local_map``, as JAX enters them through ``shard_map``;
  DTensor's sharding propagation places the rest (elementwise ops, norms);
* :class:`StepCounter` sees every op rank 0 runs on its local blocks: the
  collectives (``launch/collectives.py``), the FLOPs
  (``torch.utils.flop_counter``'s formulas), the bytes every op reads and
  writes, and the peak of the bytes the step's intermediates hold.

A record has JAX's keys. ``argument_bytes`` are the local bytes of the
step's arguments, ``output_bytes`` those of what it returns (a decode or
train step writes its caches, weights and moments in place and returns
them, so they count in both, as they count in JAX's donated outputs),
``temp_bytes`` the peak live bytes of the trace's intermediates. The
roofline terms are computed from an H100 SXM5's data-sheet rates
(``launch/roofline.py``), with the analytic compute term of JAX's
(``analytic_flops``; the traced FLOPs are a diagnostic, as JAX's HLO FLOPs
are). Records go to ``experiments/dryrun_torch/``.

Usage (``PYTHONPATH=src python -m repro_torch.launch.dryrun``, then):
  --arch qwen3-8b --shape train_4k
  --arch qwen3-8b --shape decode_32k --multi-pod
  --all [--include-paper-arch]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import parallel as par
from repro_torch.core.lep import make_lep_moe_fn, pick_lep_plan
from repro_torch.launch import roofline
from repro_torch.launch.collectives import CollectiveCounter
from repro_torch.launch.mesh import MULTI_POD_SHAPE, PRODUCTION_SHAPE
from repro_torch.launch.sharding import (batch_pspecs, cache_pspecs,
                                         distribute, param_pspecs,
                                         shard_model, shard_tree)
from repro_torch.models import model as model_mod
from repro_torch.models.attention import _pick_chunk, block_skip_enabled

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

#: the JAX package's ``repro.configs.ASSIGNED_ARCHS``, in its order
ASSIGNED_ARCHS = ["qwen3-8b", "qwen2.5-3b", "olmoe-1b-7b", "mamba2-780m",
                  "kimi-k2-1t-a32b", "hubert-xlarge", "zamba2-1.2b",
                  "internvl2-2b", "phi3-medium-14b", "granite-3-2b"]

META = torch.device("meta")


# ---------------------------------------------------------------------------
# Applicability / skips
# ---------------------------------------------------------------------------


def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    if shape.kind == "decode" and not cfg.supports_decode:
        return "encoder-only: no autoregressive decode (DESIGN.md §3)"
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return "full attention at 500k: no sub-quadratic path"
    return None


# ---------------------------------------------------------------------------
# input_specs: meta stand-ins with JAX's shapes and dtypes (no allocation)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: InputShape
                ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def meta(*dims, dtype=i32):
        return torch.empty(dims, dtype=dtype, device=META)

    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio_frames":
            batch = {"frames": meta(b, s, cfg.d_model, dtype=bf16)}
        elif cfg.frontend == "vision_patches":
            p = cfg.num_prefix_embeddings
            batch = {"prefix_emb": meta(b, p, cfg.d_model, dtype=bf16),
                     "tokens": meta(b, s - p)}
        else:
            batch = {"tokens": meta(b, s)}
        if shape.kind == "train":
            # labels align with text tokens (audio: per-frame targets)
            n_lbl = batch.get("tokens", batch.get("frames")).shape[1]
            batch["labels"] = meta(b, n_lbl)
        return batch
    # decode: one token per request + KV cache of seq_len
    return {"tokens": meta(b, 1), "cache_len": meta(b)}


def step_inputs(cfg: ModelConfig, shape: InputShape, device,
                seed: int = 0, cache_dtype: torch.dtype = torch.bfloat16,
                cache_len: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """A real step's inputs as plain tensors on ``device``, drawn from
    ``seed``, with :func:`input_specs`' shapes and dtypes: a train or
    prefill step's batch (token ids uniform over the vocabulary, embeddings
    normal); a decode step's one token a row, its caches (``make_caches``'
    tree, every float buffer normal, the ``length`` leaves 0) and
    ``cache_len`` (the given lengths, else uniform in [0, seq_len])."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(t):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=gen, dtype=t.dtype,
                               device=device)
        return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                             dtype=t.dtype, device=device)

    specs = input_specs(cfg, shape)
    if shape.kind != "decode":
        return {k: draw(v) for k, v in specs.items()}
    caches = model_mod.make_caches(cfg, shape.global_batch, shape.seq_len,
                                   cache_dtype, device)
    for t in _tensors(caches):
        if t.dtype.is_floating_point:
            t.normal_(generator=gen)
    if cache_len is None:
        lens = torch.randint(0, shape.seq_len + 1, (shape.global_batch,),
                             generator=gen, device=device, dtype=torch.int32)
    else:
        lens = torch.tensor(list(cache_len), dtype=torch.int32,
                            device=device)
    return {"tokens": draw(specs["tokens"]), "caches": caches,
            "cache_len": lens}


def _moe_fn_for(cfg: ModelConfig, mesh, serving: bool,
                lep: Optional[dict] = None):
    """LEP over ``mesh``, planned as ``lep`` (``make_lep_moe_fn``'s
    keywords) or as JAX's plan, with INT8 dispatch unless ``lep`` says
    otherwise, a training step's output left on its token split; over no
    mesh, the 1-D LEP at world size 1 (no collective)."""
    if not cfg.is_moe:
        return None
    lep = {"quantize": True, **(lep or {})}
    if mesh is None:
        return make_lep_moe_fn(quantize=lep["quantize"])
    return make_lep_moe_fn(mesh=mesh, split_tokens=not serving, **{
        **pick_lep_plan(cfg, mesh, serving=serving), **lep})


# ---------------------------------------------------------------------------
# The fake world and its mesh
# ---------------------------------------------------------------------------


def fake_mesh(shape: Dict[str, int]):
    """A ``"cuda"`` ``DeviceMesh`` of ``shape`` (axis name -> size) over a
    fake process group of as many ranks, this process its rank 0. A fake
    group issues no collective and needs no card; one of another size is
    torn down first (with the port's cached subgroups)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(shape.values())
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
        par._GROUPS.clear()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return init_device_mesh("cuda", tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def make_production_mesh(multi_pod: bool = False):
    return fake_mesh(MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def sharded_model(cfg: ModelConfig, mesh, train: bool = False, *,
                  device=META, seed: int = 0, params=None,
                  expert_axes: Optional[Tuple[str, ...]] = None,
                  dtype: Optional[torch.dtype] = None):
    """A ``Model`` of ``cfg`` whose every weight is a DTensor over ``mesh``
    placed by ``param_pspecs`` (``expert_axes`` as there). On ``META`` the
    blocks are meta tensors (the dry run); else they hold the weights of
    ``params`` (a plain ``Model``, placed in place; one whose weights are
    DTensors already is returned as it is) or, without it, those
    of ``init_params(cfg, seed=seed, device=device)``, bit for bit: each
    weight is drawn whole, placed (widened to ``dtype`` where given), and
    its whole copy dropped before the next is drawn, so no rank holds the
    whole model. Raises where the weights do not live on the mesh's device
    type."""
    from repro_torch.dtensor import is_dtensor
    from repro_torch.launch.sharding import leaf_specs, param_shapes
    from repro_torch.models.layers import placing

    if params is not None and all(is_dtensor(p) for p in params.parameters()):
        return params
    specs = param_pspecs(cfg, mesh, param_shapes(cfg), train=train,
                         expert_axes=expert_axes)
    if params is not None:
        for name, p in params.named_parameters():
            _check_device(p.device, mesh, f"weight {name}")
        return shard_model(params, mesh, specs)
    device = torch.device(device)
    if device.type == "meta":
        return shard_model(model_mod.Model(cfg, META), mesh, specs)
    _check_device(device, mesh, "the weights")
    # The order in which the model's constructor makes its weights, read
    # off a meta build, names each weight as it is made.
    made = []
    with placing(lambda p: made.append(p) or p):
        shapes = model_mod.Model(cfg, META)
    names = {id(p): n for n, p in shapes.named_parameters()}
    by_name = leaf_specs(shapes, specs)
    order = iter([names[id(p)] for p in made])

    def place(p):
        return torch.nn.Parameter(distribute(p.detach().to(dtype or p.dtype),
                                             mesh, by_name[next(order)]),
                                  requires_grad=False)

    with placing(place):
        return model_mod.init_params(cfg, seed=seed, device=device)


def _check_device(device, mesh, what: str) -> None:
    if mesh is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(f"{what} live on {device}, the mesh on "
                         f"{mesh.device_type}: a sharded step runs on the "
                         "mesh's device")


def build_step(cfg: ModelConfig, shape: InputShape, mesh,
               cache_dtype: torch.dtype = torch.bfloat16, *,
               device=META, seed: int = 0, params=None,
               inputs: Optional[Dict[str, Any]] = None,
               cache_len: Optional[Sequence[int]] = None,
               lep: Optional[dict] = None,
               expert_axes: Optional[Tuple[str, ...]] = None,
               opt_cfg=None, n_micro: int = 1, hybrid: str = ""
               ) -> Tuple[Callable, Tuple[Any, ...]]:
    """Returns (step, its arguments). The step is a train step (loss,
    gradients placed as their parameters, AdamW), a prefill or a decode
    step (``serve_step``: one new token a row against a ``seq_len``
    cache), as ``shape`` says; MoE layers run LEP planned as the JAX
    package's plan, with INT8 dispatch, and ``lep`` (keywords of
    ``make_lep_moe_fn``) over it. The caches are ``cache_dtype``: JAX's bfloat16, or a
    serving engine's float32 for a record of its own step. A prefill
    with ``hybrid`` ("a2a" or "rs") over ``mesh`` runs every MLA layer
    through the §4.3.1 hybrid with that o-proj (:func:`hybrid_prefill`).

    On ``META`` (the dry run) the arguments are meta DTensors over
    ``mesh``. On a real ``device`` they hold values: the weights of
    :func:`sharded_model` (``seed``, ``params``, ``expert_axes`` as
    there), the inputs of :func:`step_inputs` (``seed``, ``cache_len``)
    or ``inputs`` (its tree, given), AdamW moments of 0 in float32 (in
    float64 for float64 weights) and ``opt_cfg`` (default
    ``OptConfig()``), each placed by the specs as the meta ones are, on
    the mesh's device; with ``mesh`` None the same step and values as
    plain tensors on ``device``, the MoE layers through the 1-D LEP at
    world size 1.

    ``n_micro`` runs the step over that many consecutive groups of the
    batch's rows: a train step's loss is the mean of the groups'
    (``microbatched_loss``), a prefill runs each group and joins their
    logits and caches, a decode step runs one group after another into
    the same caches. The function is the same; each product runs at a
    group's row count, as a rank that holds those rows runs it."""
    train = shape.kind == "train"
    device = torch.device(device)
    if hybrid and (mesh is None or shape.kind != "prefill"
                   or cfg.attention_kind != "mla"):
        raise ValueError(f"the hybrid MLA prefill ({hybrid!r}) is an MLA "
                         f"prefill over a mesh, not a {shape.kind} step of "
                         f"{cfg.attention_kind} attention over {mesh}")
    if mesh is None:
        from repro_torch.device import check_on

        params = params if params is not None else model_mod.init_params(
            cfg, seed=seed, device=device)
        for name, p in params.named_parameters():
            check_on(device, p, f"weight {name}")
        place = lambda tree, specs: tree  # noqa: E731
    else:
        params = sharded_model(cfg, mesh, train=train, device=device,
                               seed=seed, params=params,
                               expert_axes=expert_axes)
        place = lambda tree, specs: shard_tree(tree, specs, mesh)  # noqa
    if device.type == "meta":
        bsh = input_specs(cfg, shape)
        inputs = dict(bsh)
        if shape.kind == "decode":
            inputs["caches"] = model_mod.make_caches(
                cfg, shape.global_batch, shape.seq_len, cache_dtype, META)
    elif inputs is None:
        inputs = step_inputs(cfg, shape, device, seed + 1, cache_dtype,
                             cache_len)
    moe_fn = _moe_fn_for(cfg, mesh, serving=not train, lep=lep)

    if shape.kind in ("train", "prefill"):
        batch = {k: inputs[k] for k in input_specs(cfg, shape)}
        batch = place(batch, None if mesh is None else
                      batch_pspecs(cfg, mesh, batch))
    if train:
        from repro_torch.train.loop import make_train_step
        from repro_torch.train.optimizer import OptConfig, OptState

        leaves = list(params.parameters())
        moments = [[torch.zeros_like(p, dtype=torch.promote_types(
            p.dtype, torch.float32)) for p in leaves] for _ in range(2)]
        count = torch.zeros((), dtype=torch.int32, device=device)
        step_count = count if mesh is None else place(count, ())
        opt = OptState(step_count, *moments)
        return (make_train_step(cfg, opt_cfg or OptConfig(), moe_fn,
                                n_micro=n_micro), (params, opt, batch))

    if shape.kind == "prefill":
        def prefill(params, batch):
            return model_mod.prefill(params, cfg, batch,
                                     capacity=shape.seq_len, moe_fn=moe_fn,
                                     cache_dtype=cache_dtype)

        def step(params, batch):
            with hybrid_prefill(hybrid, mesh, cfg.num_layers * n_micro):
                if n_micro == 1:
                    return prefill(params, batch)
                rows = shape.global_batch // n_micro
                outs = [prefill(params, {k: v[i * rows:(i + 1) * rows]
                                         for k, v in batch.items()})
                        for i in range(n_micro)]
            return (torch.cat([logits for logits, _ in outs]),
                    _cat_rows(cfg, [caches for _, caches in outs]))

        return step, (params, batch)

    # decode: serve_step -- ONE new token against a seq_len cache
    caches, tokens = inputs["caches"], inputs["tokens"]
    if mesh is not None:
        caches = place(caches, cache_pspecs(cfg, mesh, caches))
        tokens = place(tokens, batch_pspecs(cfg, mesh, {"tokens": tokens})[
            "tokens"])
    cache_len = place(inputs["cache_len"], ())

    def serve_step(params, tokens, caches, cache_len):
        if n_micro == 1:
            return model_mod.decode_step(params, cfg, tokens, caches,
                                         cache_len, moe_fn)
        rows = tokens.shape[0] // n_micro
        logits = []
        for i in range(n_micro):
            group = slice(i * rows, (i + 1) * rows)
            logits.append(model_mod.decode_step(
                params, cfg, tokens[group], _rows_of(cfg, caches, group),
                cache_len[group], moe_fn)[0])
        return torch.cat(logits), model_mod._with_lengths(cfg, caches,
                                                          cache_len + 1)

    return serve_step, (params, tokens, caches, cache_len)


@contextlib.contextmanager
def hybrid_prefill(mode: str, mesh, layers: int) -> Iterator[None]:
    """Inside the block ``REPRO_MLA_HYBRID`` is ``mode`` ("a2a" or "rs";
    "" leaves everything as it is) and ``mesh`` the current mesh, both
    restored after, so that each MLA prefill runs the §4.3.1 SP -> TP ->
    SP form (``core/hybrid_parallel.py``). The block must run the hybrid
    on exactly ``layers`` layers with that mode, else it raises: a prefill
    that took the plain ``mla_prefill`` is not the hybrid's."""
    if not mode:
        yield
        return
    from repro_torch.core import hybrid_parallel

    old = os.environ.get("REPRO_MLA_HYBRID")
    before = hybrid_parallel.CALLS[mode]
    os.environ["REPRO_MLA_HYBRID"] = mode
    try:
        with par.mesh_context(mesh):
            yield
    finally:
        if old is None:
            del os.environ["REPRO_MLA_HYBRID"]
        else:
            os.environ["REPRO_MLA_HYBRID"] = old
    ran = hybrid_parallel.CALLS[mode] - before
    if ran != layers:
        raise AssertionError(f"the {mode} hybrid prefill ran on {ran} MLA "
                             f"layers, not {layers}")


def _cat_rows(cfg: ModelConfig, trees: Sequence[Dict[str, Any]]
              ) -> Dict[str, Any]:
    """``make_caches``' trees of consecutive groups of rows joined along
    each batched leaf's batch axis (an unbatched leaf: the first's)."""
    def join(parts, axes):
        if isinstance(parts[0], dict):
            return {k: join([p[k] for p in parts], axes[k])
                    for k in parts[0]}
        if isinstance(parts[0], tuple):
            return type(parts[0])(*(join(list(leaf), a) for leaf, a in
                                    zip(zip(*parts), axes)))
        return parts[0] if axes is None else torch.cat(parts, dim=axes)

    return join(list(trees), model_mod.cache_batch_axes(cfg))


def _rows_of(cfg: ModelConfig, caches: Dict[str, Any], rows: slice):
    """Views of ``rows`` of every batched leaf of ``make_caches``' tree (a
    write through them lands in ``caches``)."""
    def cut(tree, axes):
        if isinstance(tree, dict):
            return {k: cut(v, axes[k]) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return type(tree)(*(cut(v, a) for v, a in zip(tree, axes)))
        return tree if axes is None else tree.narrow(
            axes, rows.start, rows.stop - rows.start)

    return cut(caches, model_mod.cache_batch_axes(cfg))


# ---------------------------------------------------------------------------
# Analytic compute term (the JAX package's)
#
# JAX's HloCostAnalysis counts a rolled loop body once, so its compute term
# is computed from the architecture (linear layers from active params,
# EXECUTED attention pairs, SSD chunk algebra) and the HLO FLOPs are a
# diagnostic. The port keeps the same term, so the two records compare;
# its traced FLOPs are the diagnostic.
# ---------------------------------------------------------------------------


def analytic_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Total (all-device) executed FLOPs for one step of this combo. The
    query chunk is the port's (``min(s, 512)``), JAX's at every shape of
    ``INPUT_SHAPES``."""
    b, s = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    tokens = b if decode else b * s
    fwd_bwd = 3.0 if shape.kind == "train" else 1.0

    # Linear/matmul work: 2 FLOPs per active param per token (includes
    # attention projections, (active) experts, unembedding).
    total = 2.0 * cfg.param_count(active_only=True) * tokens

    # Attention core -- EXECUTED pairs (the chunked baseline computes every
    # (q, kv) pair and masks; block skipping is a variant).
    if cfg.num_heads > 0:
        n_attn = (cfg.num_layers // cfg.attn_every if cfg.is_hybrid
                  else cfg.num_layers)
        if decode:
            ring = bool(cfg.sliding_window) and s > cfg.sliding_window \
                and cfg.attention_kind != "mla"
            kv_len = cfg.sliding_window if ring else s
            pairs = float(b) * kv_len
        elif block_skip_enabled() and cfg.attention_kind != "bidirectional":
            chunk = _pick_chunk(s)
            if cfg.sliding_window and cfg.sliding_window < s:
                pairs = float(b) * s * min(s, cfg.sliding_window + chunk)
            else:
                pairs = float(b) * s * s / 2 * (1 + chunk / s)
        else:
            pairs = float(b) * s * s
        if cfg.attention_kind == "mla":
            if decode:  # absorbed: scores vs latent + pv in latent space
                per_pair = 2.0 * cfg.num_heads * (
                    2 * cfg.kv_lora_rank + cfg.qk_rope_head_dim)
            else:       # unabsorbed MHA form
                per_pair = 2.0 * cfg.num_heads * (
                    cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                    + cfg.v_head_dim)
        else:
            per_pair = 4.0 * cfg.num_heads * cfg.head_dim  # qk + pv
        total += n_attn * pairs * per_pair

    # SSD (mamba2 / zamba2)
    if cfg.ssm_state > 0:
        n_ssm = cfg.num_layers if cfg.is_ssm else \
            cfg.num_layers - cfg.num_layers // cfg.attn_every
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        if decode:
            total += n_ssm * 6.0 * b * h * p * n
        else:
            q = min(cfg.ssm_chunk, s)
            nc = max(1, s // q)
            per_chunk = (2.0 * b * q * q * n
                         + 2.0 * b * q * q * h * p
                         + 4.0 * b * q * h * p * n)
            total += n_ssm * per_chunk * nc
    return total * fwd_bwd


def train_memory_bytes(cfg: ModelConfig, shape: InputShape,
                       args_bytes: float, n_dev: int) -> float:
    """Per-device HBM traffic model for a train step: optimizer read+write
    of params/moments/grads (~2x argument bytes) + forward-write/backward-
    read of ~12 d_model-wide activations per layer per token."""
    tok_dev = shape.global_batch * shape.seq_len / n_dev
    act = cfg.num_layers * tok_dev * cfg.d_model * 2 * 12
    return 2.0 * args_bytes + act


# ---------------------------------------------------------------------------
# Measuring a traced step
# ---------------------------------------------------------------------------


def _tensors(tree: Any):
    """The tensor leaves of a step's arguments or result (a ``Model``'s
    parameters, an ``OptState``'s moments, cache trees, dicts)."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _storages(tree: Any) -> Dict[int, int]:
    """Storage key -> bytes of this rank's blocks of the tensors of
    ``tree``."""
    out = {}
    for t in _tensors(tree):
        st = (t.to_local() if hasattr(t, "to_local") else t).untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def _length_leaves(tree: Any) -> list:
    """The ``length`` leaves of the cache trees in ``tree``."""
    if isinstance(tree, dict):
        return [v if k == "length" else _length_leaves(v)
                for k, v in tree.items()]
    if hasattr(tree, "_fields"):
        return [v if k == "length" else _length_leaves(v)
                for k, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple)):
        return [_length_leaves(v) for v in tree]
    return []


def local_bytes(tree: Any) -> int:
    """Bytes of this rank's blocks of the tensors of ``tree``, each storage
    once."""
    return sum(_storages(tree).values())


class StepCounter(CollectiveCounter):
    """The collectives of a traced step (:class:`CollectiveCounter`), and
    over every op on this rank's local tensors: its FLOPs (the
    formulas of ``torch.utils.flop_counter``), the bytes it reads and
    writes (a view moves none), the peak of the bytes held by storages
    that the step made and that are still referenced, and which storages
    of ``arguments`` it touched (``used``)."""

    def __init__(self, arguments: Any = ()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._refs: Dict[int, int] = {}
        self._args = _storages(arguments)
        self.used: Dict[int, int] = {}

    def record(self, func, args, kwargs, out) -> None:
        from torch.utils._pytree import tree_leaves as leaves

        fn = self._flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        ins = [t for t in leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in ins + outs)
        for t in ins:
            key = t.untyped_storage()._cdata
            if key in self._args:
                self.used[key] = self._args[key]
        for t in outs:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._args:
            return
        if key not in self._refs:
            self._refs[key] = 0
            self.live_bytes += storage.nbytes()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key, storage.nbytes())

    def _release(self, key: int, nbytes: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live_bytes -= nbytes


def _measure(cfg: ModelConfig, shape: InputShape, mesh,
             cache_dtype: torch.dtype = torch.bfloat16,
             **step_kw) -> Dict[str, Any]:
    """Trace the step of :func:`build_step` (``step_kw`` as there) over
    ``mesh`` on meta tensors and count it (:class:`StepCounter`)."""
    from torch.distributed.tensor.experimental import implicit_replication

    step, args = build_step(cfg, shape, mesh, cache_dtype, **step_kw)
    counter = StepCounter(args)
    with counter, implicit_replication():
        out = step(*args)
    # As JAX's jit leaves out the arguments a step never reads (a cache's
    # ``length`` leaf), they are counted apart.
    arg_b, out_b = sum(counter.used.values()), local_bytes(out)
    lengths = _storages(_length_leaves(args))
    return dict(argument_bytes=arg_b, output_bytes=out_b,
                unused_argument_bytes=local_bytes(args) - arg_b,
                cache_length_bytes=sum(n for k, n in lengths.items()
                                       if k in counter.used),
                temp_bytes=counter.peak_bytes, flops=float(counter.flops),
                hbm=float(counter.bytes_accessed), coll=counter.counts,
                coll_largest=counter.largest,
                struct=float(counter.peak_bytes + arg_b + out_b))


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def record(cfg: ModelConfig, shape: InputShape, mesh,
           cache_dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Trace ``cfg``'s step at ``shape`` over ``mesh`` and return the
    fields of an ``ok`` record (JAX's keys)."""
    t0 = time.time()
    n_dev = mesh.size()
    real = _measure(cfg, shape, mesh, cache_dtype)
    coll, args_b = real["coll"], float(real["argument_bytes"])
    if shape.kind == "train":
        struct = train_memory_bytes(cfg, shape, args_b, n_dev)
    else:
        struct = real["struct"]
    # compute term: analytic executed FLOPs (see the comment above); the
    # traced FLOPs are a diagnostic.
    cost = {"flops": analytic_flops(cfg, shape) / n_dev,
            "bytes accessed": real["hbm"]}
    n_tok = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                  else 1)
    mf = roofline.model_flops(cfg, n_tok, shape.kind)
    rl = roofline.roofline_terms(cost, coll, n_dev, model_flops_total=mf,
                                 struct_bytes=float(struct))
    return dict(
        hlo_flops_per_device=real["flops"],
        status="ok", lower_s=0.0, compile_s=round(time.time() - t0, 1),
        n_devices=n_dev,
        bytes_per_device=int(real["temp_bytes"] + real["argument_bytes"]
                             + real["output_bytes"]),
        temp_bytes=int(real["temp_bytes"]),
        argument_bytes=int(real["argument_bytes"]),
        unused_argument_bytes=int(real["unused_argument_bytes"]),
        cache_length_bytes=int(real["cache_length_bytes"]),
        output_bytes=int(real["output_bytes"]),
        flops_per_device=rl.flops,
        hbm_bytes_per_device=rl.hbm_bytes,
        struct_bytes_per_device=rl.struct_bytes,
        collective_bytes_per_device=rl.coll_bytes,
        collectives=coll,
        compute_s=rl.compute_s, memory_s=rl.memory_s,
        memory_hlo_s=rl.memory_hlo_s,
        collective_s=rl.collective_s, dominant=rl.dominant,
        model_flops_per_device=rl.model_flops,
        useful_ratio=rl.useful_ratio,
        rates="computed from H100 SXM5 80GB data-sheet rates (700 W)",
        in_place=("the step writes its caches, weights and moments in "
                  "place and returns them: they count in argument and "
                  "output bytes"),
    )


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            save: bool = True, verbose: bool = True, cfg=None,
            mesh=None) -> Dict[str, Any]:
    """One pair on the production mesh (or on ``mesh``, with ``cfg`` in
    place of ``arch``'s config): a record with JAX's keys; a failure is
    recorded as ``status: "error"``."""
    cfg = cfg or get_config(arch)
    shape = get_shape(shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if mesh is not None:
        mesh_name = "x".join(str(n) for n in mesh.mesh.shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name}

    reason = skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        if verbose:
            print(f"[SKIP] {arch} × {shape_name} × {mesh_name}: {reason}")
        _save(rec, save)
        return rec

    try:
        mesh = mesh if mesh is not None else make_production_mesh(multi_pod)
        rec.update(record(cfg, shape, mesh))
        if verbose:
            print(f"[OK]   {arch} × {shape_name} × {mesh_name}: "
                  f"dom={rec['dominant']} "
                  f"compute={rec['compute_s']*1e3:.1f}ms "
                  f"mem={rec['memory_s']*1e3:.1f}ms "
                  f"coll={rec['collective_s']*1e3:.1f}ms "
                  f"args={rec['argument_bytes']/2**30:.2f}GiB/dev "
                  f"(trace {rec['compile_s']:.0f}s)", flush=True)
    except Exception as e:  # noqa: BLE001 -- report, don't crash the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[ERR]  {arch} × {shape_name} × {mesh_name}: "
                  f"{rec['error'][:300]}", flush=True)
    _save(rec, save)
    return rec


def _save(rec: Dict[str, Any], save: bool) -> None:
    if not save:
        return
    os.makedirs(OUT_DIR, exist_ok=True)
    fn = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(OUT_DIR, fn), "w") as f:
        json.dump(rec, f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-paper-arch", action="store_true",
                    help="also run deepseek-r1 (the paper's own model)")
    args = ap.parse_args()

    if args.all:
        archs = list(ASSIGNED_ARCHS)
        if args.include_paper_arch:
            archs.append("deepseek-r1")
        # decode_32k first: it feeds decode_cost_from_roofline
        for shape in ("decode_32k", "prefill_32k", "long_500k", "train_4k"):
            for arch in archs:
                run_one(arch, shape, multi_pod=args.multi_pod)
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    run_one(args.arch, args.shape, multi_pod=args.multi_pod)


if __name__ == "__main__":
    main()
