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
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import parallel as par
from repro_torch.core.lep import make_lep_moe_fn, pick_lep_plan
from repro_torch.launch import roofline
from repro_torch.launch.collectives import CollectiveCounter
from repro_torch.launch.mesh import MULTI_POD_SHAPE, PRODUCTION_SHAPE
from repro_torch.launch.sharding import (batch_pspecs, cache_pspecs,
                                         meta_dtensor, param_pspecs,
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


def _moe_fn_for(cfg: ModelConfig, mesh, serving: bool):
    if not cfg.is_moe:
        return None
    plan = pick_lep_plan(cfg, mesh, serving=serving)
    return make_lep_moe_fn(mesh=mesh, ep_axes=plan["ep_axes"],
                           redundancy=plan["redundancy"],
                           ffn_shard_axis=plan["ffn_shard_axis"],
                           quantize=True)


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


def sharded_model(cfg: ModelConfig, mesh, train: bool = False):
    """A ``Model`` of ``cfg`` whose every weight is a meta DTensor placed by
    ``param_pspecs``."""
    from repro_torch.convert import param_tree

    model = model_mod.Model(cfg, META)
    specs = param_pspecs(cfg, mesh, param_tree(model), train=train)
    return shard_model(model, mesh, specs)


def build_step(cfg: ModelConfig, shape: InputShape, mesh,
               cache_dtype: torch.dtype = torch.bfloat16
               ) -> Tuple[Callable, Tuple[Any, ...]]:
    """Returns (step, its arguments as meta DTensors over ``mesh``). The
    caches are ``cache_dtype``: JAX's bfloat16, or a serving engine's
    float32 for a record of its own step."""
    train = shape.kind == "train"
    params = sharded_model(cfg, mesh, train=train)
    bsh = input_specs(cfg, shape)

    if train:
        from repro_torch.train.loop import make_train_step
        from repro_torch.train.optimizer import OptConfig, OptState

        moe_fn = _moe_fn_for(cfg, mesh, serving=False)
        leaves = list(params.parameters())
        moments = [[torch.zeros_like(p, dtype=torch.float32) for p in leaves]
                   for _ in range(2)]
        step_count = meta_dtensor((), torch.int32, mesh, ())
        opt = OptState(step_count, *moments)
        batch = shard_tree(bsh, batch_pspecs(cfg, mesh, bsh), mesh)
        return make_train_step(cfg, OptConfig(), moe_fn), (params, opt, batch)

    if shape.kind == "prefill":
        moe_fn = _moe_fn_for(cfg, mesh, serving=True)

        def step(params, batch):
            return model_mod.prefill(params, cfg, batch,
                                     capacity=shape.seq_len, moe_fn=moe_fn,
                                     cache_dtype=cache_dtype)

        batch = shard_tree(bsh, batch_pspecs(cfg, mesh, bsh), mesh)
        return step, (params, batch)

    # decode: serve_step -- ONE new token against a seq_len cache
    moe_fn = _moe_fn_for(cfg, mesh, serving=True)
    caches = model_mod.make_caches(cfg, shape.global_batch, shape.seq_len,
                                   cache_dtype, META)
    caches = shard_tree(caches, cache_pspecs(cfg, mesh, caches), mesh)
    tokens = shard_tree(bsh["tokens"],
                        batch_pspecs(cfg, mesh, bsh)["tokens"], mesh)
    cache_len = meta_dtensor(bsh["cache_len"].shape, torch.int32, mesh, ())

    def serve_step(params, tokens, caches, cache_len):
        return model_mod.decode_step(params, cfg, tokens, caches, cache_len,
                                     moe_fn)

    return serve_step, (params, tokens, caches, cache_len)


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
             cache_dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    from torch.distributed.tensor.experimental import implicit_replication

    step, args = build_step(cfg, shape, mesh, cache_dtype)
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
