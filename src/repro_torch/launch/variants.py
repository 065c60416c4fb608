"""Named variants of a dry-run pair, traced with the dry run's machinery so
that their roofline terms compare with the baseline's: the port of the JAX
package's ``launch/variants.py``.

Each variant is one hypothesis of the JAX package's hillclimb log:
paper-faithful baselines (the naive Fig. 10a MoE, fused LEP) and changes
beyond the paper (the two-level token-gather EP, INT8 weight streaming,
microbatch overlap, sequence-parallel encoder inputs), on the same fake
mesh as ``launch/dryrun.py``. Records go to
``experiments/hillclimb_torch/``.

  PYTHONPATH=src python -m repro_torch.launch.variants \\
      --arch kimi-k2-1t-a32b --shape decode_32k [--variant token_gather]

runs every variant unless ``--variant`` names one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Iterator, Tuple

import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import parallel as par
from repro_torch.core.lep import make_lep_moe_fn, pick_lep_plan
from repro_torch.core.microbatch import microbatched
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import (META, OUT_DIR, StepCounter,
                                       analytic_flops, input_specs,
                                       local_bytes, make_production_mesh,
                                       train_memory_bytes)
from repro_torch.launch.sharding import (batch_pspecs, cache_pspecs,
                                         meta_dtensor, param_pspecs,
                                         shard_model, shard_tree, spec)
from repro_torch.models import model as model_mod
from repro_torch.quant.int8 import should_quantize

HC_DIR = os.path.join(os.path.dirname(OUT_DIR), "hillclimb_torch")

#: every variant of the JAX package's registry, in its order
VARIANTS = ("baseline", "paper_naive", "no_early_quant", "token_gather",
            "int8_weights", "int8_weights_token_gather", "token_gather_tight",
            "full_opt", "donate_cache", "aligned_decode", "int8_aligned",
            "best", "microbatch2", "tp_only", "block_skip", "hybrid_a2a",
            "hybrid_rs", "seq_parallel_inputs")


# ---------------------------------------------------------------------------
# INT8 weight streaming: weights stored int8 (+ f32 scale), dequantized
# inline. Halves the weight bytes a decode step reads (§4.5's INT8 benefit
# on the memory-bound decode roofline).
# ---------------------------------------------------------------------------


def quantized_param_shapes(params_shape: Any) -> Any:
    """The weight tree in the JAX layout (meta tensors) with every leaf of
    rank >= 2 on an INT8 path as ``{"__q__": int8, "__scale__": f32 (...,
    1, N)}``."""
    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        if tree.ndim >= 2 and should_quantize(path):
            return {"__q__": torch.empty(tree.shape, dtype=torch.int8,
                                         device=META),
                    "__scale__": torch.empty(
                        tree.shape[:-2] + (1, tree.shape[-1]),
                        dtype=torch.float32, device=META)}
        return tree
    return walk(params_shape)


def quantized_param_specs(spec_tree: Any, params_shape: Any) -> Any:
    """The specs of :func:`quantized_param_shapes`' tree: a code keeps its
    weight's spec, a scale is replicated."""
    def walk(s, shape, path=""):
        if isinstance(shape, dict):
            return {k: walk(s[k], shape[k], f"{path}/{k}") for k in shape}
        if shape.ndim >= 2 and should_quantize(path):
            return {"__q__": s, "__scale__": spec()}
        return s
    return walk(spec_tree, params_shape)


def dequantize_tree(tree: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    if isinstance(tree, dict):
        if "__q__" in tree:
            return (tree["__q__"].float() * tree["__scale__"]).to(dtype)
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    return tree


def _load_tree(model: torch.nn.Module, tree: Dict[str, Any]):
    """``model`` (a ``Model``) holding the weights of ``tree`` (the JAX
    layout: each segment's layers stacked), as frozen parameters that are
    views of the tree's leaves."""
    def put(module, leaves, layer=None):
        for name in dict(module.named_parameters(recurse=False)):
            w = leaves[name] if layer is None else leaves[name][layer]
            setattr(module, name, torch.nn.Parameter(w, requires_grad=False))

    put(model, tree)
    for seg_name, blocks in model.segments.items():
        for li, blk in enumerate(blocks):
            for part, module in blk.named_children():
                put(module, tree["segments"][seg_name][part], li)
    if hasattr(model, "shared_attn"):
        for part, module in model.shared_attn.named_children():
            put(module, tree["shared_attn"][part], 0)
    return model


# ---------------------------------------------------------------------------
# Variant registry
# ---------------------------------------------------------------------------


def lep_keywords(cfg: ModelConfig, shape: InputShape, mesh,
                 variant: str) -> Dict[str, Any]:
    """The keywords of ``make_lep_moe_fn`` for ``variant`` (empty for a
    dense model), as the JAX package's ``build_variant`` sets them."""
    if not cfg.is_moe:
        return {}
    kw = dict(pick_lep_plan(cfg, mesh, serving=shape.kind != "train"))
    if variant == "paper_naive":            # the paper's Fig. 10a baseline
        kw.update(naive=True)
    elif variant == "no_early_quant":       # fused ops, BF16 dispatch
        kw.update(quantize=False)
    elif variant in ("token_gather", "int8_weights_token_gather"):
        kw.update(ffn_shard_axis="data", ffn_gather="tokens")
    elif variant in ("token_gather_tight", "full_opt"):
        # + exact capacity (no 8-row floor) + an int8 second-hop gather
        kw.update(ffn_shard_axis="data", ffn_gather="tokens",
                  quantize_gather=True, capacity_align=1)
    elif variant == "best":
        if kw.get("ep_axes") == ("model",):  # 2-level EP (Kimi's class)
            kw.update(ffn_shard_axis="data", ffn_gather="tokens",
                      quantize_gather=True)
        kw.update(capacity_align=1)
    return kw


@contextlib.contextmanager
def _env(variant: str) -> Iterator[None]:
    """``REPRO_BLOCK_SKIP`` / ``REPRO_MLA_HYBRID`` set for the variants that
    need them, and restored afterwards."""
    key, value = {"block_skip": ("REPRO_BLOCK_SKIP", "1"),
                  "hybrid_a2a": ("REPRO_MLA_HYBRID", "a2a"),
                  "hybrid_rs": ("REPRO_MLA_HYBRID", "rs")}.get(
        variant, (None, None))
    old = os.environ.get(key) if key else None
    if key:
        os.environ[key] = value
    try:
        yield
    finally:
        if key:
            if old is None:
                del os.environ[key]
            else:
                os.environ[key] = old


def build_variant(cfg: ModelConfig, shape: InputShape, mesh, variant: str
                  ) -> Tuple[Callable, Tuple[Any, ...]]:
    """Returns (step, its arguments as meta DTensors over ``mesh``).
    ``donate_cache`` traces the baseline: the port's decode already writes
    its caches in place."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    from repro_torch.convert import param_tree

    train = shape.kind == "train"
    skeleton = model_mod.Model(cfg, META)
    tree = param_tree(skeleton)
    p_spec = param_pspecs(cfg, mesh, tree, train=train)
    if variant == "tp_only":
        # train: no FSDP -- weights TP-sharded over model only
        p_spec = param_pspecs(cfg, mesh, tree, train=False)
    bsh = input_specs(cfg, shape)
    b_spec = batch_pspecs(cfg, mesh, bsh)
    if variant == "seq_parallel_inputs":    # SP for encoder prefill
        key = "frames" if cfg.frontend == "audio_frames" else "tokens"
        old = b_spec[key]
        b_spec[key] = spec(old[0], "model", *([None] * (len(old) - 2)))

    moe_fn = None
    if cfg.is_moe:
        kw = lep_keywords(cfg, shape, mesh, variant)
        moe_fn = make_lep_moe_fn(mesh=mesh, split_tokens=train, **kw)
    int8 = variant in ("int8_weights", "int8_weights_token_gather",
                       "full_opt", "int8_aligned", "best")
    n_micro = 2 if variant == "microbatch2" else 1

    if int8:
        if train:
            raise ValueError("int8 weights are a serving variant")
        params = shard_tree(quantized_param_shapes(tree),
                            quantized_param_specs(p_spec, tree), mesh)
        dtype = getattr(torch, cfg.dtype)

        def adapt(p):
            return _load_tree(skeleton, dequantize_tree(p, dtype))
    else:
        params = shard_model(skeleton, mesh, p_spec)

        def adapt(p):
            return p

    if shape.kind == "decode":
        caches = model_mod.make_caches(cfg, shape.global_batch,
                                       shape.seq_len, device=META)
        caches = shard_tree(caches, cache_pspecs(cfg, mesh, caches), mesh)
        tokens = shard_tree(bsh["tokens"], b_spec["tokens"], mesh)
        cache_len = meta_dtensor(bsh["cache_len"].shape, torch.int32, mesh,
                                 ())
        aligned = variant in ("aligned_decode", "int8_aligned", "best")

        def serve_step(params, tokens, caches, cache_len):
            p = adapt(params)
            if aligned:
                # pseudo-synchronous batching (paper §4.1): all requests at
                # one position => a scalar length => slice cache writes
                cache_len = cache_len[0]

            def base(tt, c):
                return model_mod.decode_step(p, cfg, tt["t"], c, tt["len"],
                                             moe_fn)

            return microbatched(base, n_micro)(
                {"t": tokens, "len": cache_len}, caches)

        return serve_step, (params, tokens, caches, cache_len)

    batch = shard_tree(bsh, b_spec, mesh)
    if shape.kind == "prefill":
        def step(params, batch):
            return model_mod.prefill(adapt(params), cfg, batch,
                                     capacity=shape.seq_len, moe_fn=moe_fn)
        return step, (params, batch)

    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptConfig, OptState

    leaves = list(params.parameters())
    moments = [[torch.zeros_like(p, dtype=torch.float32) for p in leaves]
               for _ in range(2)]
    opt = OptState(meta_dtensor((), torch.int32, mesh, ()), *moments)
    step = make_train_step(cfg, OptConfig(), moe_fn, n_micro=n_micro)
    return step, (params, opt, batch)


def run_variant(arch: str, shape_name: str, variant: str,
                multi_pod: bool = False, save: bool = True
                ) -> Dict[str, Any]:
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "variant": variant}
    if variant == "donate_cache":
        rec["note"] = ("the port's decode writes its caches in place: this "
                       "traces the baseline program")
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod)
        with par.mesh_context(mesh), _env(variant):
            step, args = build_variant(cfg, shape, mesh, variant)
            counter = StepCounter(args)
            with counter, implicit_replication():
                out = step(*args)
        coll = counter.counts
        args_b = float(sum(counter.used.values()))
        n_dev = mesh.size()
        if shape.kind == "train":
            struct = train_memory_bytes(cfg, shape, args_b, n_dev)
        else:
            struct = counter.peak_bytes + args_b + local_bytes(out)
        cost = {"flops": analytic_flops(cfg, shape) / n_dev,
                "bytes accessed": float(counter.bytes_accessed)}
        rl = roofline.roofline_terms(cost, coll, n_dev,
                                     struct_bytes=float(struct))
        step_t = max(rl.compute_s, rl.memory_s) + rl.collective_s
        rec.update(status="ok", compile_s=round(time.time() - t0, 1),
                   argument_bytes=int(args_b),
                   temp_bytes=int(counter.peak_bytes),
                   flops_per_device=rl.flops,
                   collective_bytes_per_device=rl.coll_bytes,
                   collectives=coll,
                   compute_s=rl.compute_s, memory_s=rl.memory_s,
                   memory_hlo_s=rl.memory_hlo_s,
                   collective_s=rl.collective_s, dominant=rl.dominant,
                   step_s=step_t)
        print(f"[OK] {arch}×{shape_name}×{variant}: step={step_t*1e3:.1f}ms "
              f"dom={rl.dominant} cmp={rl.compute_s*1e3:.1f} "
              f"mem={rl.memory_s*1e3:.1f} coll={rl.collective_s*1e3:.1f} "
              f"args={rec['argument_bytes']/2**30:.2f}GiB", flush=True)
    except Exception as e:  # noqa: BLE001 -- report, don't crash the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[ERR] {arch}×{shape_name}×{variant}: {rec['error'][:200]}",
              flush=True)
    if save:
        os.makedirs(HC_DIR, exist_ok=True)
        with open(os.path.join(
                HC_DIR, f"{arch}__{shape_name}__{variant}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default=None,
                    help="one of VARIANTS (default: every one)")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    for variant in [args.variant] if args.variant else VARIANTS:
        run_variant(args.arch, args.shape, variant, args.multi_pod)


if __name__ == "__main__":
    main()
