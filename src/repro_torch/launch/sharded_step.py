"""The dry run's sharded steps on real tensors.

``launch/dryrun.py`` traces rank 0's step over DTensors whose blocks are
meta tensors; :func:`dryrun.build_step` given a device builds the same step
over blocks that hold values, placed by the same specs. The cases below run
it at full width on the card -- one rank over NCCL in ``chip_smoke.py``'s
``sharded-step`` phase, four over a 2 x 2 mesh in
``scripts/torch_parallel_nccl.py`` -- and at smoke width over gloo in
``tests/test_torch_sharded_steps.py``. Each is held to three things:

* the same step unsharded, on plain tensors with the same seeded weights
  and inputs (the MoE layers through the 1-D LEP at world size 1, the MLA
  prefill plain where the sharded one runs the hybrid), run over the row
  groups the data ranks hold (:func:`reference`): :func:`compare` (a train
  step's loss, global gradient norm, every parameter and both AdamW
  moments, these against the same step in float64 where no INT8 payload
  is on the path, :func:`truth`; a prefill's logits, caches and greedy
  tokens; a decode step's also the rows it wrote), at fixed tolerances;
* the dry run's record of the same configuration, shape and mesh: the
  collective bytes by kind that :class:`CollectiveCounter` counts on the
  executed step (:func:`run_counted`) against those of
  ``dryrun._measure`` on a fake group (:func:`record_collectives`, in a
  process of its own: ``python -m repro_torch.launch.sharded_step``);
* the collectives the backend itself ran, read from a ``torch.profiler``
  trace of the step (:func:`traced_collectives`), in the counter's
  convention.

A train step with an INT8 payload is held, in place of the first, by its
discrete choices (:func:`record_choices`, :func:`compare_choices`) and by
the reference run again with them (:func:`replay`, :func:`hold_choices`).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from typing import (Any, Callable, Dict, Iterator, Optional, Sequence,
                    Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import dryrun
from repro_torch.launch.collectives import CollectiveCounter, zero_counts
from repro_torch.launch.roofline import COLLECTIVE_OPS

#: cache lengths of a decode case's 8 rows over 2048 slots: 300 and 5 end
#: inside the first of four sequence blocks, 2048 is a capacity-frozen row
DECODE_LENS = (971, 846, 300, 479, 2048, 994, 5, 296)
#: the same at smoke width, over 16 slots
SMOKE_DECODE_LENS = (3, 16, 9, 12)
#: a train case's optimizer: no warmup, so the one step moves each weight
#: by about lr x sign(g), 3e-4, above the tolerance of a leaf's largest;
#: an epsilon far below any gradient, so that the step is sign-like where
#: the first moment is clear of 0 (a leaf whose clipped gradients sit near
#: the default 1e-8, as some of Mamba2's do at full width, moves by
#: |g| / (|g| + eps) of lr, which rounding then moves too)
TRAIN_OPT = {"warmup_steps": 1, "eps": 1e-12}
#: a train step against the unsharded one: the loss and the global
#: gradient norm (relative), each parameter and both moments (of the
#: leaf's largest |value|)
LOSS_RTOL = 1e-5
STEP_TOL = 2e-4
#: the relative nudge of a decode reference's float caches that shows how
#: far rounding alone moves the step (a diagnostic printed beside the
#: comparison, never a limit)
NUDGE = 1e-7
#: the float64 partition check (:func:`compare_f64`): the sharded step in
#: float64 against the same step unsharded in float64, every gated
#: quantity within F64_TOL of its largest |value| (a train step's loss and
#: gradient norm relative). Reordered float64 sums part by 1e-16-1e-12
#: where float32 steps part by 1e-4; a wrong partition, or a site that
#: computes in float32 on one side, parts by 1e-7 or more
F64_TOL = 1e-9


@dataclasses.dataclass(frozen=True)
class Case:
    """A sharded step: ``arch``'s config with ``fields`` replaced at full
    width (``smoke_fields`` on its smoke variant), a ``kind`` ("train",
    "prefill" or "decode") step of ``batch`` rows and ``seq_len`` tokens
    (a decode step's cache slots), the MoE layers planned as ``lep`` (else
    the JAX package's plan) with the experts cut over ``expert_axes``
    (else the plan's EP axes), a prefill's MLA layers through the §4.3.1
    hybrid with the o-proj ``hybrid`` ("a2a" or "rs"; "" the plain
    prefill)."""
    arch: str
    fields: Dict[str, Any]
    kind: str
    batch: int
    seq_len: int
    smoke_batch: int
    smoke_seq_len: int
    smoke_fields: Dict[str, Any] = dataclasses.field(default_factory=dict)
    lep: Optional[Dict[str, Any]] = None
    expert_axes: Optional[Tuple[str, ...]] = None
    #: the batch rows whose logits (and greedy tokens) the full-width
    #: sharded decode or prefill step holds (:func:`held_rows`): "all";
    #: "one-block", the rows whose cache lies inside one sequence block of
    #: the mesh's ``model`` axis; "f32", none of the bf16 step's rows,
    #: every row of the same step run again in float32 (its caches and
    #: written rows are held in both)
    logits: str = "all"
    hybrid: str = ""
    #: a train step whose parameters and moments are held against the
    #: same step in float64 (:func:`truth`): no INT8 payload on its path,
    #: whose codes f32 and f64 may round one apart
    f64: bool = False
    #: a train step with an INT8 payload, held a second time with an
    #: unquantized payload on both sides (``quantize=False``) at the same
    #: tolerances: its layers before the first MoE layer run at other row
    #: counts than the reference's (:func:`row_groups`), and a product
    #: rounded apart there can move an INT8 code by one and the step by
    #: more than a tolerance, an unquantized payload only by a rounding
    f32_payload: bool = False


_F32, _BF16 = {"dtype": "float32"}, {"dtype": "bfloat16"}
#: capacity factor 8: with the train and decode cases' routing no token is
#: dropped at either world size, so the sharded LEP and the 1-D LEP at
#: world size 1 compute the same rows
_NO_DROP = {"capacity_factor": 8.0}
_NO_AUX = {"router_aux_loss_coef": 0.0}
#: chip_smoke's depth cut of R1: 3 dense MLA layers + 1 MoE layer of 256
_R1_CUT = {"num_layers": 4, "first_k_dense": 3}
#: the R1 prefills' capacity factor. The seed's random-weight router is
#: skewed at a prefill's token counts: over a 4 x 1024 draw one expert
#: takes up to 230 of a 512-token shard's picks (factor 14.3 needed where
#: 8 drops them) and 411 of a 1024-token one's (12.8). So the R1 prefills
#: run 2 rows (a 2 x 2 rank's shard: 512 tokens; the unsharded step's
#: groups: 1024) at factor 16; 4 rows at 16 would put the float32
#: reference's dispatch buffers (about 31 GB) beside its 56 GB of weights
#: on one 80 GB card
_PREFILL_NO_DROP = {"capacity_factor": 16.0}
#: train-r1's cut: one dense MLA layer, then two MoE layers (the second's
#: attention takes the rows LEP leaves on its token split), 12 of the 256
#: experts (3 a rank at 2 x 2), top-8 as R1's: 3.6 B parameters, 1.85 B of
#: them the embedding and the head, so that the unsharded float32 step
#: with its gradients and both AdamW moments fits one 80 GB card over the
#: whole batch, and so over the row groups ``scripts/
#: torch_parallel_nccl.py`` runs on rank 0's card; with 16 experts the
#: whole batch did not fit
_R1_TRAIN_CUT = {"num_layers": 3, "first_k_dense": 1, "num_experts": 12}
#: capacity factor 1.5: a token picks 8 distinct experts of 12, so an
#: expert takes at most every token of a shard, which a buffer of
#: t x 8 x 1.5 / 12 + 1 rows holds: no token is dropped at any world size,
#: with a fifth of the dispatch buffers _NO_DROP's factor 8 would give
#: the unsharded step
_R1_TRAIN_NO_DROP = {"capacity_factor": 1.5}
CASES: Dict[str, Case] = {
    # 4 of 36 layers; plain GQA, the projections through dtensor.linear
    "train-qwen3": Case("qwen3-8b", {"num_layers": 4, **_F32}, "train",
                        4, 1024, 4, 16, f64=True),
    # 4 of 16 layers; the training LEP plan (INT8 dispatch). The router's
    # balance loss is weighted 0: under LEP it is the mean over the token
    # shards of each shard's loss, as JAX's pmean inside shard_map takes
    # it, which the whole batch's at world size 1 is not
    "train-olmoe": Case("olmoe-1b-7b", {"num_layers": 4, **_F32, **_NO_DROP,
                                        **_NO_AUX},
                        "train", 4, 1024, 4, 16, {**_NO_DROP, **_NO_AUX},
                        f32_payload=True),
    # whole; the SSD scan's forward through mamba2._scan's local_map
    "train-mamba2": Case("mamba2-780m", _F32, "train", 4, 1024, 4, 64,
                         f64=True),
    # chip_smoke's depth cut: 3 dense MLA layers + 1 MoE layer of 256
    # Its bf16 logits move about as far from the unsharded step's as the
    # reference's own move with its caches nudged by one part in 1e7 (two
    # bf16 roundings of 4 layers apart): they are held through the same
    # step in float32
    "decode-r1": Case("deepseek-r1", {**_R1_CUT, **_BF16, **_NO_DROP},
                      "decode", 8, 2048, 4, 16, _NO_DROP, logits="f32"),
    # whole; redundancy 2 on full-mesh EP with the experts cut over
    # "model" alone, as the production mesh cuts OLMoE's 64 experts: each
    # rank receives the experts its slots lack (a permute). A row whose
    # cache spans two sequence blocks merges their partial softmaxes, a
    # rounding that 16 bf16 MoE layers carry past TOL of the logits (as
    # they carry the reference's caches nudged by one part in 1e7 much
    # further); the rows inside one block equal the unsharded step's
    "decode-olmoe": Case("olmoe-1b-7b", {**_BF16, **_NO_DROP}, "decode",
                         8, 2048, 4, 16, _NO_DROP,
                         lep={"ep_axes": ("data", "model"), "redundancy": 2,
                              "ffn_shard_axis": None},
                         expert_axes=("model",), logits="one-block"),
    # The prefills, bf16 with float32 caches, their logits held through
    # the same step in float32 (as decode-r1's). R1: the depth cut of
    # decode-r1 (the same cut at smoke width: 4 MLA layers), LEP's serving
    # plan with INT8 dispatch; plain, then through the hybrid
    "prefill-r1": Case("deepseek-r1", {**_R1_CUT, **_BF16,
                                       **_PREFILL_NO_DROP},
                       "prefill", 2, 1024, 4, 16, {**_R1_CUT, **_NO_DROP},
                       logits="f32"),
    "prefill-r1-a2a": Case("deepseek-r1", {**_R1_CUT, **_BF16,
                                           **_PREFILL_NO_DROP},
                           "prefill", 2, 1024, 4, 16,
                           {**_R1_CUT, **_NO_DROP}, logits="f32",
                           hybrid="a2a"),
    "prefill-r1-rs": Case("deepseek-r1", {**_R1_CUT, **_BF16,
                                          **_PREFILL_NO_DROP},
                          "prefill", 2, 1024, 4, 16,
                          {**_R1_CUT, **_NO_DROP}, logits="f32",
                          hybrid="rs"),
    # 4 of 36 layers; GQA writing its K/V cache (8 K/V heads over model)
    "prefill-qwen3": Case("qwen3-8b", {"num_layers": 4, **_BF16}, "prefill",
                          4, 1024, 4, 16, logits="f32"),
    # whole; the SSD scan per head slice, the final state and conv window
    "prefill-mamba2": Case("mamba2-780m", _BF16, "prefill", 4, 1024, 4, 64,
                           logits="f32"),
    # R1 with LEP in a train step (the training plan, INT8 dispatch), its
    # output left on the token split from the first MoE layer on: the cut
    # of _R1_TRAIN_CUT (at smoke width its depth: dense, MoE, MoE), the
    # balance loss weighted 0 as train-olmoe's
    "train-r1": Case("deepseek-r1", {**_R1_TRAIN_CUT, **_F32,
                                     **_R1_TRAIN_NO_DROP, **_NO_AUX},
                     "train", 4, 1024, 4, 16,
                     {"num_layers": 3, "first_k_dense": 1, **_NO_DROP,
                      **_NO_AUX}, f32_payload=True),
}


def case_config(name: str, smoke: bool = False,
                dtype: Optional[str] = None,
                layers: Optional[int] = None) -> ModelConfig:
    """Case ``name``'s config (its weights in ``dtype``, its depth cut to
    ``layers``, where given)."""
    case = CASES[name]
    if smoke:
        cfg = dataclasses.replace(smoke_variant(get_config(case.arch)),
                                  **case.smoke_fields)
    else:
        cfg = dataclasses.replace(get_config(case.arch), **case.fields)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def held_rows(name: str, shape: InputShape, n_model: int
              ) -> Optional[list]:
    """The rows of case ``name``'s full-width decode step whose logits
    :func:`compare` holds (``Case.logits``) over a mesh of ``n_model``
    ranks on ``model``: None for every row."""
    case = CASES[name]
    if case.logits == "all":
        return None
    if case.logits == "f32":
        return []
    block = shape.seq_len // n_model
    lens = [min(n, shape.seq_len) for n in DECODE_LENS][:shape.global_batch]
    return [b for b, n in enumerate(lens)
            if min(n + 1, shape.seq_len) <= block]


def case_shape(name: str, smoke: bool = False,
               batch: Optional[int] = None,
               seq_len: Optional[int] = None) -> InputShape:
    case = CASES[name]
    return InputShape(name, seq_len or (case.smoke_seq_len if smoke
                                        else case.seq_len),
                      batch or (case.smoke_batch if smoke else case.batch),
                      case.kind)


def case_step(name: str, mesh, device, *, smoke: bool = False, seed: int = 0,
              params=None, cfg: Optional[ModelConfig] = None,
              shape: Optional[InputShape] = None, n_micro: int = 1,
              inputs: Optional[Dict[str, Any]] = None,
              dtype: Optional[torch.dtype] = None,
              quantize: Optional[bool] = None):
    """(cfg, shape, step, its arguments) of case ``name`` over ``mesh``
    (None: unsharded, a hybrid case's prefill plain) on ``device``:
    ``dryrun.build_step`` with the case's plan (its payload quantized or
    not as ``quantize`` says, where given), float32 caches as a
    serving engine keeps them, the decode lengths of DECODE_LENS
    (SMOKE_DECODE_LENS, or cut to the batch), ``n_micro`` groups of rows
    and ``inputs`` where given. With ``dtype`` (float64, on the CPU) the
    step computes in it: its weights drawn as the case's own step draws
    them, then widened (each one as it is placed), its caches and moments
    ``dtype``."""
    from repro_torch.train.optimizer import OptConfig

    case = CASES[name]
    cfg = cfg or case_config(name, smoke)
    shape = shape or case_shape(name, smoke)
    lens = SMOKE_DECODE_LENS if smoke else DECODE_LENS
    lens = [min(n, shape.seq_len) for n in lens][:shape.global_batch]
    cache_dtype = torch.float32
    if dtype is not None:
        from repro_torch.models.model import init_params

        if params is None and mesh is None:
            params = init_params(cfg, seed=seed, device=device).to(dtype)
        elif params is None:
            params = dryrun.sharded_model(
                cfg, mesh, train=case.kind == "train", device=device,
                seed=seed, expert_axes=case.expert_axes, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=str(dtype).split(".")[-1])
        cache_dtype = dtype
    step, args = dryrun.build_step(
        cfg, shape, mesh, cache_dtype, device=device, seed=seed,
        params=params, inputs=inputs,
        cache_len=lens if case.kind == "decode" else None,
        lep=case.lep if quantize is None else
        {**(case.lep or {}), "quantize": quantize},
        expert_axes=case.expert_axes,
        opt_cfg=OptConfig(**TRAIN_OPT), n_micro=n_micro,
        hybrid=case.hybrid if mesh is not None else "")
    return cfg, shape, step, args


def reference(name: str, device, *, n_micro: int = 1, smoke: bool = False,
              seed: int = 0, shape: Optional[InputShape] = None,
              params=None, cfg: Optional[ModelConfig] = None,
              nudge: float = 0.0, inputs: Optional[Dict[str, Any]] = None,
              dtype: Optional[torch.dtype] = None,
              quantize: Optional[bool] = None
              ) -> Dict[str, torch.Tensor]:
    """:func:`step_results` (where they are) of case ``name``'s step
    unsharded on ``device`` over ``n_micro`` groups of rows: as many as
    :func:`row_groups` gives, the same function with each product at a
    rank's row count (an INT8 code turns the rounding of a product run at
    other row counts into more than a tolerance). With ``nudge``, a
    decode step's float caches are first scaled by 1 + nudge x N(0, 1),
    element by element (seeded): a rounding of its inputs. ``dtype`` and
    ``quantize`` as :func:`case_step` takes them."""
    _, shape, step, args = case_step(name, None, device, smoke=smoke,
                                     seed=seed, params=params, cfg=cfg,
                                     shape=shape, n_micro=n_micro,
                                     inputs=inputs, dtype=dtype,
                                     quantize=quantize)
    if nudge:
        gen = torch.Generator(device=device).manual_seed(seed + 2)
        for t in named_leaves(args[2]).values():
            if t.dtype.is_floating_point:
                t.mul_(1 + nudge * torch.randn(t.shape, generator=gen,
                                               device=device))
    return step_results(shape.kind, step(*args), to=None)


def row_groups(name: str, n_data: int, n_model: int,
               smoke: bool = False) -> int:
    """The groups of rows :func:`reference` runs case ``name``'s step
    over for a ``n_data`` x ``n_model`` mesh: one a rank of ``data``,
    whose rows the step's products take; for a training step with LEP
    whose token split falls on whole rows one a rank of the mesh, whose
    rows its products take from the first MoE layer on (LEP's output
    left on its token split, ``core/lep.py::_on_token_split``); the
    layers before it run at a data rank's rows on the mesh
    (tensor-parallel) and at a mesh rank's here."""
    cfg = case_config(name, smoke)
    n = n_data * n_model
    if CASES[name].kind == "train" and cfg.is_moe and n_model > 1 \
            and case_shape(name, smoke).global_batch % n == 0:
        return n
    return n_data


def truth(name: str, draw_on, *, n_micro: int = 1, smoke: bool = False,
          seed: int = 0, shape: Optional[InputShape] = None
          ) -> Dict[str, torch.Tensor]:
    """:func:`reference` in float64 on the host's CPU: the same unsharded
    step over the same row groups, its weights and inputs those the
    float32 step draws from ``seed`` (drawn on ``draw_on``, as the card
    draws them, then widened to float64 on the CPU), its activations,
    gradients and moments float64. Against it :func:`compare` tells what a
    partition adds from what float32 rounding of the same function
    gives."""
    from repro_torch.models.model import init_params

    cfg = case_config(name, smoke)
    shape = shape or case_shape(name, smoke)
    params = init_params(cfg, seed=seed, device=draw_on).to(
        "cpu", torch.float64)
    # build_step draws a step's inputs from seed + 1
    inputs = {k: v.cpu() for k, v in dryrun.step_inputs(
        cfg, shape, draw_on, seed + 1).items()}
    return reference(name, "cpu", n_micro=n_micro, smoke=smoke, seed=seed,
                     shape=shape, params=params, inputs=inputs,
                     dtype=torch.float64)


def run_counted(step, args) -> Tuple[Any, Dict[str, int]]:
    """The step's output and the collective bytes by kind (and their
    count) that this rank issued running it, counted as the dry run
    counts a traced step."""
    from torch.distributed.tensor.experimental import implicit_replication

    with CollectiveCounter() as counter, implicit_replication():
        out = step(*args)
    return out, dict(counter.counts)


def named_leaves(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tensor leaves of a step's output by path: a ``Model``'s
    parameters by name, dicts, NamedTuples and sequences."""
    if isinstance(tree, torch.nn.Module):
        return {prefix + n: p for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): tree} \
            if isinstance(tree, torch.Tensor) else {}
    out = {}
    for k, v in items:
        out.update(named_leaves(v, f"{prefix}{k}/"))
    return out


def step_results(kind: str, out: Any, keep: bool = True, to="cpu"
                 ) -> Dict[str, torch.Tensor]:
    """What a step is held to, each leaf whole (a DTensor gathered: every
    rank of its mesh calls this) and moved ``to`` a device (None: where it
    is), or nothing where not ``keep``: a train step's ``loss`` and
    ``grad_norm``, every parameter (``param/<name>``) and both moments
    (``mu/<name>``, ``nu/<name>``) in the parameters' order; a prefill or
    decode step's ``logits`` and every float cache buffer
    (``cache/<path>``: a prefill writes them from slot 0), and a decode
    step's rows it wrote into each latent or K/V buffer
    (``written/<path>``: at each row's length before the step, where
    that is inside the buffer)."""
    def whole(v):
        v = v.full_tensor() if hasattr(v, "full_tensor") else v
        return v.detach()

    leaves: Dict[str, Any] = {}
    if kind == "train":
        params, opt, metrics = out
        names = [n for n, _ in params.named_parameters()]
        leaves = {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"]}
        leaves.update({f"param/{n}": p for n, p in
                       params.named_parameters()})
        for moment, values in (("mu", opt.mu), ("nu", opt.nu)):
            leaves.update({f"{moment}/{n}": v
                           for n, v in zip(names, values)})
    else:
        logits, caches = out
        leaves = {"logits": logits}
        tree = named_leaves(caches)
        for k, v in tree.items():
            if not v.dtype.is_floating_point:
                continue
            leaves[f"cache/{k}"] = v
            if kind != "decode":
                continue
            parent, _, last = k.rpartition("/")
            length = f"{parent}/length" if parent else "length"
            if last in ("mla", "k", "v") and length in tree:
                v = whole(v)
                rows = [v[:, b, p] for b, p in enumerate(
                    (whole(tree[length]) - 1).tolist())
                    if 0 <= p < v.shape[2]]
                if rows:
                    leaves[f"written/{k}"] = torch.stack(rows, dim=1)
    got = {}
    for k, v in leaves.items():
        v = whole(v)
        if keep:
            got[k] = v if to is None else v.to(to)
    return got


def _err(got: torch.Tensor, want: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> float:
    """max |got - want| (over ``mask``) over max |want|."""
    return _worst(got, want, mask)[0]


#: elements :func:`_worst` takes at a time, so that its float64
#: differences stay small beside the results it compares (train-r1's
#: 0.93 B-element embedding is 7.4 GB a float64 copy, which does not fit
#: one card beside the unsharded step's results)
_CHUNK = 1 << 24


def _worst(got: torch.Tensor, want: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> Tuple[float, float]:
    """(max |got - want| over max |want|, |want| there over max |want|),
    over ``mask``, in float64, the first such element where several
    tie."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    got, want = got.reshape(-1), want.reshape(-1)
    mask = None if mask is None else mask.reshape(-1)
    worst = at = None
    for lo in range(0, want.numel(), _CHUNK):
        part = want[lo:lo + _CHUNK].double()
        diff = (got[lo:lo + _CHUNK].to(want.device).double() - part).abs()
        ref = part.abs()
        if mask is not None:
            keep = mask[lo:lo + _CHUNK].to(want.device)
            diff, ref = diff[keep], ref[keep]
        if not diff.numel():
            continue
        i = diff.argmax()
        err = diff[i].item()
        if worst is None or err > worst or err != err:
            worst, at = err, ref[i].item()
            if err != err:              # NaN: the comparison fails
                break
    if worst is None:
        return 0.0, 0.0
    scale = max(want.abs().max().double().item(), 1e-30)
    return worst / scale, at / scale


#: the quantities :func:`compare` gates, by kind, with their tolerance
#: (None: the caller's ``tol``); "train-f64", a train step given its
#: float64 truth
GATED = {"train": {"loss_rel_err": LOSS_RTOL, "grad_norm_rel_err": LOSS_RTOL,
                   "param_max_err": STEP_TOL, "mu_max_err": STEP_TOL,
                   "nu_max_err": STEP_TOL},
         "train-f64": {"loss_rel_err": LOSS_RTOL,
                       "grad_norm_rel_err": LOSS_RTOL,
                       "param_f64_excess": STEP_TOL,
                       "mu_f64_excess": STEP_TOL,
                       "nu_f64_excess": STEP_TOL},
         "prefill": {"logits_max_err": None, "cache_max_err": None},
         "decode": {"logits_max_err": None, "cache_max_err": None,
                    "written_max_err": None}}


def compare(kind: str, got: Dict[str, torch.Tensor],
            want: Dict[str, torch.Tensor], tol: float,
            rows: Optional[Sequence[int]] = None,
            truth: Optional[Dict[str, torch.Tensor]] = None
            ) -> Dict[str, Any]:
    """``got`` (the sharded step's :func:`step_results`) against ``want``
    (the unsharded step's, :func:`reference`): the worst divergence of
    each kind and ``ok``, every quantity at a fixed tolerance. A train
    step holds its loss and global gradient norm within LOSS_RTOL, both
    moments within STEP_TOL of each leaf's largest value and each
    parameter within STEP_TOL where the reference's first moment is clear
    of 0 (|mu| above STEP_TOL of its largest: with no warmup the step
    moves a weight by about lr x sign(g), whose sign is either where g is
    0). Given ``truth`` (the same step in float64, :func:`truth`) it holds
    each parameter and moment to it instead: err(got, truth) at most
    err(want, truth) + STEP_TOL, each err the max |difference| over the
    leaf's largest |truth| (parameters where truth's |mu| is clear of
    STEP_TOL of its largest), so that what the partition adds beyond
    float32 rounding of the same function is held at a fixed tolerance;
    the fixed comparison with ``want`` is still reported. A prefill or
    decode step holds its caches (and a decode step the rows it wrote)
    within ``tol`` of the reference's largest value and, on the batch rows
    ``rows`` (None: every row; :func:`held_rows`), its logits within
    ``tol`` of their largest and its greedy tokens equal wherever the
    reference's top-2 margin exceeds ``tol`` of that largest logit.

    Beside them, for a reader: a train step's leaves past STEP_TOL (at
    most 8 a part, worst first), each with its error, its largest |value|
    over the part's largest (``scale``) and the reference's |value| where
    the error is worst over the leaf's largest (``at``), and, given
    ``truth``, ``f64``: each part's worst error against it of the sharded
    and the unsharded step and the leaves whose excess passes STEP_TOL; a
    prefill or decode step's logits error on every batch row and the cache
    leaf whose error is the largest (``cache_worst``), with its error on
    each of its layers."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"leaves differ: "
                             f"{sorted(set(got) ^ set(want))[:8]}")
    row: Dict[str, Any] = {}
    if kind == "train":
        rel = lambda k: abs(got[k].item() - want[k].item()) / max(  # noqa
            abs(want[k].item()), 1e-30)
        row["loss"], row["loss_ref"] = got["loss"].item(), want["loss"].item()
        row["loss_rel_err"] = rel("loss")
        row["grad_norm"] = got["grad_norm"].item()
        row["grad_norm_rel_err"] = rel("grad_norm")
        errs = {"param": {}, "mu": {}, "nu": {}}
        for k in got:
            part = k.split("/")[0]
            if part not in errs:
                continue
            mask = None
            if part == "param":
                mu = want["mu/" + k[len("param/"):]].abs()
                mask = mu > STEP_TOL * max(mu.max().item(), 1e-30)
            errs[part][k] = _worst(got[k], want[k], mask)
        row.update({f"{p}_max_err": max(e[0] for e in errs[p].values())
                    for p in errs})
        over = {}
        for p, e in errs.items():
            top = max(want[k].abs().max().item() for k in e) or 1e-30
            worst = sorted(((k, v) for k, v in e.items() if v[0] > STEP_TOL),
                           key=lambda kv: -kv[1][0])[:8]
            over[p] = {k: {"err": v[0], "at": v[1],
                           "scale": want[k].abs().max().item() / top}
                       for k, v in worst}
        row["leaves_over"] = over
        if truth is not None:
            row.update(_against_truth(got, want, truth))
    else:
        n = want["logits"].shape[0]
        held = list(range(n)) if rows is None else list(rows)
        row["logits_err_by_row"] = [_err(a, b) for a, b in zip(
            got["logits"], want["logits"])]
        row["logits_rows_held"] = held
        row["logits_max_err"] = _err(got["logits"][held],
                                     want["logits"][held])
        ref = want["logits"][held].float()
        if held:
            top2 = ref.topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > tol * ref.abs().max()
            same = got["logits"][held].to(ref.device).float().argmax(-1) \
                == ref.argmax(-1)
        else:
            clear = same = torch.zeros(0, dtype=torch.bool)
        caches = {k: _err(got[k], want[k]) for k in got
                  if k.startswith("cache/")}
        row["cache_max_err"] = max(caches.values(), default=0.0)
        worst = row["cache_worst"] = max(caches, key=caches.get, default=None)
        if worst is not None:
            # its error layer by layer (a stacked leaf's first dimension),
            # of the whole leaf's largest |value|
            scale = max(want[worst].double().abs().max().item(), 1e-30)
            row["cache_worst_by_layer"] = [
                (a.to(b.device).double() - b.double()).abs().max().item()
                / scale for a, b in zip(got[worst], want[worst])]
        if kind == "decode":
            row["written_max_err"] = max((_err(got[k], want[k]) for k in got
                                          if k.startswith("written/")),
                                         default=0.0)
        row["greedy_checked"] = int(clear.sum())
        row["greedy_equal"] = bool(same[clear].all())
    gated = GATED["train-f64" if truth is not None else kind]
    limits = {k: tol if t is None else t for k, t in gated.items()}
    row["over"] = [k for k, limit in limits.items() if row[k] > limit]
    row["ok"] = not row["over"] and row.get("greedy_equal", True)
    return row


def _against_truth(got: Dict[str, torch.Tensor],
                   want: Dict[str, torch.Tensor],
                   truth: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """:func:`compare`'s float64 gate of a train step: each part's worst
    excess err(got, truth) - err(want, truth) (``<part>_f64_excess``) and,
    under ``f64``, each part's worst error of either step against the
    truth and the leaves whose excess passes STEP_TOL (at most 8 a part,
    worst first)."""
    out: Dict[str, Any] = {}
    f64: Dict[str, Any] = {"sharded_max_err": {}, "unsharded_max_err": {},
                           "leaves_over": {}}
    for part in ("param", "mu", "nu"):
        errs = {}
        for k in (k for k in truth if k.startswith(part + "/")):
            mask = None
            if part == "param":
                mu = truth["mu/" + k[len("param/"):]].abs()
                mask = mu > STEP_TOL * max(mu.max().item(), 1e-30)
            errs[k] = (_err(got[k], truth[k], mask),
                       _err(want[k], truth[k], mask))
        out[f"{part}_f64_excess"] = max(s - u for s, u in errs.values())
        f64["sharded_max_err"][part] = max(s for s, _ in errs.values())
        f64["unsharded_max_err"][part] = max(u for _, u in errs.values())
        worst = sorted(((k, e) for k, e in errs.items()
                        if e[0] - e[1] > STEP_TOL),
                       key=lambda kv: kv[1][1] - kv[1][0])[:8]
        f64["leaves_over"][part] = {k: {"sharded": s, "unsharded": u}
                                    for k, (s, u) in worst}
    out["f64"] = f64
    return out


def compare_f64(kind: str, got: Dict[str, torch.Tensor],
                want: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The float64 partition check: ``got`` (the sharded step's
    :func:`step_results`, in float64) against ``want`` (the same step
    unsharded in float64, :func:`reference` with ``dtype``), every
    quantity at F64_TOL: a train step's loss and global gradient norm
    (relative) and every parameter and both moments (of each leaf's
    largest |value|); a prefill or decode step's logits on every row,
    every float cache leaf (and a decode step's written rows) of its
    largest, and its greedy tokens equal on every row. Returns each
    part's worst error (``errs``), the worst leaf (``worst``,
    ``worst_err``), the logits error and greedy equality by row, ``over``
    (the leaves past F64_TOL) and ``ok``; for a train step, printed
    beside (never a limit), the parameters' worst error over the elements
    whose reference first moment is above 1e-8, 1e-6 and 1e-4 of its
    leaf's largest, and the first moment where the worst parameter parts
    (``worst_mu_at``, of its largest)."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"leaves differ: "
                             f"{sorted(set(got) ^ set(want))[:8]}")
    errs: Dict[str, float] = {}
    row: Dict[str, Any] = {"tol": F64_TOL}
    for k in got:
        if k in ("loss", "grad_norm"):
            errs[k] = abs(got[k].item() - want[k].item()) / max(
                abs(want[k].item()), 1e-300)
        else:
            errs[k] = _err(got[k], want[k])
    if kind != "train":
        logits, ref = got["logits"].to(want["logits"].device), want["logits"]
        row["logits_err_by_row"] = [_err(a, b) for a, b in zip(logits, ref)]
        same = logits.argmax(-1) == ref.argmax(-1)
        row["greedy_equal_by_row"] = same.reshape(len(same), -1).all(
            -1).tolist()
    parts: Dict[str, float] = {}
    for k, e in errs.items():
        part = k.split("/")[0]
        parts[part] = max(parts.get(part, 0.0), e)
    row["errs"] = parts
    row["worst"] = max(errs, key=errs.get)
    row["worst_err"] = errs[row["worst"]]
    if kind == "train":
        # the parameters' worst error over the elements whose reference
        # first moment is above each fraction of its leaf's largest
        # (printed, never a limit): an error confined to the small moments
        # is AdamW's step normalizing a gradient that carries the rounding
        # of the sums that made it
        row["param_err_where_mu_above"] = {}
        for floor in (1e-8, 1e-6, 1e-4):
            worst = 0.0
            for k in (k for k in got if k.startswith("param/")):
                mu = want["mu/" + k[len("param/"):]].abs()
                worst = max(worst, _err(got[k], want[k], mu > floor * max(
                    mu.max().item(), 1e-300)))
            row["param_err_where_mu_above"][f"{floor:g}"] = worst
    if row["worst"].startswith("param/"):
        # the reference's first moment (0.1 of the clipped gradient) where
        # the parameter parts most, of that moment's largest: near 0, the
        # step lr x m / (sqrt(v) + eps) turns on the gradient's rounding
        k = row["worst"][len("param/"):]
        at = (got["param/" + k].to(want["param/" + k].device).double()
              - want["param/" + k].double()).abs().flatten().argmax()
        mu = want["mu/" + k].double().abs().flatten()
        row["worst_mu_at"] = mu[at].item() / max(mu.max().item(), 1e-300)
    row["over"] = sorted(k for k, e in errs.items() if e > F64_TOL)
    row["ok"] = not row["over"] and all(row.get("greedy_equal_by_row", []))
    return row


# ---------------------------------------------------------------------------
# The INT8 LEP train steps' discrete choices: recorded, gated, replayed
# ---------------------------------------------------------------------------

#: the choices gate (:func:`compare_choices`). A code may lie one from the
#: reference's (the token's element rounded apart near a half-integer of
#: x / scale). A scale is the row's max|x| / 127, and float32 rounding of
#: the layers before moves max|x| by parts in 1e-7 to 1e-5 (train-r1: 4.5e-7
#: at smoke width on the CPU, 4.5e-6 at full width on four H100s): within
#: SCALE_RTOL relative, which moves no code by more than 127 x SCALE_RTOL
#: = 0.013 of one. A pick may flip where the
#: reference's probabilities of the two experts lie within PICK_RTOL of
#: the token's largest probability (router logits carrying the same
#: rounding part by about as much). A partition fault (a row on the wrong
#: rank, a token split off by a row) moves codes by tens, scales by parts
#: in 10, and flips picks whose probabilities part by parts in 100.
CODE_APART = 1
SCALE_RTOL = 1e-4
PICK_RTOL = 1e-4


def moe_layers(cfg: ModelConfig) -> int:
    """The MoE layers of ``cfg``: every layer from ``first_k_dense`` on."""
    return cfg.num_layers - cfg.first_k_dense if cfg.is_moe else 0


def _dest_rows(top_i: torch.Tensor, n_slots: int, n_rows: int
               ) -> torch.Tensor:
    """The dispatch buffer's row of each pick of ``top_i`` (T, K) over
    ``n_slots`` slots in a buffer of ``n_rows`` (``core/lep.py``'s
    FusedDispatch packing, redundancy 1); every pick must be kept."""
    from repro_torch.models import moe

    cap = n_rows // n_slots
    pos, kept = moe.dispatch_indices(top_i, n_slots, cap)
    if not bool(kept.all()):
        raise AssertionError("a pick was dropped: the choices are held "
                             "where every pick has a slot")
    return top_i * cap + pos


@contextlib.contextmanager
def record_choices(where: Callable[[int, ModelConfig], Tuple[int, int]],
                   replay: Optional[Dict[int, Dict[str, torch.Tensor]]] = None
                   ) -> Iterator[Dict[int, Dict[int, Dict[str, torch.Tensor]]]]:
    """Inside the block, LEP's discrete choices in each MoE layer's call,
    recorded by (layer, block) as ``where(call index, cfg)`` names them:
    the router's top-k picks (``models/moe.py`` ``route``) and each token's
    INT8 codes and scale (``core/lep.py`` ``_quantize_rows``: the code row
    of its first pick's dispatch row), ``{layer: {block: {"top_i", "codes",
    "scale"}}}``, a block's rows in order. Both functions are patched
    inside the block and restored after it; a training step with LEP and
    redundancy 1 (in-place dispatch, no drop) is what it records.

    With ``replay`` (:func:`stitch_choices` of another step's choices, by
    global row) the step takes those choices in place of its own: each
    call's picks (the combine weights its own probabilities of those
    experts, renormalized as ``route`` does) and its tokens' codes and
    scales, block b's rows being rows b x T .. (b + 1) x T of the global
    ones. What it records is then its own choices before they were
    replaced, with its router probabilities (``probs``)."""
    from repro_torch import dtensor as dt
    from repro_torch.core import lep
    from repro_torch.models import moe
    from repro_torch.models.layers import widened

    quantize_rows, route = lep._quantize_rows, moe.route
    rec: Dict[int, Dict[int, Dict[str, torch.Tensor]]] = {}
    calls = [0]
    pending = []

    def routed(router_w, x, cfg):
        layer, block = where(calls[0], cfg)
        calls[0] += 1
        top_i, top_p, aux = route(router_w, x, cfg)
        entry = rec.setdefault(layer, {}).setdefault(block, {})
        entry["top_i"] = top_i.detach().clone()
        if replay is not None:
            probs = dt.softmax(widened(x) @ router_w, dim=-1)
            entry["probs"] = probs.detach().clone()
            t, e = x.shape[0], cfg.num_experts
            top_i = replay[layer]["top_i"][block * t:(block + 1) * t].to(
                x.device)
            top_p = probs.gather(-1, top_i)
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
            frac = torch.nn.functional.one_hot(top_i, e).to(
                probs.dtype).sum(dim=1).mean(dim=0)
            aux = e * (frac * probs.mean(dim=0)).sum()
        pending.append((layer, block, top_i, cfg.num_experts))
        return top_i, top_p, aux

    def quantized(x, pack):
        if not pack:
            raise ValueError("the choices are recorded from a packed "
                             "payload (make_lep_moe_fn's pack_scales)")
        out = quantize_rows(x, pack)
        layer, block, top_i, n_slots = pending.pop()
        d = x.shape[-1]
        dest = _dest_rows(top_i, n_slots, x.shape[0])
        first = dest[:, 0]
        entry = rec[layer][block]
        entry["codes"] = out[first, :d]
        entry["scale"] = out[first, d:].contiguous().view(
            torch.float32).reshape(-1)
        if replay is not None:
            t, k = top_i.shape
            rows = slice(block * t, (block + 1) * t)
            at = dest.reshape(-1)
            out[at, :d] = replay[layer]["codes"][rows].to(
                out.device).repeat_interleave(k, 0)
            out[at, d:] = replay[layer]["scale"][rows].to(
                out.device).repeat_interleave(k, 0).reshape(-1, 1).view(
                torch.int8)
        return out

    lep._quantize_rows, moe.route = quantized, routed
    try:
        yield rec
    finally:
        lep._quantize_rows, moe.route = quantize_rows, route


def stitch_choices(rec: Dict[int, Dict[int, Dict[str, torch.Tensor]]]
                   ) -> Dict[int, Dict[str, torch.Tensor]]:
    """:func:`record_choices`' record (or several ranks' records merged) by
    layer over the global rows: each leaf's blocks joined in block
    order."""
    out = {}
    for layer, blocks in sorted(rec.items()):
        order = sorted(blocks)
        if order != list(range(len(order))):
            raise AssertionError(f"layer {layer}: blocks {order}")
        out[layer] = {k: torch.cat([blocks[b][k] for b in order])
                      for k in blocks[order[0]]}
    return out


def gather_choices(rec) -> Dict[int, Dict[str, torch.Tensor]]:
    """Every rank's :func:`record_choices` record, merged and stitched on
    the host (every rank calls this)."""
    import torch.distributed as dist

    mine = {layer: {b: {k: v.cpu() for k, v in e.items()}
                    for b, e in blocks.items()}
            for layer, blocks in rec.items()}
    joined = [None] * dist.get_world_size()
    dist.all_gather_object(joined, mine)
    merged: Dict[int, Dict[int, Dict[str, torch.Tensor]]] = {}
    for part in joined:
        for layer, blocks in part.items():
            merged.setdefault(layer, {}).update(blocks)
    return stitch_choices(merged)


def mesh_block(mesh) -> Callable[[int, ModelConfig], Tuple[int, int]]:
    """``record_choices``' ``where`` of a step over ``mesh`` whose training
    LEP leaves the rows on its token split: call c is MoE layer c, the
    rank's rows the block of its place in the mesh (mesh order, as
    ``core/lep.py::_on_token_split`` cuts them)."""
    coord = mesh.get_coordinate()
    block = 0
    for i, c in enumerate(coord):
        block = block * mesh.size(i) + c
    return lambda c, cfg: (c, block)


def group_block(c: int, cfg: ModelConfig) -> Tuple[int, int]:
    """``record_choices``' ``where`` of :func:`reference` over row groups:
    the groups run one after another, each through every MoE layer."""
    n = moe_layers(cfg)
    return c % n, c // n


def compare_choices(got: Dict[int, Dict[str, torch.Tensor]],
                    want: Dict[int, Dict[str, torch.Tensor]]
                    ) -> Dict[str, Any]:
    """The sharded step's choices (``got``, :func:`gather_choices`) against
    the reference's own (``want``, recorded by :func:`replay`: each layer's
    own choices from inputs that carry ``got``'s choices of the layers
    before, so that only float32 rounding of the same function parts
    them), by layer and global row: every code within CODE_APART of
    ``want``'s, every scale within SCALE_RTOL of it (relative), and every
    flipped pick one whose expert ``want`` ranked within PICK_RTOL of the
    token's largest probability of the expert it picked instead (for a
    token, the largest probability of an expert ``want`` picked and
    ``got`` did not, less the smallest of one ``got`` picked and ``want``
    did not). Reported: the share of codes one apart, the flipped picks
    and their tokens, the worst of each, by layer and over all, ``over``
    (the gated quantities past their bound) and ``ok``."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"layers {sorted(got)} != {sorted(want)}")
    layers = []
    for layer in sorted(want):
        g, w = got[layer], want[layer]
        for k in ("top_i", "codes", "scale"):
            if g[k].shape != w[k].shape:
                raise AssertionError(f"layer {layer} {k}: shape "
                                     f"{tuple(g[k].shape)} != "
                                     f"{tuple(w[k].shape)}")
        apart = (g["codes"].to(w["codes"].device).short()
                 - w["codes"].short()).abs()
        s_want = w["scale"].double()
        scale_err = ((g["scale"].to(s_want.device).double() - s_want).abs()
                     / s_want).max().item()
        probs = w["probs"].double()
        e = probs.shape[-1]
        onehot = torch.nn.functional.one_hot
        picked_w = onehot(w["top_i"], e).sum(1) > 0
        picked_g = onehot(g["top_i"].to(w["top_i"].device), e).sum(1) > 0
        lost, gained = picked_w & ~picked_g, picked_g & ~picked_w
        flipped = lost.any(-1)
        margin = 0.0
        if bool(flipped.any()):
            hi = torch.where(lost, probs, -1.0).amax(-1)
            lo = torch.where(gained, probs, 2.0).amin(-1)
            rel_margin = (hi - lo) / probs.amax(-1)
            margin = rel_margin[flipped].max().item()
        layers.append({"layer": layer, "tokens": int(w["top_i"].shape[0]),
                       "codes_max_apart": int(apart.max()),
                       "codes_one_apart_share":
                           (apart == 1).double().mean().item(),
                       "scale_max_rel_err": scale_err,
                       "picks_flipped": int(gained.sum()),
                       "tokens_flipped": int(flipped.sum()),
                       "flip_max_margin": margin})
    row: Dict[str, Any] = {
        "codes_max_apart": max(r["codes_max_apart"] for r in layers),
        "codes_one_apart_share": sum(
            r["codes_one_apart_share"] for r in layers) / len(layers),
        "scale_max_rel_err": max(r["scale_max_rel_err"] for r in layers),
        "picks_flipped": sum(r["picks_flipped"] for r in layers),
        "tokens_flipped": sum(r["tokens_flipped"] for r in layers),
        "flip_max_margin": max(r["flip_max_margin"] for r in layers),
        "bounds": {"codes_max_apart": CODE_APART,
                   "scale_max_rel_err": SCALE_RTOL,
                   "flip_max_margin": PICK_RTOL},
        "by_layer": layers}
    row["over"] = [k for k, bound in row["bounds"].items() if row[k] > bound]
    row["ok"] = not row["over"]
    return row


def replay(name: str, device, choices: Dict[int, Dict[str, torch.Tensor]],
           *, n_micro: int = 1, smoke: bool = False, seed: int = 0
           ) -> Tuple[Dict[str, torch.Tensor],
                      Dict[int, Dict[str, torch.Tensor]]]:
    """:func:`reference` of case ``name`` over ``n_micro`` row groups with
    the sharded step's ``choices`` (:func:`gather_choices`) in place of its
    own (:func:`record_choices`' ``replay``): (its :func:`step_results`,
    its own choices, with their router probabilities). What is left between
    it and the sharded step is float32 rounding of one function, which
    :func:`compare` holds at its fixed tolerances."""
    with record_choices(group_block, replay=choices) as rec:
        want = reference(name, device, n_micro=n_micro, smoke=smoke,
                         seed=seed)
    return want, stitch_choices(rec)


def hold_choices(name: str, device, got: Dict[str, torch.Tensor],
                 choices: Dict[int, Dict[str, torch.Tensor]], *,
                 n_micro: int, smoke: bool = False, seed: int = 0
                 ) -> Dict[str, Any]:
    """The gates of an INT8 LEP train step (``got``, the sharded step's
    :func:`step_results`; ``choices``, its :func:`gather_choices`):
    ``choices``, :func:`compare_choices` against the replayed reference's
    own; ``replay``, :func:`compare` against the replayed reference at the
    fixed tolerances; and the replay's seconds (``replay_s``)."""
    import time

    t0 = time.perf_counter()
    want, own = replay(name, device, choices, n_micro=n_micro, smoke=smoke,
                       seed=seed)
    row = {"choices": compare_choices(choices, own),
           "replay": compare("train", got, want, STEP_TOL)}
    row["replay_s"] = time.perf_counter() - t0
    return row


class NarrowOps(TorchDispatchMode):
    """Inside the block, every op whose floating output is narrower than
    float64, counted under ``ops`` by where the port called it (the
    innermost frame under ``repro_torch/`` outside the dispatch modes,
    ``file:line function``, the file from the package's parent), the op
    and the dtype: the sites that demote a float64 step. Ops on DTensors
    are left to DTensor, whose local ops come back here; ops on fake
    tensors (DTensor's shape propagation) are not counted."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        narrow = sorted({str(t.dtype).split(".")[-1]
                         for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor)
                         and not isinstance(t, FakeTensor)
                         and t.dtype.is_floating_point
                         and t.dtype.itemsize < 8})
        if narrow:
            key = f"{_caller()} {func._schema.name} {','.join(narrow)}"
            self.ops[key] = self.ops.get(key, 0) + 1
        return out


def _caller() -> str:
    """``file:line function`` of the innermost frame in the port's package outside
    this module and the collective counter's (the dispatch modes; paths
    from the package's parent)."""
    import os
    import traceback

    from repro_torch.launch import collectives

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(here))
    modes = {os.path.abspath(__file__), os.path.abspath(collectives.__file__)}
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if path.startswith(os.path.join(root, "repro_torch")) \
                and path not in modes:
            return f"{os.path.relpath(path, root)}:{frame.lineno} " \
                   f"{frame.name}"
    return "? ?"


def bytes_by_kind(counts: Dict[str, int]) -> Dict[str, int]:
    return {k: int(counts[k]) for k in COLLECTIVE_OPS}


def collective_ms(counts: Dict[str, int]) -> float:
    """The dry run's computed collective term of these bytes, in ms (the
    NVLink data-sheet rate, ``launch/roofline.py``)."""
    from repro_torch.launch.roofline import LINK_BW

    return 1e3 * sum(bytes_by_kind(counts).values()) / LINK_BW


def record_collectives(names: Sequence[str], mesh_shape: Dict[str, int],
                       smoke: bool = False,
                       shapes: Optional[Dict[str, Tuple[int, int]]] = None,
                       layers: Optional[Dict[str, int]] = None
                       ) -> Dict[str, Dict[str, int]]:
    """(In a process of its own: it joins a fake process group as rank 0.)
    The dry run's collective bytes by kind of each case's step over a fake
    mesh of ``mesh_shape``, traced on meta tensors (``dryrun._measure``
    with the case's plan, a hybrid case's prefill through its hybrid);
    ``shapes`` gives a case's (batch, seq_len) and ``layers`` its depth
    where they are not the case's own."""
    mesh = dryrun.fake_mesh(mesh_shape)
    out = {}
    for name in names:
        case = CASES[name]
        b, s = (shapes or {}).get(name, (None, None))
        rec = dryrun._measure(case_config(name, smoke, layers=(
                                  layers or {}).get(name)),
                              case_shape(name, smoke, b, s), mesh,
                              torch.float32, lep=case.lep,
                              expert_axes=case.expert_axes,
                              hybrid=case.hybrid)
        out[name] = rec["coll"]
    return out


# ---------------------------------------------------------------------------
# The collectives a backend ran, from a torch.profiler trace
# ---------------------------------------------------------------------------

#: element bytes of the dtype names a ``record_param_comms`` event carries
_DTYPE_BYTES = {"Float": 4, "BFloat16": 2, "Half": 2, "Double": 8,
                "Char": 1, "Byte": 1, "Bool": 1, "Int": 4, "Long": 8,
                "Short": 2, "Float8_e4m3fn": 1, "Float8_e5m2": 1}
#: what a process group records that moves no data of the step: waits,
#: barriers, the marker that ends a coalesced batch, a communicator's
#: setup (``init``; ``broadcastUniqueNCCLID``, its id sent through the
#: store)
_NO_DATA = ("barrier", "coalesced", "wait", "init", "broadcastuniquencclid",
            "abort")


def _kind_of(name: str) -> Optional[str]:
    """The kind of ``COLLECTIVE_OPS`` a recorded collective counts under,
    "" for one that moves no data of the step, None for one unknown."""
    n = name.lower()
    if n in _NO_DATA:
        return ""
    for kind, words in (("all-reduce", ("allreduce", "all_reduce")),
                        ("all-gather", ("allgather", "all_gather")),
                        ("reduce-scatter", ("reduce_scatter",
                                            "reducescatter")),
                        ("all-to-all", ("alltoall", "all_to_all")),
                        ("collective-permute", ("send", "recv"))):
        if any(w in n for w in words):
            return kind
    return None


def traced_collectives(trace: Dict[str, Any]) -> Dict[str, Any]:
    """The collectives of a ``torch.profiler`` Chrome trace (its JSON),
    from its ``record_param_comms`` events (the process group's own
    record of each: name, element counts in and out, dtype), in
    :class:`CollectiveCounter`'s convention: the output bytes on this rank
    by kind, a run of point-to-point transfers with no other collective
    between them one permute of the larger of what it sends and what it
    receives. Also the device time of the backend's kernels (``nccl``
    in their name) in ms and the names of collectives it cannot place
    (``unknown``)."""
    counts = zero_counts()
    events = sorted((e for e in trace.get("traceEvents", [])
                     if e.get("name") == "record_param_comms"),
                    key=lambda e: e.get("ts", 0))
    sent = received = 0
    unknown = []

    def flush():
        nonlocal sent, received
        counts["collective-permute"] += max(sent, received)
        sent = received = 0

    for e in events:
        a = e.get("args", {})
        name = str(a.get("Collective name", ""))
        kind = _kind_of(name)
        size = _DTYPE_BYTES.get(str(a.get("dtype", "")), None)
        n_in = int(a.get("In msg nelems", 0) or 0)
        n_out = int(a.get("Out msg nelems", 0) or 0)
        if kind == "":
            continue
        if kind is None or size is None:
            unknown.append(f"{name} ({a.get('dtype')})")
            continue
        if kind == "collective-permute":
            if "send" in name.lower():
                sent += n_in * size
            else:
                received += n_out * size
            continue
        flush()
        counts[kind] += n_out * size
        counts["count"] += 1
    flush()
    kernel_us = sum(e.get("dur", 0) for e in trace.get("traceEvents", [])
                    if e.get("cat") == "kernel"
                    and "nccl" in e.get("name", "").lower())
    return {"counts": counts, "kernel_ms": kernel_us / 1e3,
            "unknown": unknown}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="The dry run's collective "
                                 "bytes of the sharded-step cases, one "
                                 "JSON line")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--mesh", default="2x2", help="data x model")
    ap.add_argument("--shape", action="append", default=[],
                    help="case=BxS: a case's batch and length")
    ap.add_argument("--layers", action="append", default=[],
                    help="case=N: a case's depth")
    args = ap.parse_args(argv)
    n_data, n_model = (int(n) for n in args.mesh.split("x"))
    shapes = {}
    for item in args.shape:
        name, bs = item.split("=")
        shapes[name] = tuple(int(n) for n in bs.split("x"))
    layers = {name: int(n) for name, n in
              (item.split("=") for item in args.layers)}
    print(json.dumps(record_collectives(
        args.cases.split(","), {"data": n_data, "model": n_model},
        shapes=shapes, layers=layers)))


if __name__ == "__main__":
    main()
