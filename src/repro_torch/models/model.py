"""Model assembly for every family of the JAX package: dense and MoE
segments with MLA attention (the paper's DeepSeek-R1) or GQA attention
(Qwen3, Qwen2.5, Granite, Phi-3, OLMoE, Kimi K2), the attention-free Mamba2
SSM, the Zamba2 hybrid, and the two frontends (InternVL2's patch prefix,
HuBERT's bidirectional encoder over audio frames).

The model is organized as *segments* of structurally identical layers, as
in the JAX package: ``moe`` configs run ``[dense x first_k_dense] + [moe x
(L - k)]``, ``ssm`` configs ``[mamba x L]``, hybrids ``[mamba groups of
attn_every, each followed by one *shared* attention block] + [mamba
tail]``, others ``[dense x L]``. Where JAX stacks a segment's weights on a
leading layer axis and runs ``lax.scan``, the port keeps one module per
layer and loops over them in Python. Where JAX ``jit``s a step and donates
the cache buffers, the port runs eagerly and writes caches in place: a
decode or continuation step mutates the latent (or SSM state) tensors of
the caches it is given and returns a new dict that holds those same
tensors.

Entry points: ``forward`` (full sequence, no cache), ``prefill`` (full
sequence + cache materialization), ``decode_step`` (one token),
``decode_loop`` (N greedy steps with per-slot done/capacity masks),
``decode_loop_mtp`` (N MTP speculative iterations, up to 2N tokens per
host sync) and ``prefill_continue`` (teacher-forced continuation against
an existing cache: the EMS-reuse suffix, the bounded-shape prefill chunk
and, with per-request offsets, the MTP fused verification). MoE execution
is pluggable via ``moe_fn``; the default is the single-device capacity
implementation.

Caches keep the JAX layout: per MLA segment ``{"mla": (L,B,S,kvr+rope),
"length": int32 tensor}``, per GQA segment ``KVCache(k, v (L,B,S,KV,hd),
length)`` (``S = sliding_window`` for a ring), per Mamba segment
``SSMState(h (L,B,H,P,N) f32, conv (L,B,K-1,C), length)``, and per hybrid
group segment ``{"ssm": {"h": (G,per_group,B,H,P,N) f32, "conv":
(G,per_group,B,K-1,C), "length"}, "length", "shared_kv": KVCache((G,B,S,
KV,hd) x2, length)}`` -- the shared block's weights are one set, but each
group keeps its own K/V.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch import dtensor as dt
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import rms_norm, swiglu, weight, widened
from repro_torch.models.mamba2 import SSMState

MoeFn = Callable[[nn.Module, torch.Tensor, ModelConfig],
                 Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


# ---------------------------------------------------------------------------
# Segment plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    kind: str        # dense | moe | mamba_groups | mamba_tail
    n_layers: int    # layers in this segment (groups*per_group for mamba_groups)
    per_group: int = 0

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.per_group


MAMBA_KINDS = ("mamba_groups", "mamba_tail")


def build_plan(cfg: ModelConfig) -> List[Segment]:
    if cfg.is_hybrid:
        groups = cfg.num_layers // cfg.attn_every
        tail = cfg.num_layers % cfg.attn_every
        plan = [Segment("mamba_groups", "mamba_groups",
                        groups * cfg.attn_every, cfg.attn_every)]
        if tail:
            plan.append(Segment("mamba_tail", "mamba_tail", tail))
        return plan
    if cfg.is_ssm:
        return [Segment("mamba", "mamba_tail", cfg.num_layers)]
    if cfg.is_moe:
        plan = []
        if cfg.first_k_dense:
            plan.append(Segment("dense_lead", "dense", cfg.first_k_dense))
        plan.append(Segment("moe", "moe", cfg.num_layers - cfg.first_k_dense))
        return plan
    return [Segment("dense", "dense", cfg.num_layers)]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Modules and init
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """Dense SwiGLU FFN weights of one layer."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.ln = weight((d,), dtype, device, generator, "ones")
        self.w_gate = weight((d, f), dtype, device, generator)
        self.w_up = weight((d, f), dtype, device, generator)
        self.w_down = weight((f, d), dtype, device, generator)


class Block(nn.Module):
    """One layer: a Mamba2 block in a Mamba segment, else MLA or GQA
    attention, then the MLP or the MoE."""

    def __init__(self, cfg: ModelConfig, kind: str, device: torch.device,
                 dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kind = kind
        if kind in MAMBA_KINDS:
            self.mamba = mamba_mod.Mamba(cfg, device, dtype, generator)
            return
        self.attn = (mla_mod.init_mla_params(cfg, device, dtype, generator)
                     if cfg.attention_kind == "mla" else
                     attn_mod.Attention(cfg, device, dtype, generator))
        if kind == "moe":
            self.moe = moe_mod.init_moe_params(cfg, device, dtype, generator)
        else:
            self.mlp = MLP(cfg, device, dtype, generator)


class Model(nn.Module):
    """All weights of a model: embedding, per-segment layer lists, final
    norm and LM head, and for a hybrid the one ``shared_attn`` block
    (attention and MLP) that runs after every group. Built uninitialized
    without a generator (for :mod:`repro_torch.convert` to load into)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dtype = _dtype(cfg)
        plan = build_plan(cfg)
        self.cfg = cfg
        self.embed = weight((cfg.vocab_size, cfg.d_model), dtype, device,
                            generator, scale=0.02)
        self.final_norm = weight((cfg.d_model,), dtype, device, generator,
                                 "ones")
        if not cfg.tie_embeddings:
            self.lm_head = weight((cfg.d_model, cfg.vocab_size), dtype,
                                  device, generator)
        self.segments = nn.ModuleDict({
            seg.name: nn.ModuleList(
                [Block(cfg, seg.kind, device, dtype, generator)
                 for _ in range(seg.n_layers)])
            for seg in plan})
        if cfg.is_hybrid:
            self.shared_attn = Block(cfg, "dense", device, dtype, generator)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = None) -> Model:
    """Random weights from ``seed``, made on ``device`` (CUDA unless the
    caller names another; raises when CUDA is absent)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Model(cfg, dev, gen)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_tokens(params: Model, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of the embedding for ``tokens``; from a DTensor table, a
    masked lookup on each rank's rows and an all-reduce
    (:func:`repro_torch.dtensor.embedding`)."""
    if dt.is_dtensor(params.embed):
        return dt.embedding(tokens, params.embed)
    return params.embed[tokens]


def embed_inputs(params: Model, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The input embeddings: audio ``frames`` (B,S,D) as they are, else the
    token embeddings, after a VLM's ``prefix_emb`` (B,P,D) when given."""
    if cfg.frontend == "audio_frames":
        return batch["frames"].to(_dtype(cfg))
    x = embed_tokens(params, batch["tokens"])
    if cfg.frontend == "vision_patches" and "prefix_emb" in batch:
        x = torch.cat([batch["prefix_emb"].to(x.dtype), x], dim=1)
    return x


def unembed(params: Model, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return dt.linear(x, head)


# ---------------------------------------------------------------------------
# Per-layer blocks
# ---------------------------------------------------------------------------


def _attn_block_prefill(pl_attn, x, cfg, positions, kv_out: bool = True):
    """Returns (x + attention, the MLA latent or the GQA (k, v); None for
    GQA without ``kv_out``: ``attention_prefill``'s). With
    ``REPRO_MLA_HYBRID`` set to ``a2a`` or ``rs`` and a current mesh, the MLA
    prefill runs the paper's §4.3.1 SP -> TP -> SP form over the mesh's
    model axis (``core/hybrid_parallel.py``)."""
    h = rms_norm(x, pl_attn.ln, cfg.norm_eps)
    if cfg.attention_kind == "mla":
        mode = os.environ.get("REPRO_MLA_HYBRID", "")
        if mode in ("a2a", "rs"):
            from repro_torch.core.parallel import get_current_mesh
            mesh = get_current_mesh()
            if mesh is not None:
                from repro_torch.core.hybrid_parallel import \
                    mla_prefill_hybrid
                out, latent = mla_prefill_hybrid(pl_attn, h, cfg, mesh,
                                                 oproj_mode=mode)
                return x + out, latent
        out, latent = mla_mod.mla_prefill(pl_attn, h, cfg, positions)
        return x + out, latent
    out, kv = attn_mod.attention_prefill(pl_attn, h, cfg, positions, kv_out)
    return x + out, kv


def _attn_block_decode(pl_attn, x, cfg, cache_k, cache_v, cache_len, ring):
    """One token of attention, written into layer caches in place (MLA:
    ``cache_k`` is the latent buffer and ``cache_v`` is unused)."""
    h = rms_norm(x, pl_attn.ln, cfg.norm_eps)
    if cfg.attention_kind == "mla":
        out, _ = mla_mod.mla_decode(pl_attn, h, cache_k, cache_len, cfg)
    else:
        out, _, _ = attn_mod.attention_decode(pl_attn, h, cache_k, cache_v,
                                              cache_len, cfg, ring)
    return x + out


def _mlp_block(pl_mlp, x, cfg):
    h = rms_norm(x, pl_mlp.ln, cfg.norm_eps)
    return x + swiglu(h, pl_mlp.w_gate, pl_mlp.w_up, pl_mlp.w_down)


def _moe_block(pl_moe, x, cfg, moe_fn: MoeFn):
    # A MoE function that leaves its output on a split of the rows (LEP's
    # in a training step, ``make_lep_moe_fn(split_tokens=True)``) names it
    # as ``split_rows``; the residual stream goes there before the norm,
    # so that one gather in the backward serves the norm's and the
    # residual's gradients.
    split_rows = getattr(moe_fn, "split_rows", None)
    if split_rows is not None:
        x = split_rows(x)
    b, s, d = x.shape
    h = rms_norm(x, pl_moe.ln, cfg.norm_eps)
    out, aux = moe_fn(pl_moe, h.reshape(b * s, d), cfg)
    return x + out.reshape(b, s, d), aux


def _ffn(blk: Block, h, cfg, moe_fn: MoeFn):
    if blk.kind == "moe":
        return _moe_block(blk.moe, h, cfg, moe_fn)[0]
    return _mlp_block(blk.mlp, h, cfg)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def make_caches(cfg: ModelConfig, batch: int, capacity: int,
                dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Zero caches. An SSM state ignores ``capacity`` and ``dtype``: its
    ``h`` is float32 and its conv window bfloat16, as in the JAX package
    (both float64 in float64 caches, a float64 step's).
    A hybrid's shared K/V is a ring of ``sliding_window`` slots when
    capacity exceeds the window, as a GQA cache is."""
    dev = resolve_device(device)
    caches: Dict[str, Any] = {}
    for seg in build_plan(cfg):
        if seg.kind == "mamba_tail":
            caches[seg.name] = mamba_mod.make_ssm_state(cfg, seg.n_layers,
                                                        batch, dev, dtype)
        elif seg.kind == "mamba_groups":
            g = seg.n_groups
            st = mamba_mod.make_ssm_state(cfg, g * seg.per_group, batch, dev,
                                          dtype)
            caches[seg.name] = {
                "ssm": {"h": st.h.unflatten(0, (g, seg.per_group)),
                        "conv": st.conv.unflatten(0, (g, seg.per_group)),
                        "length": st.length},
                "length": torch.zeros((), dtype=torch.int32, device=dev),
                "shared_kv": attn_mod.make_cache(cfg, g, batch, capacity,
                                                 dtype, dev)}
        elif cfg.attention_kind == "mla":
            caches[seg.name] = {
                "mla": mla_mod.make_mla_cache(cfg, seg.n_layers, batch,
                                              capacity, dtype, dev),
                "length": torch.zeros((), dtype=torch.int32, device=dev)}
        else:
            # A ring of sliding_window slots when capacity exceeds it.
            caches[seg.name] = attn_mod.make_cache(cfg, seg.n_layers, batch,
                                                   capacity, dtype, dev)
    return caches


def cache_batch_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Batch-axis index of every cache leaf, in the make_caches structure
    (None = unbatched bookkeeping leaf, e.g. the length). A hybrid group's
    SSM state has batch on axis 2, after the group and layer axes."""
    def axes(seg):
        if seg.kind == "mamba_tail":
            return SSMState(1, 1, None)
        if seg.kind == "mamba_groups":
            return {"ssm": {"h": 2, "conv": 2, "length": None},
                    "length": None, "shared_kv": KVCache(1, 1, None)}
        if cfg.attention_kind == "mla":
            return {"mla": 1, "length": None}
        return KVCache(1, 1, None)
    return {seg.name: axes(seg) for seg in build_plan(cfg)}


def _is_ring_cache(cfg: ModelConfig, cache) -> bool:
    """A GQA cache is decoded into as a ring when its buffer holds exactly
    ``sliding_window`` slots (as in JAX: a plain cache whose capacity
    equals the window is treated as a ring too, which is harmless). An MLA
    latent cache never is."""
    return (cfg.attention_kind != "mla" and bool(cfg.sliding_window)
            and cache.k.shape[2] == cfg.sliding_window)


def _seq_cache(seg: Segment, cache):
    """The per-token part of a segment's cache: the attention segment's own,
    a hybrid group segment's shared K/V, None for a Mamba tail."""
    if seg.kind == "mamba_groups":
        return cache["shared_kv"]
    return None if seg.kind == "mamba_tail" else cache


def _seq_buffers(cfg: ModelConfig, cache) -> List[torch.Tensor]:
    """The per-token buffers of an attention cache: the MLA latent, or K
    and V."""
    if cfg.attention_kind == "mla":
        return [cache["mla"]]
    return [cache.k, cache.v]


def _with_buffers(cfg: ModelConfig, cache, length: torch.Tensor):
    """An attention segment's cache holding ``cache``'s buffers and
    ``length``."""
    if cfg.attention_kind == "mla":
        return {**cache, "length": length}
    return KVCache(cache.k, cache.v, length)


def _group_cache(c, h, conv, ssm_length, length):
    """A hybrid group segment's cache: the state ``h`` and ``conv`` with
    ``ssm_length``, the shared K/V buffers of ``c`` with ``length``."""
    kv = c["shared_kv"]
    return {"ssm": {"h": h, "conv": conv, "length": ssm_length},
            "length": length, "shared_kv": KVCache(kv.k, kv.v, length)}


def _with_lengths(cfg: ModelConfig, caches: Dict[str, Any],
                  length: torch.Tensor) -> Dict[str, Any]:
    """Caches with every bookkeeping ``length`` leaf set to ``length``
    (decode carries per-slot (B,) lengths)."""
    out = dict(caches)
    for seg in build_plan(cfg):
        c = out[seg.name]
        if seg.kind == "mamba_tail":
            out[seg.name] = SSMState(c.h, c.conv, length)
        elif seg.kind == "mamba_groups":
            out[seg.name] = _group_cache(c, c["ssm"]["h"], c["ssm"]["conv"],
                                         length, length)
        else:
            out[seg.name] = _with_buffers(cfg, c, length)
    return out


def _cache_capacity(cfg: ModelConfig, caches: Dict[str, Any]
                    ) -> Optional[int]:
    """Token capacity of the tightest non-ring sequence buffer (None when
    nothing bounds decode length: a pure SSM, or rings only)."""
    caps = []
    for seg in build_plan(cfg):
        c = _seq_cache(seg, caches[seg.name])
        if c is None or _is_ring_cache(cfg, c):
            continue
        caps.append(_seq_buffers(cfg, c)[0].shape[2])
    return min(caps) if caps else None


def _ssm_state(seg: Segment, cache) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Mamba segment's (h, conv) tensors."""
    if seg.kind == "mamba_groups":
        return cache["ssm"]["h"], cache["ssm"]["conv"]
    return cache.h, cache.conv


def _conv_step_dtype(cfg: ModelConfig, conv: torch.Tensor) -> torch.dtype:
    """The dtype a decode step leaves the conv window in: the promotion of
    the window's and the model's (float32 in a float32 model, after a
    prefill that stored it as bfloat16)."""
    return torch.promote_types(conv.dtype, _dtype(cfg))


def decode_ready_caches(cfg: ModelConfig, caches: Dict[str, Any]
                        ) -> Dict[str, Any]:
    """Caches in the dtypes a decode step produces, so that steps can write
    into them in place from the first one (the counterpart of the JAX
    package's ``decode_ready_caches``; the upcast is exact). Only the SSM
    conv windows change."""
    out = dict(caches)
    for seg in build_plan(cfg):
        c = out[seg.name]
        if seg.kind == "mamba_tail":
            out[seg.name] = SSMState(
                c.h, c.conv.to(_conv_step_dtype(cfg, c.conv)), c.length)
        elif seg.kind == "mamba_groups":
            conv = c["ssm"]["conv"]
            out[seg.name] = _group_cache(
                c, c["ssm"]["h"], conv.to(_conv_step_dtype(cfg, conv)),
                c["ssm"]["length"], c["length"])
    return out


def _as_len(value, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Decode step (one new token per request)
# ---------------------------------------------------------------------------


def decode_step(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
                caches: Dict[str, Any], cache_len,
                moe_fn: Optional[MoeFn] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: (B, 1) int. Writes each layer's new latent or K/V entry (at
    ``cache_len``, scalar or (B,); at ``cache_len % sliding_window`` in a
    ring) or new SSM state into ``caches`` in place and returns (logits
    (B, V), caches with ``length = cache_len + 1``; a hybrid group's SSM
    ``length`` is its own plus one, as in the JAX package)."""
    moe_fn = moe_fn or moe_mod.moe_capacity
    x = embed_tokens(params, tokens).to(_dtype(cfg))          # (B,1,D)
    cache_len = _as_len(cache_len, x.device)
    new_caches: Dict[str, Any] = {}
    for seg in build_plan(cfg):
        blocks, c = params.segments[seg.name], caches[seg.name]
        if seg.kind == "mamba_tail":
            conv = _step_conv(cfg, c.conv)
            x = _mamba_decode_layers(blocks, x, c.h, conv, cfg)
            new_caches[seg.name] = SSMState(c.h, conv, cache_len + 1)
        elif seg.kind == "mamba_groups":
            h, conv = c["ssm"]["h"], _step_conv(cfg, c["ssm"]["conv"])
            kv = c["shared_kv"]
            ring = _is_ring_cache(cfg, kv)
            pg, shared = seg.per_group, params.shared_attn
            for gi in range(seg.n_groups):
                x = _mamba_decode_layers(blocks[gi * pg:(gi + 1) * pg], x,
                                         h[gi], conv[gi], cfg)
                x = _attn_block_decode(shared.attn, x, cfg, kv.k[gi],
                                       kv.v[gi], cache_len, ring)
                x = _ffn(shared, x, cfg, moe_fn)
            new_caches[seg.name] = _group_cache(
                c, h, conv, c["ssm"]["length"] + 1, cache_len + 1)
        else:
            bufs = _seq_buffers(cfg, c)
            ring = _is_ring_cache(cfg, c)
            for li, blk in enumerate(blocks):
                x = _attn_block_decode(blk.attn, x, cfg, bufs[0][li],
                                       bufs[-1][li], cache_len, ring)
                x = _ffn(blk, x, cfg, moe_fn)
            new_caches[seg.name] = _with_buffers(cfg, c, cache_len + 1)
    logits = unembed(params, cfg, x[:, 0:1, :])[:, 0, :]
    return logits, new_caches


def _step_conv(cfg: ModelConfig, conv: torch.Tensor) -> torch.Tensor:
    """The conv window a decode step writes: ``conv`` itself, or -- still
    in prefill's bfloat16 while the step computes in float32 -- an exact
    upcast copy. The tensors a step writes thus always have the dtype it
    produces, so an in-place write never rounds (a decode engine's caches
    are already :func:`decode_ready_caches`)."""
    step_dtype = _conv_step_dtype(cfg, conv)
    return conv if conv.dtype == step_dtype else conv.to(step_dtype)


def _mamba_decode_layers(blocks, x: torch.Tensor, h: torch.Tensor,
                         conv: torch.Tensor, cfg: ModelConfig
                         ) -> torch.Tensor:
    """One token through Mamba layers ``blocks``, layer ``li``'s new state
    written into ``h[li]`` and ``conv[li]`` in place."""
    for li, blk in enumerate(blocks):
        hin = rms_norm(x, blk.mamba.ln, cfg.norm_eps)
        out, h[li], conv[li] = mamba_mod.mamba_decode(blk.mamba, hin, h[li],
                                                      conv[li], cfg)
        x = x + out
    return x


# ---------------------------------------------------------------------------
# Multi-step greedy decode (the serving fast path)
# ---------------------------------------------------------------------------


def _ssm_batch_axis(seg: Segment) -> int:
    return 2 if seg.kind == "mamba_groups" else 1


def _save_frozen(cfg: ModelConfig, caches, cache_len: torch.Tensor,
                 frozen: Optional[List[int]], span: int = 1):
    """What a step may overwrite in a slot that must stay frozen. MLA and
    GQA (a hybrid's shared K/V included): every slot's latent (or K and V)
    rows at its ``span`` write positions from ``cache_len`` --
    ``(cache_len + k) % sliding_window`` in a ring, else clamped into the
    buffer (a per-request write past it is dropped) -- chosen on the
    device. Mamba: the whole state of the slots ``frozen`` (host indices),
    and only theirs: at full width a Mamba state is hundreds of MB;
    ``frozen=None`` (the host cannot name them: MTP's acceptance decides)
    saves every slot's state. Returns (SSM states by segment, rows)."""
    states, rows_saved = {}, []
    for seg in build_plan(cfg):
        c = caches[seg.name]
        if seg.kind in MAMBA_KINDS:
            h, conv = _ssm_state(seg, c)
            ax = _ssm_batch_axis(seg)
            if frozen is None:
                states[seg.name] = (None, h.clone(), conv.clone())
            elif frozen:
                idx = torch.tensor(frozen, device=h.device)
                states[seg.name] = (idx, h.index_select(ax, idx),
                                    conv.index_select(ax, idx))
        kv = _seq_cache(seg, c)
        if kv is None:
            continue
        bufs = _seq_buffers(cfg, kv)
        cap = bufs[0].shape[2]
        ring = _is_ring_cache(cfg, kv)
        rows = torch.arange(bufs[0].shape[1], device=bufs[0].device)
        slots = [attn_mod.decode_slot(cache_len + k, cap, ring)
                 .clamp(max=cap - 1).long() for k in range(span)]
        rows_saved += [(t, rows, idx, t[:, rows, idx].clone())
                       for idx in slots for t in bufs]
    return states, rows_saved


def _restore_frozen(cfg: ModelConfig, caches, saved,
                    live: torch.Tensor) -> None:
    states, rows_saved = saved
    for seg in build_plan(cfg):
        if seg.name not in states:
            continue
        idx, h_old, conv_old = states[seg.name]
        ax = _ssm_batch_axis(seg)
        for new, old in zip(_ssm_state(seg, caches[seg.name]),
                            (h_old, conv_old)):
            # exact: a step may have upcast the window from bf16 to f32
            old = old.to(new.dtype)
            if idx is None:
                shape = [1] * new.ndim
                shape[ax] = -1
                new.copy_(torch.where(live.reshape(shape), new, old))
            else:
                new.index_copy_(ax, idx, old)
    for t, rows, idx, old in rows_saved:
        keep = live.reshape((1, -1) + (1,) * (old.ndim - 2))
        t[:, rows, idx] = torch.where(keep, t[:, rows, idx], old)


def decode_loop(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
                caches: Dict[str, Any], cache_len, n_steps: int,
                *, steps_left: Optional[torch.Tensor] = None,
                moe_fn: Optional[MoeFn] = None,
                step_fn: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           Dict[str, Any], torch.Tensor]:
    """``n_steps`` greedy decode iterations without a host sync between
    them (the JAX package runs them in one ``lax.scan``; here a Python loop).

    Per-slot done/capacity masking keeps finished or capacity-full slots
    frozen: their token, cache content and ``cache_len`` hold bit-exactly
    while live slots advance, so the result is token-identical to
    ``n_steps`` sequential :func:`decode_step` calls. (The step writes every
    slot in place; what it overwrote in a frozen slot is restored. Slot i
    is live at step j iff ``j < min(steps_left[i], capacity - cache_len[i])``.
    An SSM step overwrites a slot's whole state, so for a Mamba segment one
    host read before the loop names each step's frozen slots and only
    those are copied; an MLA or K/V row is selected on the device.)

    tokens: (B,) int32; cache_len: (B,) int32 (scalars are broadcast);
    steps_left: (B,) tokens each slot still wants (default ``n_steps``).
    ``step_fn`` overrides the inner ``(tokens (B,1), caches, cache_len) ->
    (logits, caches)`` step (the microbatch interleaver wraps it).

    Returns ``(emitted (B, n_steps), live (B, n_steps), tokens (B,),
    caches, cache_len)``; ``emitted[:, j]`` is meaningful only where
    ``live[:, j]``.
    """
    if tokens.ndim != 1:
        raise ValueError(f"decode_loop wants tokens of shape (B,), "
                         f"got {tuple(tokens.shape)}")
    if n_steps < 1:
        raise ValueError(f"decode_loop needs n_steps >= 1, got {n_steps}")
    b = tokens.shape[0]
    dev = tokens.device
    cache_len = _as_len(cache_len, dev).expand(b).clone()
    if steps_left is None:
        steps_left = torch.full((b,), n_steps, dtype=torch.int32, device=dev)
    else:
        # A stale/negative budget must read as "done", not wrap around.
        steps_left = _as_len(steps_left, dev).clamp(min=0)
    if step_fn is None:
        def step_fn(t, c, l):
            return decode_step(params, cfg, t, c, l, moe_fn)

    cap = _cache_capacity(cfg, caches)
    caches = _with_lengths(cfg, caches, cache_len)
    n_live = steps_left if cap is None else torch.minimum(
        steps_left, (cap - cache_len).clamp(min=0))
    n_live_host = n_live.tolist() if cfg.is_ssm or cfg.is_hybrid else None
    tok = tokens.to(torch.int32)
    emitted, lives = [], []
    for j in range(n_steps):
        live = n_live > j
        frozen = None if n_live_host is None else [
            i for i, n in enumerate(n_live_host) if n <= j]
        saved = _save_frozen(cfg, caches, cache_len, frozen)
        logits, caches = step_fn(tok[:, None], caches, cache_len)
        _restore_frozen(cfg, caches, saved, live)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        tok = torch.where(live, nxt, tok)
        cache_len = cache_len + live.to(torch.int32)
        caches = _with_lengths(cfg, caches, cache_len)
        emitted.append(nxt)
        lives.append(live)
    return (torch.stack(emitted, 1), torch.stack(lives, 1), tok, caches,
            cache_len)


# ---------------------------------------------------------------------------
# Multi-iteration MTP speculative decode (the serving fast path, §4.2.4)
# ---------------------------------------------------------------------------


def decode_loop_mtp(params: Model, mtp: Any, cfg: ModelConfig,
                    tokens: torch.Tensor, drafts: torch.Tensor,
                    caches: Dict[str, Any], cache_len, n_iters: int, *,
                    steps_left: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    greedy: bool = True, fused_verify: bool = False,
                    moe_fn: Optional[MoeFn] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor, Dict[str, Any],
                               torch.Tensor]:
    """``n_iters`` MTP iterations without a host sync between them -- up to
    ``2 * n_iters`` tokens per sync (the JAX package runs them in one
    ``lax.scan``; here a Python loop).

    Each iteration is one :func:`repro_torch.core.mtp.mtp_step`: base and
    draft verification (two decode steps, or ONE fused two-token forward
    when ``fused_verify``), sampling, per-slot accept/reject and the next
    draft. Accepted iterations advance ``cache_len`` by 2, rejected ones by
    1, so lengths diverge within the batch.

    A slot is live while it still wants tokens (``steps_left > 0``) and both
    writes fit (``cache_len + 2 <= capacity``); frozen slots keep their
    token, draft, cache rows and ``cache_len`` bit-exactly. Liveness depends
    on acceptance, so it stays on the device: the two rows an iteration may
    write in each slot (MLA, K/V) are saved and restored by a select, and no
    iteration reads anything back to the host. (A Mamba state is saved
    whole; a rejected draft's SSM update is not rolled back, as in the JAX
    package.)

    tokens/drafts: (B,) int32, the last committed token and its proposed
    successor. steps_left: (B,) tokens each slot still wants (default
    ``2 * n_iters``). Returns ``(emitted (B, n_iters, 2), accepted (B,
    n_iters), live (B, n_iters), tokens, drafts, caches, cache_len)``;
    ``emitted[:, j]`` is meaningful only where ``live[:, j]``, and
    ``emitted[:, j, 1]`` only where also ``accepted[:, j]``.
    """
    from repro_torch.core import mtp as mtp_mod  # core.mtp imports us

    if tokens.ndim != 1:
        raise ValueError(f"decode_loop_mtp wants tokens of shape (B,), "
                         f"got {tuple(tokens.shape)}")
    if n_iters < 1:
        raise ValueError(f"decode_loop_mtp needs n_iters >= 1, got {n_iters}")
    b = tokens.shape[0]
    dev = tokens.device
    cache_len = _as_len(cache_len, dev).expand(b).clone()
    if steps_left is None:
        left = torch.full((b,), 2 * n_iters, dtype=torch.int32, device=dev)
    else:
        left = _as_len(steps_left, dev).clamp(min=0)
    cap = _cache_capacity(cfg, caches)
    caches = _with_lengths(cfg, decode_ready_caches(cfg, caches), cache_len)
    tok, drf = tokens.to(torch.int32), drafts.to(torch.int32)
    ems, accs, lives = [], [], []
    for _ in range(n_iters):
        live = left > 0
        if cap is not None:
            live &= cache_len + 2 <= cap   # base + speculative writes fit
        saved = _save_frozen(cfg, caches, cache_len, None, span=2)
        em, acc, x_next, d_next, caches, new_len = mtp_mod.mtp_step(
            params, mtp, cfg, tok, drf, caches, cache_len, generator,
            moe_fn, greedy, fused_verify)
        _restore_frozen(cfg, caches, saved, live)
        acc = acc & live
        tok = torch.where(live, x_next, tok)
        drf = torch.where(live, d_next, drf)
        cache_len = torch.where(live, new_len, cache_len)
        left = left - torch.where(live, 1 + acc.to(torch.int32), 0)
        caches = _with_lengths(cfg, caches, cache_len)
        ems.append(em)
        accs.append(acc)
        lives.append(live)
    return (torch.stack(ems, 1), torch.stack(accs, 1), torch.stack(lives, 1),
            tok, drf, caches, cache_len)


# ---------------------------------------------------------------------------
# Chunked suffix prefill (teacher-forced continuation)
# ---------------------------------------------------------------------------


def supports_prefill_continue(cfg: ModelConfig, capacity: int) -> bool:
    """Static eligibility for :func:`prefill_continue`: a token-addressable,
    non-ring cache."""
    return (cfg.attention_kind in ("causal", "mla")
            and not cfg.is_ssm and not cfg.is_hybrid
            and not attn_mod.is_ring(cfg, capacity))


def prefill_continue(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
                     caches: Dict[str, Any], offset,
                     moe_fn: Optional[MoeFn] = None
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Teacher-forced continuation: run ``tokens`` (B, S) at positions
    ``offset .. offset+S-1`` against caches whose first ``offset`` positions
    are valid, writing their entries in place. ``offset`` may be per-request
    (B,). With ``offset=0`` on a fresh cache this is a bounded-shape prefill
    chunk. Returns (logits (B, S, V), caches). Causal-attention and MLA
    archs only: SSM state is not token-addressable. Callers must not pass
    a wrapped ring cache (serving gates this path on
    :func:`supports_prefill_continue`)."""
    if cfg.is_ssm or cfg.is_hybrid or cfg.attention_kind not in ("causal",
                                                                 "mla"):
        raise NotImplementedError(
            "prefill_continue requires a causal-attention or MLA arch")
    moe_fn = moe_fn or moe_mod.moe_capacity
    x = embed_tokens(params, tokens).to(_dtype(cfg))
    s = x.shape[1]
    offset = _as_len(offset, x.device)
    new_caches: Dict[str, Any] = {}
    for seg in build_plan(cfg):
        c = caches[seg.name]
        bufs = _seq_buffers(cfg, c)
        for li, blk in enumerate(params.segments[seg.name]):
            hin = rms_norm(x, blk.attn.ln, cfg.norm_eps)
            if cfg.attention_kind == "mla":
                out, _ = mla_mod.mla_extend(blk.attn, hin, bufs[0][li],
                                            offset, cfg)
            else:
                out, _, _ = attn_mod.attention_extend(
                    blk.attn, hin, bufs[0][li], bufs[1][li], offset, cfg)
            x = _ffn(blk, x + out, cfg, moe_fn)
        new_caches[seg.name] = _with_buffers(cfg, c, offset + s)
    return unembed(params, cfg, x), new_caches


# ---------------------------------------------------------------------------
# Full-sequence execution (forward / prefill)
# ---------------------------------------------------------------------------


def _write_kv(buf: torch.Tensor, new: torch.Tensor, s: int) -> None:
    """Write one layer's fresh latent, K or V (B,S,...) into its buffer
    (B,cap,...) in place. A GQA ring (``s > cap``) keeps the last ``cap``
    tokens, token p at slot ``p % cap``, as ``attention_decode`` writes
    them. Into a DTensor buffer each rank writes its own block."""
    cap = buf.shape[1]
    if dt.is_dtensor(buf):
        return _write_kv_block(buf, new, s)
    if s <= cap:
        buf[:, :s] = new.to(buf.dtype)
    else:
        buf.copy_(torch.roll(new[:, -cap:].to(buf.dtype), shifts=s % cap,
                             dims=1))


def _write_kv_block(buf, new: torch.Tensor, s: int) -> None:
    """:func:`_write_kv` into a DTensor buffer: ``new`` is brought to the
    buffer's placements (its sequence replicated when it fills only part
    of the buffer) and each rank writes the rows of its block."""
    mesh, cap = buf.device_mesh, buf.shape[1]
    block = buf.to_local()
    new = new.to(buf.dtype)
    if s == cap:
        block.copy_(dt.local(new, mesh, buf.placements))
        return
    full = dt.local(new[:, -cap:], mesh, dt.without_shard(buf.placements, 1))
    if s > cap:
        full, s = torch.roll(full, shifts=s % cap, dims=1), cap
    s0 = dt.shard_offsets(buf)[1]
    rows = max(0, min(s - s0, block.shape[1]))
    if rows:
        block[:, :rows] = full[:, s0:s0 + rows]


def _mamba_prefill_layers(blocks, x: torch.Tensor, cfg: ModelConfig,
                          h: Optional[torch.Tensor] = None,
                          conv: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mamba layers ``blocks`` over the full sequence; with a state, layer
    ``li``'s final ``h`` and conv window written into ``h[li]`` and
    ``conv[li]`` (the window rounded to ``conv``'s bfloat16)."""
    for li, blk in enumerate(blocks):
        hin = rms_norm(x, blk.mamba.ln, cfg.norm_eps)
        out, hs, cs = mamba_mod.mamba_prefill(blk.mamba, hin, cfg)
        if h is not None:
            h[li], conv[li] = hs, cs
        x = x + out
    return x


def _seg_full(seg: Segment, params: Model, x: torch.Tensor,
              cfg: ModelConfig, moe_fn: MoeFn, positions: torch.Tensor,
              cache=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One segment over the full sequence, for ``forward`` (``cache`` None)
    and ``prefill`` (its zero cache, written in place: every layer's latent
    or K/V, a Mamba layer's final state, a hybrid group's shared K/V in
    that group's slice). Returns (x, the segment's MoE aux loss)."""
    blocks = params.segments[seg.name]
    s = x.shape[1]
    aux = torch.zeros((), dtype=torch.promote_types(x.dtype, torch.float32),
                      device=x.device)
    if seg.kind == "mamba_tail":
        state = () if cache is None else (cache.h, cache.conv)
        return _mamba_prefill_layers(blocks, x, cfg, *state), aux
    if seg.kind == "mamba_groups":
        pg, shared = seg.per_group, params.shared_attn
        for gi in range(seg.n_groups):
            state = () if cache is None else (cache["ssm"]["h"][gi],
                                              cache["ssm"]["conv"][gi])
            x = _mamba_prefill_layers(blocks[gi * pg:(gi + 1) * pg], x, cfg,
                                      *state)
            x, fresh = _attn_block_prefill(shared.attn, x, cfg, positions,
                                           cache is not None)
            if cache is not None:
                for buf, new in zip(_seq_buffers(cfg, cache["shared_kv"]),
                                    fresh):
                    _write_kv(buf[gi], new, s)
            x = _mlp_block(shared.mlp, x, cfg)
        return x, aux
    bufs = None if cache is None else _seq_buffers(cfg, cache)
    for li, blk in enumerate(blocks):
        x, fresh = _attn_block_prefill(blk.attn, x, cfg, positions,
                                       cache is not None)
        if bufs is not None:
            for buf, new in zip(bufs, [fresh] if cfg.attention_kind == "mla"
                                else fresh):
                _write_kv(buf[li], new, s)
        if blk.kind == "moe":
            x, a = _moe_block(blk.moe, x, cfg, moe_fn)
            aux = aux + a["aux_loss"]
        else:
            x = _mlp_block(blk.mlp, x, cfg)
    return x, aux


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def forward(params: Model, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            moe_fn: Optional[MoeFn] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward without a cache: (logits (B,S,V), {"aux_loss":
    the MoE load-balance loss summed over layers}). ``batch`` holds
    ``tokens`` (B,S), audio ``frames`` (B,S,D), or a VLM's ``tokens`` with
    ``prefix_emb`` (B,P,D), whose positions come first in the logits."""
    moe_fn = moe_fn or moe_mod.moe_capacity
    x = embed_inputs(params, cfg, batch)
    positions = _positions(x)
    aux_total = torch.zeros((), dtype=torch.promote_types(
        x.dtype, torch.float32), device=x.device)
    for seg in build_plan(cfg):
        x, aux = _seg_full(seg, params, x, cfg, moe_fn, positions)
        aux_total = aux_total + aux
    return unembed(params, cfg, x), {"aux_loss": aux_total}


def prefill(params: Model, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            capacity: int, moe_fn: Optional[MoeFn] = None,
            cache_dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt; return (logits (B,S,V), caches padded to capacity).
    A GQA ring cache (a hybrid's shared K/V too) keeps the prompt's last
    ``sliding_window`` tokens. A Mamba layer's state holds the final ``h``
    and the conv window rounded to bfloat16 whatever ``cache_dtype`` is, as
    the JAX package stores it."""
    moe_fn = moe_fn or moe_mod.moe_capacity
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    caches = make_caches(cfg, b, capacity, cache_dtype, x.device)
    if dt.is_dtensor(x):
        # Over DTensors: the caches placed as decode takes them, each rank
        # cutting its block of its own zeros (no collective).
        from repro_torch.launch.sharding import cache_pspecs, shard_tree
        caches = shard_tree(caches, cache_pspecs(cfg, x.device_mesh, caches),
                            x.device_mesh, local=True)
    cap = _cache_capacity(cfg, caches)
    if cap is not None and s > cap:
        raise ValueError(f"prompt of {s} tokens exceeds the cache capacity "
                         f"{capacity}")
    positions = _positions(x)
    for seg in build_plan(cfg):
        x, _ = _seg_full(seg, params, x, cfg, moe_fn, positions,
                         caches[seg.name])
    caches = _with_lengths(cfg, caches, torch.tensor(s, dtype=torch.int32,
                                                     device=x.device))
    return unembed(params, cfg, x), caches


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def lm_loss(params: Model, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            moe_fn: Optional[MoeFn] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss for training: the mean over positions of
    logsumexp(logits) minus the gold logit, in float32, plus
    ``router_aux_loss_coef`` times the MoE aux loss. ``batch`` is
    :func:`forward`'s plus ``labels`` (B,S); a VLM's ``prefix_emb``
    positions carry no label and are dropped. Returns (loss, {"nll",
    "aux_loss"}). The model's weights are frozen unless the caller turns
    on ``requires_grad`` (``repro_torch.train.loop.trainable``)."""
    logits, aux = forward(params, cfg, batch, moe_fn)
    if cfg.frontend == "vision_patches" and "prefix_emb" in batch:
        logits = logits[:, batch["prefix_emb"].shape[1]:, :]
    # Over DTensors a pending sum over the model axis is taken first; the
    # logsumexp and the pick reduce each rank's block of the vocabulary.
    logits = widened(dt.reduce_partial(logits))
    lse = dt.logsumexp(logits)
    gold = dt.take_last(logits, batch["labels"].long())
    nll = (lse - gold).mean()
    loss = nll + cfg.router_aux_loss_coef * aux["aux_loss"]
    return loss, {"nll": nll, **aux}
