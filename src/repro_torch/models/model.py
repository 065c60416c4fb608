"""Model assembly for the families ported so far: dense and MoE segments
with MLA attention (the paper's DeepSeek-R1).

The model is organized as *segments* of structurally identical layers, as
in the JAX package: ``moe`` configs run ``[dense x first_k_dense] + [moe x
(L - k)]``, others ``[dense x L]``. Where JAX stacks a segment's weights on a
leading layer axis and runs ``lax.scan``, the port keeps one module per
layer and loops over them in Python. Where JAX ``jit``s a step and donates
the cache buffers, the port runs eagerly and writes caches in place: a
decode or continuation step mutates the latent tensors of the caches it is
given and returns a new dict that holds those same tensors.

Entry points: ``prefill`` (full sequence + cache materialization),
``decode_step`` (one token), ``decode_loop`` (N greedy steps with per-slot
done/capacity masks) and ``prefill_continue`` (teacher-forced continuation
against an existing cache). MoE execution is pluggable via ``moe_fn``; the
default is the single-device capacity implementation.

Caches keep the JAX layout: per segment ``{"mla": (L,B,S,kvr+rope),
"length": int32 tensor}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import rms_norm, swiglu, weight

MoeFn = Callable[[nn.Module, torch.Tensor, ModelConfig],
                 Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


# ---------------------------------------------------------------------------
# Segment plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    kind: str        # dense | moe
    n_layers: int


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.is_ssm or cfg.is_hybrid:
        raise NotImplementedError(
            f"{cfg.name}: Mamba2/Zamba2 models arrive with the SSM slice of "
            "the port (with the ssd_scan kernel)")
    if cfg.attention_kind != "mla":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.attention_kind} attention arrives with the "
            "GQA-attention and dense-architecture slice of the port")
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend arrives with the "
            "frontends slice of the port")


def build_plan(cfg: ModelConfig) -> List[Segment]:
    _check_supported(cfg)
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
    """One transformer layer: MLA attention, then the MLP or the MoE."""

    def __init__(self, cfg: ModelConfig, kind: str, device: torch.device,
                 dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kind = kind
        self.attn = mla_mod.init_mla_params(cfg, device, dtype, generator)
        if kind == "moe":
            self.moe = moe_mod.init_moe_params(cfg, device, dtype, generator)
        else:
            self.mlp = MLP(cfg, device, dtype, generator)


class Model(nn.Module):
    """All weights of a model: embedding, per-segment layer lists, final
    norm and LM head. Built uninitialized without a generator (for
    :mod:`repro_torch.convert` to load into)."""

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


def embed_inputs(params: Model, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return params.embed[batch["tokens"]]


def unembed(params: Model, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head


# ---------------------------------------------------------------------------
# Per-layer blocks
# ---------------------------------------------------------------------------


def _attn_block_prefill(pl_attn, x, cfg, positions):
    h = rms_norm(x, pl_attn.ln, cfg.norm_eps)
    out, latent = mla_mod.mla_prefill(pl_attn, h, cfg, positions)
    return x + out, latent


def _mlp_block(pl_mlp, x, cfg):
    h = rms_norm(x, pl_mlp.ln, cfg.norm_eps)
    return x + swiglu(h, pl_mlp.w_gate, pl_mlp.w_up, pl_mlp.w_down)


def _moe_block(pl_moe, x, cfg, moe_fn: MoeFn):
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
    dev = resolve_device(device)
    return {seg.name: {
        "mla": mla_mod.make_mla_cache(cfg, seg.n_layers, batch, capacity,
                                      dtype, dev),
        "length": torch.zeros((), dtype=torch.int32, device=dev)}
        for seg in build_plan(cfg)}


def cache_batch_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Batch-axis index of every cache leaf, in the make_caches structure
    (None = unbatched bookkeeping leaf, e.g. the length)."""
    return {seg.name: {"mla": 1, "length": None} for seg in build_plan(cfg)}


def _with_lengths(cfg: ModelConfig, caches: Dict[str, Any],
                  length: torch.Tensor) -> Dict[str, Any]:
    """Caches with every bookkeeping ``length`` leaf set to ``length``
    (decode carries per-slot (B,) lengths)."""
    out = dict(caches)
    for seg in build_plan(cfg):
        out[seg.name] = {**out[seg.name], "length": length}
    return out


def _cache_capacity(cfg: ModelConfig, caches: Dict[str, Any]) -> int:
    """Token capacity of the tightest sequence buffer."""
    return min(caches[seg.name]["mla"].shape[2] for seg in build_plan(cfg))


def _as_len(value, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Decode step (one new token per request)
# ---------------------------------------------------------------------------


def decode_step(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
                caches: Dict[str, Any], cache_len,
                moe_fn: Optional[MoeFn] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: (B, 1) int. Writes each layer's new latent entry into
    ``caches`` in place at ``cache_len`` (scalar or (B,)) and returns
    (logits (B, V), caches with ``length = cache_len + 1``)."""
    moe_fn = moe_fn or moe_mod.moe_capacity
    x = params.embed[tokens].to(_dtype(cfg))                    # (B,1,D)
    cache_len = _as_len(cache_len, x.device)
    new_caches: Dict[str, Any] = {}
    for seg in build_plan(cfg):
        mla_cache = caches[seg.name]["mla"]
        for li, blk in enumerate(params.segments[seg.name]):
            hin = rms_norm(x, blk.attn.ln, cfg.norm_eps)
            out, _ = mla_mod.mla_decode(blk.attn, hin, mla_cache[li],
                                        cache_len, cfg)
            x = _ffn(blk, x + out, cfg, moe_fn)
        new_caches[seg.name] = {"mla": mla_cache, "length": cache_len + 1}
    logits = unembed(params, cfg, x[:, 0:1, :])[:, 0, :]
    return logits, new_caches


# ---------------------------------------------------------------------------
# Multi-step greedy decode (the serving fast path)
# ---------------------------------------------------------------------------


def _rows_at(cfg: ModelConfig, caches, cache_len: torch.Tensor):
    """Each slot's latent rows at its write position (clamped into the
    buffer), for restoring frozen slots after a step."""
    saved = {}
    for seg in build_plan(cfg):
        t = caches[seg.name]["mla"]
        idx = cache_len.clamp(max=t.shape[2] - 1).long()
        rows = torch.arange(t.shape[1], device=t.device)
        saved[seg.name] = (rows, idx, t[:, rows, idx].clone())
    return saved


def _restore_frozen(cfg: ModelConfig, caches, saved, live: torch.Tensor):
    for seg in build_plan(cfg):
        t = caches[seg.name]["mla"]
        rows, idx, old = saved[seg.name]
        t[:, rows, idx] = torch.where(live[None, :, None], t[:, rows, idx], old)


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
    slot's entry in place; a frozen slot's overwritten row is restored.)

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
    tok = tokens.to(torch.int32)
    emitted, lives = [], []
    for _ in range(n_steps):
        live = (steps_left > 0) & (cache_len < cap)
        saved = _rows_at(cfg, caches, cache_len)
        logits, caches = step_fn(tok[:, None], caches, cache_len)
        _restore_frozen(cfg, caches, saved, live)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        tok = torch.where(live, nxt, tok)
        cache_len = cache_len + live.to(torch.int32)
        steps_left = steps_left - live.to(torch.int32)
        caches = _with_lengths(cfg, caches, cache_len)
        emitted.append(nxt)
        lives.append(live)
    return (torch.stack(emitted, 1), torch.stack(lives, 1), tok, caches,
            cache_len)


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
    chunk. Returns (logits (B, S, V), caches)."""
    moe_fn = moe_fn or moe_mod.moe_capacity
    x = params.embed[tokens].to(_dtype(cfg))
    s = x.shape[1]
    offset = _as_len(offset, x.device)
    new_caches: Dict[str, Any] = {}
    for seg in build_plan(cfg):
        mla_cache = caches[seg.name]["mla"]
        for li, blk in enumerate(params.segments[seg.name]):
            hin = rms_norm(x, blk.attn.ln, cfg.norm_eps)
            out, _ = mla_mod.mla_extend(blk.attn, hin, mla_cache[li], offset,
                                        cfg)
            x = _ffn(blk, x + out, cfg, moe_fn)
        new_caches[seg.name] = {"mla": mla_cache, "length": offset + s}
    return unembed(params, cfg, x), new_caches


# ---------------------------------------------------------------------------
# Prefill (full sequence + cache materialization)
# ---------------------------------------------------------------------------


def prefill(params: Model, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            capacity: int, moe_fn: Optional[MoeFn] = None,
            cache_dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt; return (logits (B,S,V), caches padded to capacity)."""
    moe_fn = moe_fn or moe_mod.moe_capacity
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    if s > capacity:
        raise ValueError(f"prompt of {s} tokens exceeds the cache capacity "
                         f"{capacity}")
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    caches = make_caches(cfg, b, capacity, cache_dtype, x.device)
    for seg in build_plan(cfg):
        buf = caches[seg.name]["mla"]
        for li, blk in enumerate(params.segments[seg.name]):
            x, latent = _attn_block_prefill(blk.attn, x, cfg, positions)
            buf[li, :, :s] = latent.to(cache_dtype)
            x = _ffn(blk, x, cfg, moe_fn)
        caches[seg.name]["length"] = torch.tensor(s, dtype=torch.int32,
                                                  device=x.device)
    return unembed(params, cfg, x), caches
