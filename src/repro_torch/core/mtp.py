"""Multiple-Token Prediction (paper §4.2.4) with sampling on the device.

DeepSeek-style MTP: a lightweight draft head predicts one speculative token
per decode step; the next step validates it against the main model. The
paper removes the two host-side pipeline breaks of an MTP iteration
(metadata initialization and sampling); here every per-request length and
the sampling (sort / cumsum / filter, or argmax) stay tensors on the
device, so an iteration reads nothing back to the host.

* :func:`mtp_step` -- one batched MTP iteration: base and speculative token
  through the main model, per-request acceptance, ``1 + accepted`` tokens
  emitted. Rejected speculative cache rows are overwritten by the next
  iteration's base write.
* ``fused_verify=True`` -- base and draft run through the main model in ONE
  two-token teacher-forced forward (:func:`verify_pair`, over
  ``prefill_continue`` with per-request offsets) instead of two decode
  steps: one pass over the weights per iteration.
* :func:`repro_torch.models.model.decode_loop_mtp` -- N iterations per host
  sync with per-slot freezing (the serving fast path).
* :func:`fit_draft_head` distills a draft head on the base model's own
  greedy continuations, so measured acceptance reflects the mechanism
  rather than an untrained head.

Where the JAX package takes a PRNG key, these functions take a
``torch.Generator`` (greedy paths ignore it).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as model_mod
from repro_torch.models.layers import rms_norm, weight


class MTPHead(nn.Module):
    """Draft head: combine the last hidden state with the next token's
    embedding into logits (DeepSeek's MTP module distilled to one
    projection block). Weights in the JAX layout: ``ln`` (D,), ``mix``
    (2D, D), ``proj`` (D, D)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.d_model
        dtype = getattr(torch, cfg.dtype)
        self.ln = weight((d,), dtype, device, generator, "ones")
        self.mix = weight((2 * d, d), dtype, device, generator)
        self.proj = weight((d, d), dtype, device, generator)


def init_mtp_params(cfg: ModelConfig, *, seed: int = 0,
                    device: DeviceLike = None) -> MTPHead:
    """A random draft head from ``seed``, made on ``device`` (CUDA unless
    the caller names another)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return MTPHead(cfg, dev, gen)


# ---------------------------------------------------------------------------
# Sampling on the device
# ---------------------------------------------------------------------------


def top_p_filter(logits: torch.Tensor, temperature: float = 0.6,
                 top_p: float = 0.95
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The nucleus filter of :func:`sample_top_p`: (filtered scaled logits
    (B, V) f32 with dropped tokens at -1e30, cutoff index (B, 1) into the
    descending sort).

    The filter always keeps at least one token per row: the cutoff index
    is clamped to V-1, so ``top_p >= 1.0`` (every prefix mass can stay
    below top_p) keeps the whole vocabulary instead of indexing out of
    bounds, and the ``>= cutoff`` comparison keeps the top token even when
    its mass alone exceeds ``top_p``."""
    logits = logits.float() / max(temperature, 1e-6)
    v = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # keep the smallest prefix with cumulative mass >= top_p (>= 1 token)
    cutoff_idx = torch.clamp((cum < top_p).sum(-1, keepdim=True), max=v - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    return torch.where(logits >= cutoff, logits, -1e30), cutoff_idx


def _uniform(shape, generator: Optional[torch.Generator],
             device: torch.device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def sample_top_p(logits: torch.Tensor, temperature: float = 0.6,
                 top_p: float = 0.95,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Nucleus sampling on the device: sort -> cumsum -> filter -> Gumbel
    argmax. logits (B, V) -> (B,) int32. Temperature and top-p default to
    the paper's DeepSeek-R1 settings (§5.3)."""
    filtered, _ = top_p_filter(logits, temperature, top_p)
    u = _uniform(filtered.shape, generator, filtered.device)
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    return torch.argmax(filtered + g, dim=-1).to(torch.int32)


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# MTP decode iteration
# ---------------------------------------------------------------------------


def draft_logits(params: model_mod.Model, mtp: Any, cfg: ModelConfig,
                 hidden: torch.Tensor, next_tok: torch.Tensor
                 ) -> torch.Tensor:
    """hidden: (B, D) final hidden of the base token; next_tok: (B,)
    sampled. ``mtp`` is anything with ``ln``, ``mix`` and ``proj``."""
    emb = params.embed[next_tok].to(hidden.dtype)
    h = torch.cat([rms_norm(hidden, mtp.ln, cfg.norm_eps), emb], dim=-1)
    h = F.silu(h @ mtp.mix)
    h = h @ mtp.proj
    return model_mod.unembed(params, cfg, h)


def propose_draft(params: model_mod.Model, mtp: Any, cfg: ModelConfig,
                  token: torch.Tensor) -> torch.Tensor:
    """Draft the successor of ``token`` (B,) -> (B,)."""
    hidden = params.embed[token].to(getattr(torch, cfg.dtype))
    return sample_greedy(draft_logits(params, mtp, cfg, hidden, token))


def can_fuse_verify(cfg: ModelConfig, capacity: int) -> bool:
    """Is the one-forward base+draft verification available? It needs a
    token-addressable, non-ring cache (exactly
    :func:`repro_torch.models.model.supports_prefill_continue`)."""
    return model_mod.supports_prefill_continue(cfg, capacity)


def verify_pair(params: model_mod.Model, cfg: ModelConfig,
                x_prev: torch.Tensor, d_prev: torch.Tensor,
                caches: Dict[str, Any], cache_len: torch.Tensor,
                moe_fn=None
                ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """Fused verification: run (x_prev, d_prev) at per-request positions
    (cache_len, cache_len+1) through the main model in ONE teacher-forced
    forward. Returns (logits1 (B,V), logits2 (B,V), caches); logits1 scores
    the successor of x_prev, logits2 the successor of d_prev."""
    pair = torch.stack([x_prev, d_prev], dim=1)              # (B, 2)
    logits, caches = model_mod.prefill_continue(params, cfg, pair, caches,
                                                cache_len, moe_fn)
    return logits[:, 0, :], logits[:, 1, :], caches


def mtp_step(params: model_mod.Model, mtp: Any, cfg: ModelConfig,
             x_prev: torch.Tensor, d_prev: torch.Tensor,
             caches: Dict[str, Any], cache_len: torch.Tensor,
             generator: Optional[torch.Generator] = None, moe_fn=None,
             greedy: bool = True, fused_verify: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, Dict[str, Any], torch.Tensor]:
    """One MTP iteration (k=1 speculative decode).

    Carry: ``x_prev`` (B,) -- the last committed token, whose cache entry
    is not written yet, at per-request positions ``cache_len`` (B,); and
    ``d_prev`` (B,) -- last iteration's draft of x_prev's successor.

      f1 = decode(x_prev, len)   -> logits1; row len   = x_prev (always right)
      f2 = decode(d_prev, len+1) -> logits2; row len+1 = d_prev (speculative)
      y1 = sample(logits1)        -- the true token at len+1 (emitted)
      accepted = (y1 == d_prev)   -- speculation validated
      y2 = sample(logits2)        -- the token at len+2, valid iff accepted

    Accepted requests emit 2 tokens and advance 2; rejected ones emit 1 and
    advance 1, and their stale row len+1 is overwritten next iteration.
    With ``fused_verify`` both forwards are one two-token pass
    (:func:`verify_pair`; needs :func:`can_fuse_verify`; its float
    reduction order differs from the two-step form). The caches are written
    in place. Returns (emitted (B,2), accepted (B,), x_next, d_next,
    caches, new_len)."""
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=x_prev.device)
    if cache_len.ndim == 0:
        cache_len = cache_len.expand(x_prev.shape[0])
    if fused_verify:
        logits1, logits2, caches = verify_pair(params, cfg, x_prev, d_prev,
                                               caches, cache_len, moe_fn)
    else:
        logits1, caches = model_mod.decode_step(params, cfg, x_prev[:, None],
                                                caches, cache_len, moe_fn)
        logits2, caches = model_mod.decode_step(params, cfg, d_prev[:, None],
                                                caches, cache_len + 1, moe_fn)
    y1 = sample_greedy(logits1) if greedy else \
        sample_top_p(logits1, generator=generator)
    accepted = y1 == d_prev
    y2 = sample_greedy(logits2) if greedy else \
        sample_top_p(logits2, generator=generator)
    emitted = torch.stack([y1, y2], dim=1)
    x_next = torch.where(accepted, y2, y1)
    d_next = propose_draft(params, mtp, cfg, x_next)
    new_len = cache_len + 1 + accepted.to(torch.int32)
    return emitted, accepted, x_next, d_next, caches, new_len


# ---------------------------------------------------------------------------
# Draft-head distillation
# ---------------------------------------------------------------------------


def fit_draft_head(params: model_mod.Model, cfg: ModelConfig, mtp: MTPHead,
                   generator: Optional[torch.Generator] = None, *,
                   prompts=None, n_seq: int = 16, prompt_len: int = 12,
                   gen_len: int = 32, steps: int = 300, lr: float = 3e-3,
                   moe_fn=None) -> MTPHead:
    """Distill the draft head against the base model's own greedy
    continuations of ``prompts`` (random prompts from ``generator`` when
    omitted).

    A random base model's successor map is context-specific, so pass the
    *serving* prompts for a meaningful acceptance. The head is trained by
    ``torch.autograd`` with the JAX package's in-repo Adam (moments in the
    head's dtype, bias correction by the step ``t``, learning rate ``lr``);
    the base ``params`` stay frozen. Returns a new head."""
    dev = params.embed.device
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, (n_seq, prompt_len),
                                generator=generator, device=dev)
    elif not isinstance(prompts, torch.Tensor):
        prompts = torch.from_numpy(np.asarray(prompts, np.int32))
    prompts = prompts.to(dev, torch.int32)
    n_seq, prompt_len = prompts.shape
    capacity = prompt_len + gen_len + 2
    with torch.no_grad():
        logits, caches = model_mod.prefill(params, cfg, {"tokens": prompts},
                                           capacity, moe_fn,
                                           cache_dtype=torch.float32)
        tok0 = torch.argmax(logits[:, -1], -1).to(torch.int32)
        del logits
        cl0 = torch.full((n_seq,), prompt_len, dtype=torch.int32, device=dev)
        em, _, _, _, _ = model_mod.decode_loop(params, cfg, tok0, caches, cl0,
                                               gen_len, moe_fn=moe_fn)
        del caches
    seq = torch.cat([tok0[:, None], em], dim=1)              # (n_seq, G+1)
    cur = seq[:, :-1].reshape(-1)
    nxt = seq[:, 1:].reshape(-1).long()
    hidden = params.embed[cur].to(getattr(torch, cfg.dtype))

    names = ("ln", "mix", "proj")
    head = {k: getattr(mtp, k).detach().clone() for k in names}
    mu = {k: torch.zeros_like(v) for k, v in head.items()}
    nu = {k: torch.zeros_like(v) for k, v in head.items()}

    for t in range(1, steps + 1):
        leaves = SimpleNamespace(**{k: head[k].requires_grad_(True)
                                    for k in names})
        with torch.enable_grad():
            lg = draft_logits(params, leaves, cfg, hidden, cur).float()
            loss = torch.mean(torch.logsumexp(lg, dim=-1)
                              - lg.gather(-1, nxt[:, None])[:, 0])
            grads = torch.autograd.grad(loss, [head[k] for k in names])
        # The bias corrections are float32, as the JAX package's jitted step
        # computes them from a float32 ``t``, and so is the update, which
        # is then rounded to the head's dtype.
        c1 = float(np.float32(1) - np.float32(0.9) ** np.float32(t))
        c2 = float(np.float32(1) - np.float32(0.999) ** np.float32(t))
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = head[k].detach()
                mu[k] = 0.9 * mu[k] + 0.1 * g
                nu[k] = 0.999 * nu[k] + 0.001 * g * g
                head[k] = (p.float() - lr * (mu[k].float() / c1)
                           / (torch.sqrt(nu[k].float() / c2) + 1e-8)
                           ).to(p.dtype)
    out = MTPHead(cfg, dev)
    with torch.no_grad():
        for k in names:
            getattr(out, k).copy_(head[k])
    return out
