"""PDC peer-to-peer serving engines (paper §4.1).

Three independently scalable pools, communicating only via explicit KV
interfaces:

* :class:`PrefillEngine`  -- prompt processing + EMS context-cache reuse/store
  (reused prefixes skip computation; suffixes run with position offsets).
* :class:`DecodeEngine`   -- continuous-batched autoregressive decode over
  fixed slots whose allocation/eviction and per-request ``cache_len``
  accounting live in :class:`~repro_torch.serving.scheduler.DecodeSlotManager`;
  optional MTP speculative decoding and two-microbatch interleaving
  (:class:`~repro_torch.serving.scheduler.MicrobatchInterleaver`).
* :class:`ServingSystem`  -- the peer-to-peer glue. Every scheduling
  *decision* (prefill routing policy, SLO admission control, trace/clock
  bookkeeping) is delegated to :class:`~repro_torch.serving.scheduler.Scheduler`;
  this class only moves tensors: run prefill, hand KV off over the
  RDMA-plane transfer engine, insert into decode slots, step decode.

The JAX package ``jit``s each step and donates the cache buffers; here the
steps run eagerly on the engines' device and update the caches in place.
Every engine runs on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mtp as mtp_mod
from repro_torch.device import DeviceLike, check_on, resolve_device
from repro_torch.mempool.context_cache import ContextCache
from repro_torch.mempool.ems import EMSService
from repro_torch.models import model as model_mod
from repro_torch.serving import cache_ops
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.pool import (DecodePool, DrainError, JointAutoscaler,
                                      PoolAutoscaler, PrefillPool,
                                      make_decode_router)
from repro_torch.serving.scheduler import (
    DecodeSlotManager,
    MicrobatchInterleaver,
    Scheduler,
    SchedulerConfig,
    SlotError,
)
from repro_torch.serving.transfer import KVTransferEngine, TransferError


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival: float = 0.0
    # SLO tier: "interactive" (stringent TPOT budget, protected under
    # overload) or "batch" (relaxed budget; first to degrade).
    slo_class: str = "interactive"


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: List[int]
    reused_tokens: int = 0
    computed_tokens: int = 0
    prefill_instance: int = -1
    transfer_seconds: float = 0.0
    decode_iters: int = 0
    shed: bool = False
    slo_class: str = "interactive"


def _set(t: torch.Tensor, i: int, value) -> torch.Tensor:
    """``t`` with element ``i`` replaced, as a new tensor (the JAX
    ``.at[i].set`` the engines use; the old tensor may still be referenced
    as a cache ``length`` leaf)."""
    t = t.clone()
    t[i] = value
    return t


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


class PrefillEngine:
    #: tokens per prefill_continue call on the EMS-reuse suffix path (the
    #: tail chunk is padded to this length, so every call has one shape).
    SUFFIX_CHUNK = 32

    def __init__(self, params, cfg: ModelConfig, capacity: int,
                 context_cache: Optional[ContextCache] = None,
                 instance_id: int = 0, moe_fn=None,
                 prefill_chunk: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        check_on(self.device, params.embed, "params")
        self.params, self.cfg, self.capacity = params, cfg, capacity
        self.cc = context_cache
        self.instance_id = instance_id
        self.moe_fn = moe_fn
        # EMS device-tier tag: blocks this instance computes land (dirty)
        # in its own HBM tier and write back to the shared pool async.
        self._ems_tag = f"prefill{instance_id}"
        self.load = 0  # in-flight prompt tokens (scheduler signal)
        # Fresh prompts, when set, run through chunked prefill_continue
        # calls of this width (offset 0 on a fresh cache == prefill).
        # Fresh-path and EMS-suffix dispatches are counted separately.
        self.prefill_chunk = prefill_chunk
        self.continue_calls = 0            # fresh-path dispatches
        self.continue_widths: set = set()  # fresh-path call widths
        self.suffix_calls = 0              # EMS-suffix dispatches
        self.suffix_widths: set = set()
        self._chunkable = model_mod.supports_prefill_continue(cfg, capacity)

    def _fresh_cache(self):
        return model_mod.make_caches(self.cfg, 1, self.capacity,
                                     torch.float32, self.device)

    @property
    def continue_cache_hit_rate(self) -> float:
        """Fraction of fresh-path chunked-prefill dispatches that reuse an
        already seen call width (1 - distinct widths / calls)."""
        if not self.continue_calls:
            return float("nan")
        return 1.0 - len(self.continue_widths) / self.continue_calls

    def _continue_chunks(self, tokens, caches, pos: int, chunk: int,
                         fresh: bool):
        """Feed ``tokens`` at positions ``pos..`` through prefill_continue
        calls of bounded width ``chunk`` (tail padded, so every call has one
        of few shapes). Returns (last_logits_row, caches, end_pos); padded
        positions land beyond the final cache_len, so decode overwrites
        them before they are ever attendable."""
        if pos + len(tokens) > self.capacity:
            raise ValueError(
                f"prompt run of {len(tokens)} tokens at offset {pos} "
                f"exceeds the prefill cache capacity {self.capacity}")
        st, last = 0, None
        while st < len(tokens):
            # Call width: the chunk, clamped to the cache headroom so the
            # padded write never overruns the static capacity buffer.
            width = min(chunk, self.capacity - pos)
            part = tokens[st:st + width]
            toks = torch.tensor([list(part) + [0] * (width - len(part))],
                                dtype=torch.int32, device=self.device)
            if fresh:
                self.continue_calls += 1
                self.continue_widths.add(width)
            else:
                self.suffix_calls += 1
                self.suffix_widths.add(width)
            logits, caches = model_mod.prefill_continue(
                self.params, self.cfg, toks, caches, pos, self.moe_fn)
            pos += len(part)
            st += len(part)
            last = logits[0, len(part) - 1]
        return last, caches, pos

    def run(self, req: Request) -> Tuple[int, Any, RequestResult]:
        """Process one prompt. Returns (first_token, caches(B=1), result)."""
        prompt = list(req.prompt)
        cfg = self.cfg
        res = RequestResult(req.rid, [], prefill_instance=self.instance_id)
        self.load += len(prompt)
        try:
            reuse_len = 0
            caches = None
            if self.cc is not None and cfg.attention_kind != "none" \
                    and not cfg.is_hybrid:
                reuse_len, keys = self.cc.match_prefix(prompt)
                reuse_len = min(reuse_len, len(prompt) - 1)
                reuse_len -= reuse_len % self.cc.block
                keys = keys[: reuse_len // self.cc.block]
                if reuse_len > 0:
                    # Resolve through the cache service (EMS: engine-HBM
                    # tier first, then pooled tier with an RDMA promote). A
                    # block evicted between match and fetch shortens the
                    # returned prefix: shrink the reuse and recompute the
                    # rest.
                    flats = self.cc.fetch(keys, engine=self._ems_tag)
                    if len(flats) < len(keys):
                        reuse_len = len(flats) * self.cc.block
                    if reuse_len > 0:
                        caches = self._fresh_cache()
                        tmpl = cache_ops.seq_slice(cfg, caches, 0,
                                                   self.cc.block)
                        for bi, flat in enumerate(flats):
                            payload = cache_ops.unpack_payload(flat, tmpl)
                            caches = cache_ops.seq_insert(
                                cfg, caches, payload, bi * self.cc.block)
            if reuse_len > 0:
                # Suffix-only computation: teacher-forced continuation from
                # the reused prefix (positions offset by reuse_len), in
                # chunked prefill_continue calls (a cache that
                # prefill_continue cannot serve takes the token loop).
                if not self._chunkable:
                    logits = None
                    cl = torch.tensor(reuse_len, dtype=torch.int32,
                                      device=self.device)
                    for tok in prompt[reuse_len:]:
                        t = torch.full((1, 1), tok, dtype=torch.int32,
                                       device=self.device)
                        logits, caches = model_mod.decode_step(
                            self.params, cfg, t, caches, cl, self.moe_fn)
                        cl = cl + 1
                    last = logits[0]
                else:
                    last, caches, _ = self._continue_chunks(
                        prompt[reuse_len:], caches, reuse_len,
                        self.SUFFIX_CHUNK, fresh=False)
                res.computed_tokens = len(prompt) - reuse_len
            elif self.prefill_chunk and self._chunkable:
                caches = self._fresh_cache()
                last, caches, _ = self._continue_chunks(
                    prompt, caches, 0, self.prefill_chunk, fresh=True)
                res.computed_tokens = len(prompt)
            else:
                batch = {"tokens": torch.tensor([prompt], dtype=torch.int32,
                                                device=self.device)}
                logits, caches = model_mod.prefill(
                    self.params, cfg, batch, self.capacity, self.moe_fn,
                    cache_dtype=torch.float32)
                last = logits[0, len(prompt) - 1]
                res.computed_tokens = len(prompt)
            first = int(torch.argmax(last))
            res.reused_tokens = reuse_len

            # Store newly computed full blocks back to EMS (async in the
            # real system): one slice and one host copy build every block.
            if self.cc is not None and cfg.attention_kind != "none" \
                    and not cfg.is_hybrid:
                n_blocks = len(prompt) // self.cc.block
                payloads = cache_ops.pack_blocks(cfg, caches, n_blocks,
                                                 self.cc.block)
                if payloads:
                    self.cc.store(prompt[: n_blocks * self.cc.block],
                                  payloads, engine=self._ems_tag)
            return first, caches, res
        finally:
            self.load -= len(prompt)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Slot:
    """Engine-side per-request payload riding in the slot manager."""
    remaining: int
    result: RequestResult


class DecodeEngine:
    def __init__(self, params, cfg: ModelConfig, max_batch: int, capacity: int,
                 moe_fn=None, use_mtp: bool = False, mtp_params=None, seed=0,
                 interleave: bool = False, n_micro: int = 2,
                 decode_chunk: int = 1, mtp_fused: bool = False,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        check_on(self.device, params.embed, "params")
        self.params, self.cfg = params, cfg
        self.b, self.capacity = max_batch, capacity
        self.moe_fn = moe_fn
        self.use_mtp = use_mtp
        self.mtp_params = mtp_params
        self.decode_chunk = max(1, int(decode_chunk))
        self.mtp_fused = bool(mtp_fused) and use_mtp
        if self.mtp_fused and not mtp_mod.can_fuse_verify(cfg, capacity):
            warnings.warn("fused MTP verification needs a causal/MLA "
                          "non-ring cache; falling back to the two-forward "
                          "verify", stacklevel=2)
            self.mtp_fused = False
        self.cache_len = torch.zeros((max_batch,), dtype=torch.int32,
                                     device=self.device)
        # In the dtypes decode produces (the SSM conv window of an f32 model
        # turns f32), so every step writes the slots in place.
        self.caches = model_mod._with_lengths(
            cfg, model_mod.decode_ready_caches(cfg, model_mod.make_caches(
                cfg, max_batch, capacity, torch.float32, self.device)),
            self.cache_len)
        self.cur_tok = torch.zeros((max_batch,), dtype=torch.int32,
                                   device=self.device)
        self.draft_tok = torch.zeros_like(self.cur_tok)
        self.slot_mgr = DecodeSlotManager(max_batch, capacity)
        self.iters = 0
        interleaver = MicrobatchInterleaver(n_micro if interleave else 1)
        # Hybrid caches nest SSM state with batch on axis 2, which the
        # microbatch split (batch = axis 1 for rank>=3) would mis-slice.
        self.interleaved = (interleaver.applicable(max_batch)
                            and not use_mtp and not cfg.is_hybrid)
        if interleave and not self.interleaved:
            if use_mtp:
                reason = "MTP speculative decoding steps are not interleavable"
            elif cfg.is_hybrid:
                reason = ("hybrid-architecture caches are not microbatch-"
                          "splittable (SSM state batch axis)")
            elif n_micro < 2:
                reason = f"n_micro={n_micro} means no pairing"
            else:
                reason = (f"max_batch={max_batch} is not divisible by "
                          f"n_micro={n_micro}")
            warnings.warn("decode microbatch interleaving requested but "
                          f"disabled: {reason}", stacklevel=2)

        def base(t, c, l):
            return model_mod.decode_step(params, cfg, t, c, l, moe_fn)

        self._step_fn = interleaver.wrap(base, max_batch) \
            if self.interleaved else base

        # Continuous batching picks each dispatch's width from a small
        # ladder (powers of two up to decode_chunk, plus decode_chunk).
        self._chunk_widths = sorted(
            {w for w in (1 << p for p in range(self.decode_chunk.bit_length()))
             if w <= self.decode_chunk} | {self.decode_chunk})
        # Dead-slot observability: slot-iterations the device spent on
        # live vs resident-but-masked slots across this engine's lifetime.
        self.live_slot_iters = 0
        self.dead_slot_iters = 0

    def _effective_chunk(self, refill_pending: bool) -> int:
        """Continuous batching: the width of the next dispatch.

        Shrink from ``decode_chunk`` to where the next host sync can do
        useful work: ``min(remaining)`` across active slots (under MTP a
        slot needs at least ceil(remaining/2) iterations, so that is the
        bound), and width 1 when an admission is pending and a slot is
        free, so the refill lands at the earliest sync. The result snaps
        DOWN to the width ladder -- never up, so no masked tail is
        dispatched on purpose."""
        k = self.decode_chunk
        lefts = [info.payload.remaining
                 for _, info in self.slot_mgr.active_slots()]
        if lefts:
            m = min(lefts)
            need = max(1, (m + 1) // 2) if self.use_mtp else max(1, m)
            k = min(k, need)
        if refill_pending and self.slot_mgr.free > 0:
            k = 1
        for w in reversed(self._chunk_widths):
            if w <= k:
                return w
        return 1

    def free_slot(self) -> Optional[int]:
        return self.slot_mgr.free_slot()

    def add(self, slot: int, req_cache, first_token: int, prompt_len: int,
            result: RequestResult, max_new: int) -> None:
        self.slot_mgr.allocate(result.rid, prompt_len,
                               payload=_Slot(max_new - 1, result), slot=slot)
        self.caches = cache_ops.insert_request(self.cfg, self.caches,
                                               req_cache, slot)
        self.cache_len = _set(self.cache_len, slot, prompt_len)
        self.cur_tok = _set(self.cur_tok, slot, first_token)
        result.tokens.append(first_token)
        if self.use_mtp:
            d = mtp_mod.propose_draft(self.params, self.mtp_params, self.cfg,
                                      self.cur_tok[slot: slot + 1])
            self.draft_tok = _set(self.draft_tok, slot, d[0])

    @property
    def active(self) -> int:
        return self.slot_mgr.active

    def export_slot(self, slot: int) -> Tuple[np.ndarray, int, int, int]:
        """Drain one active slot's device state for cross-engine migration:
        (packed cache bytes, cache_len, cur_tok, draft_tok). The cache rows
        are serialized byte-exactly via :func:`cache_ops.pack_request`."""
        info = self.slot_mgr.get(slot)
        if info is None:
            raise SlotError(f"export of empty slot {slot}")
        req_slice = cache_ops.slice_request(self.cfg, self.caches, slot)
        return (cache_ops.pack_request(self.cfg, req_slice),
                int(self.cache_len[slot]), int(self.cur_tok[slot]),
                int(self.draft_tok[slot]))

    def import_slot(self, slot: int, flat: np.ndarray, cache_len: int,
                    cur_tok: int, draft_tok: int, rid: int,
                    payload: Any) -> None:
        """Land a migrated request on ``slot``: allocate the slot with the
        engine-side payload that traveled with it, then unpack the drained
        cache bytes against this engine's own layout and insert them."""
        self.slot_mgr.allocate(rid, cache_len, payload=payload, slot=slot)
        template = cache_ops.slice_request(self.cfg, self.caches, slot)
        req_cache = cache_ops.unpack_request(self.cfg, flat, template)
        self.caches = cache_ops.insert_request(self.cfg, self.caches,
                                               req_cache, slot)
        self.cache_len = _set(self.cache_len, slot, cache_len)
        self.cur_tok = _set(self.cur_tok, slot, cur_tok)
        self.draft_tok = _set(self.draft_tok, slot, draft_tok)

    def step(self) -> List[RequestResult]:
        """One host-sync decode turn. Returns requests finished this turn."""
        return self.step_chunk()[0]

    def step_chunk(self, continuous: bool = False,
                   refill_pending: bool = False
                   ) -> Tuple[List[RequestResult],
                              List[Tuple[List[int], List[int],
                                         dict, List[int]]]]:
        """One host-sync decode turn: ``decode_chunk`` device iterations
        per call on the fast path (one otherwise). ``continuous`` enables
        adaptive width (:meth:`_effective_chunk`); ``refill_pending`` then
        signals a gate-held admission that could land in a free slot.

        Returns ``(finished, iter_log)``; ``iter_log`` holds one
        ``(live_rids, finished_rids, tokens_by_rid, masked_rids)`` entry
        per device iteration dispatched, so the scheduler can attribute
        virtual-clock time per iteration to the slots that did work -- and
        credit the tokens each iteration committed (MTP: 1 + accepted).
        """
        if self.decode_chunk > 1:
            width = (self._effective_chunk(refill_pending) if continuous
                     else self.decode_chunk)
            return (self._step_chunked_mtp(width) if self.use_mtp
                    else self._step_chunked(width))

        self.iters += 1
        active_rids = [info.rid for _, info in self.slot_mgr.active_slots()]
        if self.use_mtp:
            emitted, accepted, x_next, d_next, self.caches, self.cache_len = \
                mtp_mod.mtp_step(self.params, self.mtp_params, self.cfg,
                                 self.cur_tok, self.draft_tok, self.caches,
                                 self.cache_len, moe_fn=self.moe_fn,
                                 fused_verify=self.mtp_fused)
            self.cur_tok, self.draft_tok = x_next, d_next
            # One host read: (B, 3) = emitted pair and acceptance.
            out = torch.cat([emitted, accepted[:, None].to(emitted.dtype)],
                            dim=1).cpu().numpy()
            em, acc = out[:, :2], out[:, 2].astype(bool)
        else:
            logits, self.caches = self._step_fn(self.cur_tok[:, None],
                                                self.caches, self.cache_len)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            self.cache_len = self.cache_len + 1
            self.cur_tok = nxt
            em = nxt.cpu().numpy()[:, None]
            acc = np.zeros(self.b, bool)

        finished = []
        tokens_by_rid: dict = {}
        for i, info in list(self.slot_mgr.active_slots()):
            slot: _Slot = info.payload
            slot.result.decode_iters += 1
            # Mirror the device-side cache growth (MTP appends the accepted
            # draft token too) with capacity enforcement.
            self.slot_mgr.advance(i, 2 if (self.use_mtp and acc[i]) else 1)
            new_toks = [int(em[i, 0])]
            if self.use_mtp and acc[i] and slot.remaining > 1:
                new_toks.append(int(em[i, 1]))
            committed = 0
            for t in new_toks:
                if slot.remaining > 0:
                    slot.result.tokens.append(t)
                    slot.remaining -= 1
                    committed += 1
            tokens_by_rid[info.rid] = committed
            if slot.remaining <= 0:
                finished.append(slot.result)
                self.slot_mgr.release(i)
        # Per-step decode never masks a resident slot (capacity overflow
        # raises in advance() instead) -- the dead-slot set is empty.
        self.live_slot_iters += len(active_rids)
        return finished, [(active_rids, [r.rid for r in finished],
                           tokens_by_rid, [])]

    def _step_chunked(self, width: int) -> Tuple[
            List[RequestResult],
            List[Tuple[List[int], List[int], dict, List[int]]]]:
        """Fast path: ``width`` decode iterations, one host sync. Slot
        accounting is reconciled in DecodeSlotManager.advance as the chunk
        drains, iteration by iteration. A slot resident at dispatch but
        masked at iteration j (finished earlier in the chunk, or
        capacity-frozen) burned a dead device iteration -- logged in
        ``masked_rids``, never charged as live batch occupancy."""
        left = np.zeros((self.b,), np.int32)
        resident = {}                   # slot index -> rid at dispatch time
        for i, info in self.slot_mgr.active_slots():
            left[i] = min(info.payload.remaining, width)
            resident[i] = info.rid
        emitted, live, self.cur_tok, self.caches, self.cache_len = \
            model_mod.decode_loop(
                self.params, self.cfg, self.cur_tok, self.caches,
                self.cache_len, width,
                steps_left=torch.from_numpy(left).to(self.device),
                step_fn=self._step_fn)
        em = emitted.cpu().numpy()
        lv = live.cpu().numpy()

        finished: List[RequestResult] = []
        iter_log: List[Tuple[List[int], List[int], dict, List[int]]] = []
        for j in range(width):
            self.iters += 1
            live_rids: List[int] = []
            masked_rids: List[int] = []
            fin_this: List[RequestResult] = []
            tokens_by_rid: dict = {}
            for i, rid in resident.items():
                if not lv[i, j]:
                    masked_rids.append(rid)
                    continue
                info = self.slot_mgr.get(i)   # live => not yet released
                slot: _Slot = info.payload
                slot.result.decode_iters += 1
                self.slot_mgr.advance(i, 1)
                slot.result.tokens.append(int(em[i, j]))
                slot.remaining -= 1
                live_rids.append(rid)
                tokens_by_rid[rid] = 1
                if slot.remaining <= 0:
                    fin_this.append(slot.result)
                    self.slot_mgr.release(i)
            self.live_slot_iters += len(live_rids)
            self.dead_slot_iters += len(masked_rids)
            iter_log.append((live_rids, [r.rid for r in fin_this],
                             tokens_by_rid, masked_rids))
            finished.extend(fin_this)
        self._raise_if_capacity_frozen(lv)
        return finished, iter_log

    def _step_chunked_mtp(self, width: int) -> Tuple[
            List[RequestResult],
            List[Tuple[List[int], List[int], dict, List[int]]]]:
        """MTP fast path: ``width`` speculative iterations -- up to
        ``2*width`` tokens -- per host sync (one host read of the chunk's
        results). Per-iteration accept/reject ran on the device; here the
        emitted runs are committed slot by slot, mirroring the per-step MTP
        accounting (advance 2 on accept, credit the accepted draft token
        only while the request still wants tokens). Live/masked attribution
        follows the device ``lv`` mask as in :meth:`_step_chunked`."""
        left = np.zeros((self.b,), np.int32)
        resident = {}                   # slot index -> rid at dispatch time
        for i, info in self.slot_mgr.active_slots():
            left[i] = info.payload.remaining
            resident[i] = info.rid
        (emitted, accepted, live, self.cur_tok, self.draft_tok, self.caches,
         self.cache_len) = model_mod.decode_loop_mtp(
            self.params, self.mtp_params, self.cfg, self.cur_tok,
            self.draft_tok, self.caches, self.cache_len, width,
            steps_left=torch.from_numpy(left).to(self.device),
            fused_verify=self.mtp_fused, moe_fn=self.moe_fn)
        # One host read for the chunk: (B, width, 4) = emitted pair,
        # acceptance, liveness.
        out = torch.cat([emitted, accepted[..., None].to(emitted.dtype),
                         live[..., None].to(emitted.dtype)],
                        dim=-1).cpu().numpy()
        em = out[..., :2]               # (B, width, 2)
        acc = out[..., 2].astype(bool)  # (B, width)
        lv = out[..., 3].astype(bool)   # (B, width)

        finished: List[RequestResult] = []
        iter_log: List[Tuple[List[int], List[int], dict, List[int]]] = []
        for j in range(width):
            self.iters += 1
            live_rids: List[int] = []
            masked_rids: List[int] = []
            fin_this: List[RequestResult] = []
            tokens_by_rid: dict = {}
            for i, rid in resident.items():
                if not lv[i, j]:
                    masked_rids.append(rid)
                    continue
                info = self.slot_mgr.get(i)   # live => not yet released
                slot: _Slot = info.payload
                slot.result.decode_iters += 1
                self.slot_mgr.advance(i, 2 if acc[i, j] else 1)
                new_toks = [int(em[i, j, 0])]
                if acc[i, j] and slot.remaining > 1:
                    new_toks.append(int(em[i, j, 1]))
                committed = 0
                for t in new_toks:
                    if slot.remaining > 0:
                        slot.result.tokens.append(t)
                        slot.remaining -= 1
                        committed += 1
                live_rids.append(rid)
                tokens_by_rid[rid] = committed
                if slot.remaining <= 0:
                    fin_this.append(slot.result)
                    self.slot_mgr.release(i)
            self.live_slot_iters += len(live_rids)
            self.dead_slot_iters += len(masked_rids)
            iter_log.append((live_rids, [r.rid for r in fin_this],
                             tokens_by_rid, masked_rids))
            finished.extend(fin_this)
        self._raise_if_capacity_frozen(lv)
        return finished, iter_log

    def _raise_if_capacity_frozen(self, lv: np.ndarray) -> None:
        """Enforce the capacity invariant the masked loop would otherwise
        hide: a slot that still wants tokens but was never live this chunk
        is capacity-frozen -- fail fast like per-step decode does via
        DecodeSlotManager.advance, instead of livelocking."""
        for i, info in list(self.slot_mgr.active_slots()):
            if info.payload.remaining > 0 and not lv[i].any():
                raise SlotError(
                    f"rid={info.rid} cache_len {info.cache_len} has hit the "
                    f"decode capacity {self.slot_mgr.capacity} with "
                    f"{info.payload.remaining} tokens still requested")


# ---------------------------------------------------------------------------
# Peer-to-peer serving system (PDC glue)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _PendingAdmission:
    first: int
    caches: Any
    prompt_len: int
    result: RequestResult
    max_new: int
    block_keys: Tuple[str, ...] = ()
    # Engine-failure recovery: a recovered request re-enters the admission
    # queue with its replay KV ready at an explicit instant (the trace's
    # ready_at property keeps describing the ORIGINAL prefill handoff) and
    # is re-admitted via on_readmit so decode_admit/TTFT stay untouched.
    ready_at: Optional[float] = None
    recovered: bool = False


class ServingSystem:
    """Peer-to-peer PDC pipeline wired through the pluggable scheduler.

    ``policy`` selects the prefill router by name (``least_loaded``,
    ``round_robin``, ``queue_depth``); ``tpot_budget_ms`` + ``admission``
    configure SLO admission control; ``interleave`` pairs two decode
    microbatches per step. ``decode_engines`` > 1 builds a
    :class:`~repro_torch.serving.pool.DecodePool` of identical engines behind a
    ``decode_router`` policy (``least_loaded_slots``, ``round_robin``,
    ``cache_affinity``) with cross-engine KV migration. ``autoscale=True``
    (with ``min_engines``/``max_engines`` clamps) lets a deterministic
    :class:`~repro_torch.serving.pool.PoolAutoscaler` grow the pool mid-wave
    (fresh engine spawn, or revival of a parked one) and shrink it through
    migration-backed retirement; ``decode_engines`` is then the *initial*
    pool size. Pass a full :class:`SchedulerConfig` as ``scheduler_config``
    to override cost-model constants; explicitly passed scheduling kwargs
    still win over the provided config.

    Peer-to-peer PDC additions: ``prefill_engines`` sizes a
    :class:`~repro_torch.serving.pool.PrefillPool` (same spawn/park/retire/fail
    lifecycle as the decode pool, routed over the live roster only);
    ``stream_handoff=True`` replaces the synchronous whole-request KV
    handoff with pipelined chunked streaming (``stream_chunk`` tokens per
    RDMA op, transfer overlapped behind the remaining prefill compute,
    token-identical to the synchronous path); ``joint_autoscale=True`` runs
    a :class:`~repro_torch.serving.pool.JointAutoscaler` that shifts engines
    between the prefill and decode roles under one SLO budget
    (``ttft_budget_ms`` + ``tpot_budget_ms``) inside the
    ``min_prefill``/``max_prefill`` and ``min_engines``/``max_engines``
    clamps.

    ``device`` (CUDA by default; raises when CUDA is absent unless
    ``device="cpu"``) is where every engine runs; ``params`` must live
    there.
    """

    def __init__(self, params, cfg: ModelConfig, *, n_prefill: int = 2,
                 prefill_engines: Optional[int] = None,
                 decode_batch: int = 4, capacity: int = 128,
                 decode_engines: int = 1,
                 decode_router: Optional[str] = None,
                 decode_rebalance_every: Optional[int] = None,
                 autoscale: Optional[bool] = None,
                 min_engines: Optional[int] = None,
                 max_engines: Optional[int] = None,
                 joint_autoscale: Optional[bool] = None,
                 min_prefill: Optional[int] = None,
                 max_prefill: Optional[int] = None,
                 ttft_budget_ms: Optional[float] = None,
                 stream_handoff: Optional[bool] = None,
                 stream_chunk: Optional[int] = None,
                 context_cache: Optional[ContextCache] = None,
                 use_mtp: bool = False, mtp_params=None,
                 mtp_fused: bool = False, moe_fn=None,
                 policy: Optional[str] = None,
                 tpot_budget_ms: Optional[float] = None,
                 admission: Optional[str] = None,
                 interleave: Optional[bool] = None,
                 decode_chunk: Optional[int] = None,
                 continuous_batching: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 degrade_shed_queue_s: Optional[float] = None,
                 batch_tpot_budget_ms: Optional[float] = None,
                 batch_admission: Optional[str] = None,
                 preempt_batch: Optional[bool] = None,
                 brownout: Optional[bool] = None,
                 brownout_patience: Optional[int] = None,
                 brownout_cooldown: Optional[int] = None,
                 hit_aware_admission: Optional[bool] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        check_on(self.device, params.embed, "params")
        self.cfg = cfg
        self.cc = context_cache
        overrides = {k: v for k, v in (
            ("policy", policy), ("tpot_budget_ms", tpot_budget_ms),
            ("admission", admission), ("interleave_microbatches", interleave),
            ("decode_chunk", decode_chunk),
            ("continuous_batching", continuous_batching),
            ("decode_policy", decode_router),
            ("decode_rebalance_every", decode_rebalance_every),
            ("autoscale", autoscale),
            ("min_engines", min_engines), ("max_engines", max_engines),
            ("joint_autoscale", joint_autoscale),
            ("min_prefill", min_prefill), ("max_prefill", max_prefill),
            ("ttft_budget_ms", ttft_budget_ms),
            ("stream_handoff", stream_handoff),
            ("stream_chunk", stream_chunk),
            ("degrade_shed_queue_s", degrade_shed_queue_s),
            ("batch_tpot_budget_ms", batch_tpot_budget_ms),
            ("batch_admission", batch_admission),
            ("preempt_batch", preempt_batch),
            ("brownout", brownout),
            ("brownout_patience", brownout_patience),
            ("brownout_cooldown", brownout_cooldown),
            ("hit_aware_admission", hit_aware_admission),
        ) if v is not None}
        # use_mtp is engine state, not policy: the scheduler's MTP cost
        # accounting must always match what the decode engine actually runs
        # (a provided scheduler_config cannot flip it -- reconfigure_scheduler
        # enforces the same invariant later).
        overrides["use_mtp"] = bool(use_mtp)
        sched_cfg = dataclasses.replace(
            scheduler_config or SchedulerConfig(), **overrides)
        if sched_cfg.autoscale and not (
                sched_cfg.min_engines <= decode_engines
                <= sched_cfg.max_engines):
            raise ValueError(
                f"decode_engines={decode_engines} must start inside the "
                f"autoscale clamp [{sched_cfg.min_engines}, "
                f"{sched_cfg.max_engines}]")
        n_prefill = prefill_engines if prefill_engines is not None \
            else n_prefill
        if sched_cfg.joint_autoscale:
            if not (1 <= sched_cfg.min_prefill <= n_prefill
                    <= sched_cfg.max_prefill):
                raise ValueError(
                    f"prefill_engines={n_prefill} must start inside the "
                    f"joint-autoscale clamp [{sched_cfg.min_prefill}, "
                    f"{sched_cfg.max_prefill}] (min_prefill >= 1)")
            if not (sched_cfg.min_engines <= decode_engines
                    <= sched_cfg.max_engines):
                raise ValueError(
                    f"decode_engines={decode_engines} must start inside the "
                    f"joint-autoscale decode clamp [{sched_cfg.min_engines}, "
                    f"{sched_cfg.max_engines}]")
        if sched_cfg.stream_chunk is not None and sched_cfg.stream_chunk < 1:
            raise ValueError("stream_chunk must be >= 1")
        self.capacity = capacity

        def prefill_factory(i: int) -> PrefillEngine:
            # The joint controller's prefill grow path: an engine identical
            # to the roster's, numbered by its instance id.
            return PrefillEngine(params, cfg, capacity, context_cache,
                                 i, moe_fn, prefill_chunk=prefill_chunk,
                                 device=self.device)

        self.prefill_pool = PrefillPool(
            [prefill_factory(i) for i in range(n_prefill)],
            engine_factory=prefill_factory)
        # Shared list: pool growth is immediately visible to the serve loop.
        self.prefills = self.prefill_pool.engines

        def engine_factory(seed: int) -> DecodeEngine:
            # The autoscaler's grow path: a fresh engine identical to the
            # pool's, numbered by its engine id.
            return DecodeEngine(params, cfg, decode_batch, capacity,
                                moe_fn, use_mtp, mtp_params, seed=seed,
                                interleave=sched_cfg.interleave_microbatches,
                                n_micro=sched_cfg.n_micro,
                                decode_chunk=sched_cfg.decode_chunk,
                                mtp_fused=mtp_fused,
                                device=self.device)

        engines = [engine_factory(e) for e in range(decode_engines)]
        # Affinity routing scores residency against the shared EMS index
        # when the cache is an EMSService; a plain ContextCache keeps the
        # advisory per-engine residency.
        self._ems = context_cache if isinstance(context_cache, EMSService) \
            else None
        self.pool = DecodePool(
            engines, make_decode_router(sched_cfg.decode_policy,
                                        decode_engines, ems=self._ems),
            engine_factory=engine_factory)
        self.decode = engines[0]       # single-engine compatibility alias
        self.faults = fault_injector
        self.transfer = KVTransferEngine(
            fault_hook=None if self.faults is None
            else self.faults.transfer_fault)
        self.scheduler = Scheduler(self.prefill_pool.n, self.pool.slot_mgrs,
                                   sched_cfg)
        # In-flight registry: rid -> original Request, kept from KV handoff
        # until decode finish/shed. Engine-failure recovery needs the
        # prompt and token budget to rebuild a crashed slot by replay
        # re-prefill; nothing else retains them once prefill returns.
        self._inflight: dict = {}

    def reconfigure_scheduler(self, scheduler_config: SchedulerConfig) -> None:
        """Swap policy/SLO configuration between serve() waves without
        rebuilding the engines. Control-plane only: decode microbatch
        interleaving is baked into the engines' step at construction, so a
        config that flips it is rejected."""
        cur = self.scheduler.config
        new = scheduler_config
        if (new.interleave_microbatches != cur.interleave_microbatches
                or (new.interleave_microbatches
                    and new.n_micro != cur.n_micro)):
            raise ValueError(
                "interleave_microbatches/n_micro are baked into the "
                "decode step at ServingSystem construction; build a new "
                "system to change them")
        if new.decode_chunk != cur.decode_chunk:
            raise ValueError(
                "decode_chunk is baked into the decode engines at "
                "ServingSystem construction; build a new system to change it")
        # continuous_batching is deliberately NOT baked: it only picks the
        # width of each decode_loop dispatch.
        if new.use_mtp != self.decode.use_mtp:
            raise ValueError(
                "use_mtp is baked into the decode engine at ServingSystem "
                "construction; build a new system to change it")
        if new.decode_policy != cur.decode_policy:
            # Routing is pure control plane: swap the pool router in place
            # (a fresh policy instance — affinity/cursor state resets).
            self.pool.router = make_decode_router(new.decode_policy,
                                                  self.pool.n,
                                                  ems=self._ems)
        self.scheduler = Scheduler(self.prefill_pool.n, self.pool.slot_mgrs,
                                   scheduler_config)
        # Engine liveness is pool state: carry parked engines (both roles)
        # into the fresh scheduler's views.
        for e, live in enumerate(self.pool.live_mask):
            if not live:
                self.scheduler.set_engine_live(e, False)
        for i, live in enumerate(self.prefill_pool.live_mask):
            if not live:
                self.scheduler.set_prefill_live(i, False)

    def migrate_request(self, rid: int, dst_engine: int) -> float:
        """Force a cross-engine KV migration of an in-flight request (the
        drain is charged to the RDMA-plane transfer engine and recorded on
        the scheduler trace). Returns the virtual drain seconds."""
        trace = self.scheduler.traces.get(rid)
        src_e, _, seconds = self.pool.migrate(rid, dst_engine, self.transfer)
        if trace is not None:
            self.scheduler.on_migrate(trace, src_e, dst_engine, seconds)
        return seconds

    # -- fault tolerance ---------------------------------------------------
    def _apply_faults(self) -> List["_PendingAdmission"]:
        """One injector evaluation: re-assert straggler factors from each
        engine's clock, then fire any due engine crashes (a crash is
        detected at the chunk boundary after its scheduled instant — the
        tokens the engine emitted up to detection were already streamed,
        which is exactly why recovery is teacher-forced replay). Returns
        the recovered admissions, to be requeued at the FRONT of the
        waiting queue (they predate everything still queued)."""
        if self.faults is None:
            return []
        sched = self.scheduler
        for e in range(self.pool.n):
            sched.set_engine_slowdown(
                e, self.faults.slowdown(e, sched.engine_clock(e)))
        clocks = [sched.engine_clock(e) for e in range(self.pool.n)]
        recovered: List[_PendingAdmission] = []
        for e in self.faults.due_crashes(clocks):
            if not self.pool.live_mask[e]:
                continue               # already parked/dead: crash is moot
            recovered.extend(self._fail_engine(e))
        return recovered

    def _fail_engine(self, engine: int) -> List["_PendingAdmission"]:
        """Kill ``engine`` and recover its in-flight requests by replay
        re-prefill. Slot accounting is conserved through the failure
        (``fail_engine`` releases every slot), the scheduler's live mask
        and timeline record the capacity loss, and each lost request comes
        back as a recovered pending admission."""
        sched = self.scheduler
        fail_t = sched.engine_clock(engine)
        lost = self.pool.fail_engine(engine)
        sched.set_engine_live(engine, False)
        sched.on_engine_failure(engine)
        return [self._replay_recover(rid, payload, fail_t)
                for rid, payload, _cache_len in lost]

    def _replay_rebuild(self, rid: int, slot_payload: "_Slot",
                        at: float) -> Tuple["_PendingAdmission", int]:
        """Rebuild an interrupted request's KV: re-prefill its prompt plus
        a teacher-forced replay of every already-emitted token but the last
        (EMS-cached prefix blocks are reused, so mostly only the emitted
        suffix is recomputed), and verify greedy determinism — the replay
        prefill's next-token argmax must reproduce the last emitted token.
        The rebuilt output is therefore token-identical to the
        uninterrupted run by construction, not by luck. Shared by engine-
        failure recovery and batch-tier preemption; returns the pending
        re-admission and the replayed-token count."""
        sched = self.scheduler
        req: Request = self._inflight[rid]
        result = slot_payload.result
        remaining = slot_payload.remaining
        emitted = list(result.tokens)
        if not emitted or remaining <= 0:
            raise SlotError(
                f"rid={rid} interrupted with no emitted token or no budget "
                f"({len(emitted)} emitted, {remaining} remaining) — a live "
                "slot always holds >= 1 token and wants >= 1 more")
        replay = list(req.prompt) + emitted[:-1]
        # Replay runs on a live prefill instance — with a pooled roster the
        # original instance 0 may be parked by the joint controller.
        live = self.prefill_pool.live_ids
        first, caches, rres = self.prefills[live[0] if live else 0].run(
            Request(rid, replay, 1, arrival=at))
        if first != emitted[-1]:
            raise RuntimeError(
                f"replay re-prefill diverged for rid={rid}: argmax after "
                f"teacher-forcing {len(replay)} tokens gave {first}, the "
                f"interrupted engine had emitted {emitted[-1]} — greedy "
                "decode must be deterministic for replay to be token-exact")
        _, prefill_done = sched.charge_recovery_prefill(
            rres.computed_tokens, at)
        # Re-handoff over the RDMA plane. Fault-plan events may still claim
        # these attempts; an exhausted handoff costs more virtual time and
        # is simply re-sent (the plan is finite, so this terminates).
        tdt = 0.0
        while True:
            try:
                tdt += self.transfer.transfer(caches, rid=rid)
                break
            except TransferError as exc:
                tdt += exc.seconds
        ready = prefill_done + tdt
        del result.tokens[-1:]   # pool.add re-appends the verified token
        keys = tuple(self.cc.block_keys(replay)) \
            if self.cc is not None and self.pool.router.uses_affinity else ()
        return _PendingAdmission(first, caches, len(replay), result,
                                 remaining + 1, keys,
                                 ready_at=ready, recovered=True), \
            len(emitted) - 1

    def _replay_recover(self, rid: int, slot_payload: "_Slot",
                        fail_t: float) -> "_PendingAdmission":
        """Engine-failure recovery: rebuild the crashed slot by replay
        re-prefill and charge the latency as a recovery on the trace."""
        item, replayed = self._replay_rebuild(rid, slot_payload, fail_t)
        self.scheduler.on_recovery(self.scheduler.traces[rid], fail_t,
                                   tokens_replayed=replayed,
                                   ready_at=item.ready_at)
        return item

    def _preempt_request(self, rid: int) -> "_PendingAdmission":
        """Batch-tier preemption: evict ``rid``'s decode slot (the engine
        stays live; slot accounting is conserved), park its prompt +
        emitted tokens, and rebuild the KV by the same teacher-forced
        replay as failure recovery — so the resumed request finishes
        token-identical to the unpreempted run. The eviction-to-ready
        latency is charged to the victim's trace as ``preempt_seconds``."""
        sched = self.scheduler
        engine, payload, _cache_len = self.pool.evict(rid)
        t = sched.engine_clock(engine)
        item, replayed = self._replay_rebuild(rid, payload, t)
        sched.on_preempt(sched.traces[rid], t, tokens_replayed=replayed,
                         ready_at=item.ready_at)
        return item

    def _make_autoscaler(self) -> Optional[PoolAutoscaler]:
        """One PoolAutoscaler per serve() wave, built from the scheduler's
        *current* config and cost model (MTP feedback may have recalibrated
        the cost between waves — the controller must project TPOT with the
        same model the admission gate enforces)."""
        cfg = self.scheduler.config
        if not cfg.autoscale:
            return None
        return PoolAutoscaler(
            self.scheduler.cost, self.pool.engines[0].slot_mgr.n_slots,
            cfg.min_engines, cfg.max_engines,
            tpot_budget_s=self.scheduler.gate.budget_s,
            grow_patience=cfg.autoscale_grow_patience,
            shrink_patience=cfg.autoscale_shrink_patience,
            cooldown=cfg.autoscale_cooldown)

    def _autoscale_tick(self, scaler: Optional[PoolAutoscaler],
                        queue_depth: int) -> List["_PendingAdmission"]:
        """One controller evaluation between decode turns: apply a grow
        (spawn or revive an engine, register/warm its scheduler views) or a
        shrink (atomic migration-backed retirement, every move stamped on
        the trace), and record the scale event on the virtual timeline.
        The live roster may be empty after engine failures — the grow path
        (respawn toward ``min_engines``) must still run then. Returns any
        recovered admissions a drain-failure fallback produced (normally
        empty)."""
        if scaler is None:
            return []
        sched, pool = self.scheduler, self.pool
        # Shrink victim: fewest active slots among the LIVE roster; ties
        # retire the latest-spawned engine so engine 0 stays the stable
        # anchor. Post-failure the roster can be empty: no victim, and the
        # controller sees n_live=0 (dead engines are not capacity).
        victim = min(pool.live_ids,
                     key=lambda i: (pool.engines[i].active, -i)) \
            if pool.live_ids else None
        shrinkable = victim is not None and pool.n_live > 1 \
            and pool.can_drain(victim)
        decision = scaler.decide(pool.n_live, pool.active, queue_depth,
                                 shrinkable=shrinkable)
        if decision == "grow":
            engine, revived = pool.spawn_engine()
            if revived:
                sched.set_engine_live(engine, True)
            else:
                sched.register_engine(pool.engines[engine].slot_mgr)
            sched.record_scale_event("grow", engine)
        elif decision == "shrink":
            try:
                moved = pool.retire_engine(victim, self.transfer)
            except DrainError as exc:
                # The RDMA plane exhausted its retries mid-drain. The
                # completed moves stand; the stuck request's KV is intact
                # on the victim but must never be propagated unverified —
                # fall back to failing the victim over to replay
                # re-prefill, which completes the shrink with recovered
                # (token-identical) requests instead of garbage KV.
                for rid, dst, seconds in exc.moved:
                    sched.on_migrate(sched.traces[rid], victim, dst, seconds)
                return self._fail_engine(victim)
            for rid, dst, seconds in moved:
                sched.on_migrate(sched.traces[rid], victim, dst, seconds)
            sched.set_engine_live(victim, False)
            sched.record_scale_event("shrink", victim)
        return []

    def _make_joint(self) -> Optional[JointAutoscaler]:
        """One joint P/D controller per serve() wave (same rebuild rationale
        as :meth:`_make_autoscaler`): it shifts engine capacity between the
        prefill and decode roles under one SLO budget instead of growing
        the cluster."""
        cfg = self.scheduler.config
        if not cfg.joint_autoscale:
            return None
        return JointAutoscaler(
            self.scheduler.cost, self.pool.engines[0].slot_mgr.n_slots,
            min_prefill=cfg.min_prefill, max_prefill=cfg.max_prefill,
            min_decode=cfg.min_engines, max_decode=cfg.max_engines,
            tpot_budget_s=self.scheduler.gate.budget_s,
            ttft_budget_s=None if cfg.ttft_budget_ms is None
            else cfg.ttft_budget_ms * 1e-3,
            patience=cfg.joint_patience, cooldown=cfg.joint_cooldown)

    def _joint_tick(self, joint: Optional[JointAutoscaler],
                    queue_depth: int) -> List["_PendingAdmission"]:
        """One joint-controller evaluation between decode turns.

        ``shift_d2p`` retires the least-active decode engine (atomic
        migration-backed drain, falling back to replay-recovery engine
        failure exactly like the shrink path) and spawns/revives a prefill
        instance; ``shift_p2d`` parks the least-loaded prefill instance and
        spawns/revives a decode engine. Both directions are stamped on the
        scale-event timeline with their role so benches can plot the
        capacity see-saw."""
        if joint is None:
            return []
        sched, pool = self.scheduler, self.pool
        backlog = sched.prefill_backlog_s(sched.decode_now)
        victim = min(pool.live_ids,
                     key=lambda i: (pool.engines[i].active, -i)) \
            if pool.live_ids else None
        shrinkable = victim is not None and pool.n_live > 1 \
            and pool.can_drain(victim)
        decision = joint.decide(
            self.prefill_pool.n_live, pool.n_live, pool.active, queue_depth,
            backlog, decode_shrinkable=shrinkable)
        if decision == "shift_d2p":
            recovered: List[_PendingAdmission] = []
            try:
                moved = pool.retire_engine(victim, self.transfer)
            except DrainError as exc:
                for rid, dst, seconds in exc.moved:
                    sched.on_migrate(sched.traces[rid], victim, dst, seconds)
                recovered = self._fail_engine(victim)
            else:
                for rid, dst, seconds in moved:
                    sched.on_migrate(sched.traces[rid], victim, dst, seconds)
                sched.set_engine_live(victim, False)
            inst, revived = self.prefill_pool.spawn_engine()
            if revived:
                sched.set_prefill_live(inst, True)
            else:
                sched.register_prefill_instance()
            sched.record_scale_event("shift_d2p", victim, role="joint")
            return recovered
        if decision == "shift_p2d":
            # Prefill victim: least in-flight prompt tokens; ties park the
            # latest-spawned instance so instance 0 stays the anchor.
            pvictim = min(self.prefill_pool.live_ids,
                          key=lambda i: (self.prefills[i].load, -i))
            self.prefill_pool.retire_engine(pvictim)
            if self._ems is not None:
                # Retirement must not lose cached prefixes: demote the
                # instance's dirty HBM blocks into the shared pool tier.
                self._ems.drop_engine(self.prefills[pvictim]._ems_tag)
            sched.set_prefill_live(pvictim, False)
            engine, revived = pool.spawn_engine()
            if revived:
                sched.set_engine_live(engine, True)
            else:
                sched.register_engine(pool.engines[engine].slot_mgr)
            sched.record_scale_event("shift_p2d", engine, role="joint")
        return []

    # -- pipelined KV handoff ----------------------------------------------
    def _streamable(self) -> bool:
        """Chunked streaming needs sliceable sequence-axis caches — the
        same family EMS block reuse supports (ring-buffer SSM/hybrid
        state has no per-position KV to ship incrementally)."""
        return (self.scheduler.config.stream_handoff
                and self.cfg.attention_kind != "none"
                and not self.cfg.is_hybrid)

    def _stream_handoff(self, req: Request, trace, res: RequestResult,
                        caches: Any) -> Any:
        """Pipelined chunked KV handoff: ship each chunk's KV while the
        next chunk is still computing.

        The wire carries exactly the prompt's KV rows (``pack_blocks`` full
        chunks + a packed tail), chunk ``i`` becoming sendable when its last
        token's prefill completes — interpolated on the virtual clock from
        the trace's actual prefill window, so EMS-reused prefix chunks are
        ready immediately and the final chunk lands exactly at
        ``prefill_end``. Each chunk's transfer overlaps the remaining
        compute; the trace is charged only the pipeline tail past
        ``prefill_end`` (so ``ready_at = prefill_end + transfer_seconds``
        keeps meaning "KV fully landed"), with the hidden seconds recorded
        as ``overlap_seconds``. Returns the decode-side cache rebuilt from
        the streamed payloads — the bytes decode consumes are the bytes
        that crossed the wire, which is what makes streamed-vs-synchronous
        bit-identity a real end-to-end property rather than an accounting
        claim."""
        sched = self.scheduler
        cfg = self.cfg
        chunk = sched.config.stream_chunk or 8
        plen = len(req.prompt)
        n_full = plen // chunk
        segments: List[Tuple[int, int, np.ndarray]] = []
        payloads = cache_ops.pack_blocks(cfg, caches, n_full, chunk)
        for i, flat in enumerate(payloads):
            segments.append((i * chunk, chunk, np.asarray(flat)))
        tail = plen - n_full * chunk
        if tail:
            flat = cache_ops.pack_payload(
                cache_ops.seq_slice(cfg, caches, n_full * chunk, tail))
            segments.append((n_full * chunk, tail, np.asarray(flat)))
        # Compute-availability per chunk, interpolated from the prefill
        # window (charged per *computed* token; reused tokens are free).
        span = trace.prefill_end - trace.prefill_start
        per_tok = span / max(1, res.computed_tokens)
        prev_end = -float("inf")
        wire_total = 0.0
        total_bytes = 0
        max_chunk_bytes = 0
        for ci, (start, length, flat) in enumerate(segments):
            done = trace.prefill_start + \
                max(0, start + length - res.reused_tokens) * per_tok
            dt = self.transfer.transfer(flat, rid=req.rid, chunk=ci)
            nbytes = flat.size * flat.dtype.itemsize
            wire_total += dt
            total_bytes += nbytes
            max_chunk_bytes = max(max_chunk_bytes, nbytes)
            prev_end = max(done, prev_end) + dt
        seconds = prev_end - trace.prefill_end
        overlap = wire_total - seconds
        res.transfer_seconds = seconds
        sched.on_stream_transfer(trace, seconds, len(segments), overlap,
                                 total_bytes, max_chunk_bytes)
        # Rebuild the decode-side cache from what actually crossed the
        # wire. Positions past the prompt start zeroed (the synchronous
        # path may carry padded-write garbage there); both are beyond
        # cache_len, never attendable, and decode overwrites them.
        rebuilt = model_mod.make_caches(cfg, 1, self.capacity, torch.float32,
                                        self.device)
        for start, length, flat in segments:
            tmpl = cache_ops.seq_slice(cfg, rebuilt, start, length)
            payload = cache_ops.unpack_payload(flat, tmpl)
            rebuilt = cache_ops.seq_insert(cfg, rebuilt, payload, start)
        return rebuilt

    def serve(self, requests: List[Request],
              open_loop: bool = False) -> List[RequestResult]:
        """Serve a request wave. ``open_loop`` drives arrival-time
        scheduling on the virtual clock: a request becomes visible to
        prefill only once the clock reaches its ``arrival``, and its KV is
        admissible only once the clock reaches its ``ready_at`` — so a
        Poisson burst actually queues against the admission gate instead
        of being batched up front (closed loop, the default, feeds
        everything immediately)."""
        sched = self.scheduler
        sched.begin_epoch()            # rids may repeat across serve() waves
        scaler = self._make_autoscaler()
        joint = self._make_joint()
        streaming = self._streamable()
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        results: List[RequestResult] = []
        waiting: List[_PendingAdmission] = []
        eps = 1e-12
        self._inflight.clear()
        # Per-epoch RDMA retry accounting (engine counters are lifetime).
        xfer0 = (self.transfer.retries, self.transfer.timeouts,
                 self.transfer.corruptions)

        def sync_transfer_counters() -> None:
            sched.transfer_retries = self.transfer.retries - xfer0[0]
            sched.transfer_timeouts = self.transfer.timeouts - xfer0[1]
            sched.transfer_corruptions = self.transfer.corruptions - xfer0[2]

        def item_ready(item: _PendingAdmission) -> float:
            """When this admission's KV is available: the recovery instant
            for recovered requests, the original handoff otherwise."""
            if item.ready_at is not None:
                return item.ready_at
            return sched.traces[item.result.rid].ready_at

        def shed_item(item: _PendingAdmission) -> None:
            """Unified shed semantics: like the up-front capacity reject,
            a gate shed returns no tokens — the prefill output is dropped,
            not delivered — and contributes nothing to throughput."""
            trace = sched.traces[item.result.rid]
            item.result.shed = True
            item.result.tokens.clear()
            sched.on_shed(trace)
            sched.on_finish(trace, 0)
            results.append(item.result)
            self._inflight.pop(item.result.rid, None)

        def item_class(item: _PendingAdmission) -> str:
            return sched.traces[item.result.rid].slo_class

        def youngest_batch_victim() -> Optional[int]:
            """Preemption victim: the most recently admitted batch-tier
            slot across the live pool (max decode_admit; rid breaks ties
            deterministically). Interactive slots are never victims."""
            best = None
            for e in self.pool.live_ids:
                for _slot, info in \
                        self.pool.engines[e].slot_mgr.active_slots():
                    tr = sched.traces.get(info.rid)
                    if tr is None or tr.slo_class != "batch":
                        continue
                    key = (tr.decode_admit, tr.rid)
                    if best is None or key > best[0]:
                        best = (key, tr.rid)
            return None if best is None else best[1]

        def try_preempt(item: _PendingAdmission, trace,
                        parked: List[_PendingAdmission]) -> Tuple[str, int]:
            """Evict youngest batch-tier slots until ``item`` (interactive,
            gate-blocked) becomes admissible or no victims remain. Each
            victim is parked as a recovered-style pending re-admission at
            the BACK of the queue (deprioritized — that is the point of
            preemption). Bounded by the pool's batch-tier slot count."""
            while True:
                victim = youngest_batch_victim()
                if victim is None:
                    return "wait", 0
                parked.append(self._preempt_request(victim))
                engine = self.pool.select_engine(item.block_keys)
                decision = sched.admission_decision(trace, engine,
                                                    recovered=item.recovered)
                if decision != "wait":
                    return decision, engine

        def admit_class(items: List[_PendingAdmission], mid_turn: bool,
                        parked: List[_PendingAdmission]
                        ) -> Tuple[List[_PendingAdmission], bool]:
            """One SLO class's FIFO admission pass: admit gate-ready items
            in order; the gate may queue or shed. Returns ``(kept,
            ready_blocked)`` — ``ready_blocked`` means a gate-ready item
            is still waiting (under strict priority a blocked interactive
            pass bars the batch pass, and it is the brownout ladder's
            pressure signal)."""
            kept: List[_PendingAdmission] = []
            for idx, item in enumerate(items):
                trace = sched.traces[item.result.rid]
                ready = item_ready(item)
                if open_loop and ready > sched.decode_now + eps:
                    # KV not yet ready on the open-loop clock: hold, and
                    # within-class FIFO holds the rest of the class.
                    kept.extend(items[idx:])
                    return kept, False
                engine = self.pool.select_engine(item.block_keys)
                decision = sched.admission_decision(trace, engine,
                                                    recovered=item.recovered)
                if decision == "shed" and item.recovered:
                    # Recovered/preempted requests already streamed tokens;
                    # shedding them would break replay token identity. They
                    # queue through shed modes and brownout levels alike.
                    decision = "wait"
                if (decision == "wait" and sched.preemption_enabled
                        and trace.slo_class != "batch"):
                    decision, engine = try_preempt(item, trace, parked)
                if decision == "admit":
                    slot = self.pool.engines[engine].free_slot()
                    if slot is None:
                        # Stale admission: the gate said "admit" but no slot
                        # is actually free (gate/slot state diverged). Never
                        # pass slot=None into DecodeSlotManager.allocate —
                        # requeue and retry after the next decode turn.
                        kept.extend(items[idx:])
                        return kept, True
                    self.pool.add(engine, slot, item.caches, item.first,
                                  item.prompt_len, item.result, item.max_new,
                                  item.block_keys)
                    if item.recovered:
                        sched.on_readmit(trace, engine, ready)
                    else:
                        sched.on_admit(trace, slot, engine)
                    if mid_turn:
                        sched.note_mid_scan_refill()
                elif decision == "shed":
                    shed_item(item)
                else:  # wait: keep within-class FIFO, stop this class
                    kept.extend(items[idx:])
                    return kept, True
            return kept, False

        def admit_waiting(mid_turn: bool = False) -> None:
            """Admit gate-ready requests with strict SLO-class priority:
            the interactive tier first (FIFO within the class), then the
            batch tier only if no gate-ready interactive request is still
            blocked — batch never delays a gate-ready interactive request.
            Runs once per wave boundary, and — under continuous batching —
            again after each engine's chunk drains (``mid_turn``), so a
            freed slot takes the next admission before the next engine
            steps instead of waiting out the whole turn."""
            nonlocal waiting
            if not self.pool.live_ids:
                # Total capacity loss. With an autoscaler the respawn path
                # will restore the floor — hold the queue. Without one no
                # engine is ever coming back: shed everything rather than
                # deadlock (graceful degradation's last resort).
                if scaler is None:
                    for item in waiting:
                        shed_item(item)
                    waiting = []
                return
            degrade = sched.config.degrade_shed_queue_s
            now = sched.decode_now
            # Class-ordered queue-age shedding: graceful degradation
            # (degrade_shed_queue_s) plus the brownout ladder's level-3
            # batch-age shed. At equal queue age the batch-tier backlog is
            # cut before any interactive request — interactive over-age
            # sheds only in a round with no over-age batch left. Recovered/
            # preempted items are exempt (replay identity).
            if degrade is not None or sched.brownout_level >= 3:
                over_batch: List[_PendingAdmission] = []
                over_inter: List[_PendingAdmission] = []
                for item in waiting:
                    if item.recovered:
                        continue
                    age = now - item_ready(item)
                    batch_tier = item_class(item) == "batch"
                    if degrade is not None and age > degrade + eps:
                        (over_batch if batch_tier else over_inter).append(item)
                    elif (batch_tier and sched.brownout_level >= 3
                          and age > sched.config.brownout_queue_age_s + eps):
                        over_batch.append(item)
                for item in over_batch or over_inter:
                    shed_item(item)
                waiting = [it for it in waiting if not it.result.shed]
            # Strict-priority class passes. Preempted victims are parked
            # during the interactive pass and re-enter at the back of the
            # queue; the merged keep-list preserves arrival order so each
            # class's FIFO survives the partition.
            parked: List[_PendingAdmission] = []
            inter = [it for it in waiting if item_class(it) != "batch"]
            batch = [it for it in waiting if item_class(it) == "batch"]
            inter_kept, ready_blocked = admit_class(inter, mid_turn, parked)
            if ready_blocked:
                batch_kept = batch   # batch never jumps a blocked interactive
            else:
                batch_kept, _ = admit_class(batch, mid_turn, parked)
            keep = {id(it) for it in inter_kept}
            keep.update(id(it) for it in batch_kept)
            waiting = [it for it in waiting if id(it) in keep] + parked

        def refill_imminent(engine: int) -> bool:
            """Could an admission land on ``engine`` around its next chunk?
            If so the adaptive scan shrinks so the host sync arrives where
            the refill can happen. Closed loop, any gate-held request
            qualifies; open loop, only work that becomes ready within
            roughly one full-width chunk of this engine's clock — a
            far-future arrival must not degrade the scan to per-step."""
            if not open_loop:
                return bool(waiting)
            horizon = (sched.config.decode_chunk
                       * sched.cost.step_time(self.pool.engines[engine].active))
            t = sched.engine_clock(engine) + horizon + eps
            if any(item_ready(w) <= t for w in waiting):
                return True
            return bool(pending) and pending[0].arrival <= t
        # Worst-case decode cache growth: max_new - 1 iterations, +1 slack
        # for an MTP accept on the final emitted token.
        slack = 1 if self.decode.use_mtp else 0
        affinity = self.cc is not None and self.pool.router.uses_affinity
        rebalance_every = sched.config.decode_rebalance_every
        decode_turns = 0
        while pending or waiting or self.pool.active:
            # Fault injection first: straggler factors re-asserted from the
            # engine clocks, due crashes fired. Recovered requests requeue
            # at the FRONT of the admission queue — they were admitted
            # before anything still waiting.
            recovered = self._apply_faults()
            if recovered:
                waiting[0:0] = recovered
            # prefill (async wrt decode; modeled sequentially on 1 CPU)
            while pending and (not open_loop or
                               pending[0].arrival <= sched.decode_now + eps):
                req = pending.pop(0)
                trace = sched.on_arrival(req.rid, req.arrival,
                                         len(req.prompt),
                                         slo_class=req.slo_class)
                if sched.config.hit_aware_admission and self.cc is not None:
                    # Hit-aware admission: probe the shared cache index at
                    # enqueue so the gate charges only the uncached suffix.
                    # Non-mutating on EMS; the prefill reuse clamp below
                    # re-derives the authoritative count.
                    trace.cached_tokens = self.cc.probe_prefix(req.prompt)
                # max_new <= 1 never decodes, so only the prompt must fit
                # (in the prefill cache, which shares `capacity`).
                need = len(req.prompt) if req.max_new_tokens <= 1 \
                    else len(req.prompt) + req.max_new_tokens - 1 + slack
                if need > self.decode.capacity:
                    # Reject up front: admitting would overflow the static KV
                    # slot mid-decode and abort the whole batch.
                    res = RequestResult(req.rid, [], shed=True,
                                        slo_class=req.slo_class)
                    sched.on_shed(trace)
                    sched.on_finish(trace, 0)
                    results.append(res)
                    continue
                eng = self.prefills[sched.route_prefill(
                    trace, [e.load for e in self.prefills],
                    candidates=self.prefill_pool.live_ids)]
                first, caches, res = eng.run(req)
                res.slo_class = req.slo_class
                sched.on_prefill_done(trace, eng.instance_id,
                                      res.computed_tokens, res.reused_tokens)
                if req.max_new_tokens <= 1:
                    # Prefill already produced the only requested token:
                    # no decode slot (a dead step could overflow a prompt-
                    # filled KV slot) and no KV handoff to charge.
                    if req.max_new_tokens == 1:
                        res.tokens.append(first)
                    sched.on_prefill_only_finish(trace)
                    sched.on_finish(trace, len(res.tokens))
                    results.append(res)
                    continue
                if streaming:
                    caches = self._stream_handoff(req, trace, res, caches)
                else:
                    res.transfer_seconds = self.transfer.transfer(
                        caches, rid=req.rid)
                    sched.on_transfer(trace, res.transfer_seconds)
                keys = tuple(self.cc.block_keys(req.prompt)) if affinity \
                    else ()
                self._inflight[req.rid] = req
                waiting.append(_PendingAdmission(first, caches,
                                                 len(req.prompt), res,
                                                 req.max_new_tokens, keys))
            admit_waiting()
            # Brownout ladder tick: one pressure observation per loop turn.
            # Pressure = a gate-ready interactive request is still blocked
            # after admission ran; calm turns (including idle ones) let the
            # ladder descend, so a drained burst always steps back down.
            if sched.config.brownout:
                now = sched.decode_now + eps
                sched.note_overload(any(
                    item_class(it) != "batch" and item_ready(it) <= now
                    for it in waiting))
            # decode turn: decode_chunk device iterations per host sync on
            # the fast path; every engine with active slots steps, and each
            # engine's virtual clock is charged per iteration so trace/SLO
            # semantics match per-step single-engine decode. Continuous
            # batching steps engines individually (adaptive scan width) and
            # re-runs admission after each engine's chunk drains, so freed
            # slots refill mid-turn — before the next engine steps — while
            # per-engine clock charging and the autoscaler's demand signal
            # (evaluated once per turn, below) stay exactly as in the
            # wave-shaped loop.
            if self.pool.active:
                decode_turns += 1
                continuous = sched.config.continuous_batching
                stepped = []
                for engine in list(self.pool.live_ids):
                    if not self.pool.engines[engine].active:
                        continue
                    finished, iter_log = self.pool.step_engine(
                        engine, continuous=continuous,
                        refill_pending=continuous and refill_imminent(engine))
                    stepped.append(engine)
                    for entry in iter_log:
                        sched.on_decode_step(*entry, engine=engine)
                    for r in finished:
                        sched.on_finish(sched.traces[r.rid], len(r.tokens))
                        self._inflight.pop(r.rid, None)
                    results.extend(finished)
                    if continuous and waiting:
                        admit_waiting(mid_turn=True)
                sched.sync_idle_clocks(stepped)
                if rebalance_every and decode_turns % rebalance_every == 0:
                    try:
                        moved = self.pool.rebalance(self.transfer)
                    except TransferError:
                        # Exhausted retries on an *optional* move: the
                        # victim is intact on its source engine (migrate
                        # releases the source only after delivery), so
                        # skip this rebalance rather than escalate.
                        moved = None
                    if moved is not None:
                        rid, src_e, dst_e, seconds = moved
                        sched.on_migrate(sched.traces[rid], src_e, dst_e,
                                         seconds)
                # Autoscale between decode turns: demand = resident slots
                # + the admissions the gate is holding right now. Open
                # loop, a waiting request whose KV is still in flight
                # (ready_at in the future) is NOT queue pressure yet — no
                # engine could serve it, so spawning for it would buy an
                # idle engine and churn the pool.
                if scaler is not None or joint is not None:
                    if open_loop:
                        now = sched.decode_now + eps
                        queued = sum(1 for item in waiting
                                     if item_ready(item) <= now)
                    else:
                        queued = len(waiting)
                    recovered = self._autoscale_tick(scaler, queued)
                    recovered.extend(self._joint_tick(joint, queued))
                    if recovered:
                        waiting[0:0] = recovered
            elif (scaler is not None or joint is not None) and waiting \
                    and not self.pool.live_ids:
                # Every engine is dead and nothing can step: run the
                # controllers anyway so the respawn-toward-min_engines /
                # shift-prefill-to-decode paths restore capacity (the tick
                # above only runs between decode turns, which need a live
                # engine to exist).
                self._autoscale_tick(scaler, len(waiting))
                self._joint_tick(joint, len(waiting))
            elif open_loop and (pending or waiting):
                # Decode pool idle with future work: fast-forward the
                # virtual clock to the next event that can actually
                # unblock progress. Admission is FIFO, so that is the
                # *head* waiting request's KV-ready time — not the min
                # over all waiting requests: a later-arriving request can
                # finish prefill earlier (shorter prompt, idler instance),
                # and advancing only to its ready_at would leave the head
                # still gated and the loop spinning on the same instant.
                events = []
                if waiting:
                    events.append(item_ready(waiting[0]))
                if pending:
                    events.append(pending[0].arrival)
                sched.advance_clock(min(events))
        sync_transfer_counters()
        if self.decode.use_mtp:
            # Acceptance-rate feedback: fold the wave's measured draft
            # acceptance into the cost model so the next wave's admission
            # gate sizes its batch to observed, not assumed, speculation.
            sched.feedback_mtp_acceptance()
        return results
