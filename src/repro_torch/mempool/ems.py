"""Elastic Memory Service (paper §4.4): the shared, tiered, engine-decoupled
prefix-cache service.

:class:`EMSService` lifts :class:`~repro_torch.mempool.context_cache.ContextCache`
from a single-engine, single-tier toy into the paper's EMS shape:

* **Hierarchical tiers** — per-engine *device HBM* tiers (keyed by a string
  tag such as ``"prefill0"`` / ``"decode1"``) in front of the pooled
  host-DRAM → SSD :class:`~repro_torch.mempool.pool.MemoryPool`. An HBM hit is
  free (device-local); a pool hit pays the UB-plane pool read plus an
  RDMA-plane promote into the requesting engine's tier.
* **Async write-back** — ``store`` lands blocks *dirty* in the storing
  engine's HBM tier and queues them for demotion; the queue drains a small
  batch per public op (and fully on :meth:`flush` / :meth:`drop_engine`),
  each demotion charged to the RDMA plane via a
  :class:`~repro_torch.serving.transfer.KVTransferEngine` bound to the pool's
  virtual clock. Prefixes therefore survive engine retire/fail: the pooled
  tier is the system of record.
* **Cost-aware eviction** — HBM victims minimize
  ``(1 + hits) · min(refetch_cost, recompute_cost) / slab_bytes``: a block
  is only worth its cheapest replacement path per byte it pins, not its
  recency. Dirty victims are demoted (never dropped) first.
* **Pool-wide dedup** — the service keeps a *non-mutating* global index
  (key → payload bytes) spanning dirty HBM blocks and pooled blocks, so a
  prefix stored by any engine dedups every other engine's store, and
  residency probes (:meth:`match_prefix` / :meth:`probe_prefix` /
  :meth:`engine_residency`) never perturb the pool's LRU order the way
  ``MemoryPool.contains`` does.

The index is advisory: the pool can still evict a block from both DRAM and
SSD behind it, in which case ``fetch`` degrades to a graceful miss and
repairs the index (the base class's eviction-race semantics).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.mempool.context_cache import ContextCache
from repro_torch.mempool.pool import HUGE_PAGE, MemoryPool


@dataclasses.dataclass
class _HBMEntry:
    """One block resident in an engine's device-HBM tier.

    ``payload is None`` marks a *pin*: the block's KV lives in the engine's
    decode slots (router affinity signal) but the bytes themselves are
    served from the pooled tier."""
    nbytes: int
    payload: Optional[np.ndarray] = None
    dirty: bool = False
    hits: int = 0


def _slab_bytes(nbytes: int) -> int:
    """HBM allocation rounds up to huge-page slabs, like the MP servers."""
    return max(1, -(-max(nbytes, 1) // HUGE_PAGE)) * HUGE_PAGE


class EMSService(ContextCache):
    #: demotions drained per public op (the "async" write-back cadence on
    #: the virtual clock; flush()/drop_engine() drain unconditionally)
    DEMOTE_BATCH = 4

    def __init__(self, pool: Optional[MemoryPool] = None,
                 block_tokens: int = 128, namespace: str = "context",
                 model_tag: str = "model", *,
                 hbm_capacity_bytes: int = 256 * HUGE_PAGE,
                 recompute_cost_per_token_s: float = 2e-4,
                 transfer=None):
        super().__init__(pool if pool is not None else MemoryPool(n_nodes=8),
                         block_tokens, namespace, model_tag)
        if hbm_capacity_bytes < HUGE_PAGE:
            raise ValueError("hbm_capacity_bytes must hold at least one slab")
        if transfer is None:
            # Lazy import: serving.transfer pulls in the model modules (and
            # torch); the mempool package must stay importable without them
            # resolved first (and this also breaks the package import cycle).
            from repro_torch.serving.transfer import KVTransferEngine
            transfer = KVTransferEngine(clock=self.pool.clock)
        self.transfer = transfer
        self.hbm_capacity_bytes = hbm_capacity_bytes
        self.recompute_cost_per_token_s = recompute_cost_per_token_s
        # key -> payload nbytes; spans pooled AND dirty-HBM blocks. Never
        # consulted through MemoryPool.contains (which mutates LRU order).
        self._index: Dict[str, int] = {}
        self._hbm: Dict[str, "OrderedDict[str, _HBMEntry]"] = {}
        self._hbm_used: Dict[str, int] = {}
        self._demote_q: Deque[Tuple[str, str]] = deque()   # (engine, key)
        self.hbm_hits = 0
        self.pool_hits = 0
        self.promote_blocks = 0
        self.promote_bytes = 0
        self.demote_blocks = 0
        self.demote_bytes = 0
        self.hbm_evictions = 0
        self.index_repairs = 0

    # -- tier bookkeeping ---------------------------------------------------
    def _tier(self, engine: str) -> "OrderedDict[str, _HBMEntry]":
        if engine not in self._hbm:
            self._hbm[engine] = OrderedDict()
            self._hbm_used[engine] = 0
        return self._hbm[engine]

    def _evict_score(self, entry: _HBMEntry) -> float:
        """Retention value per pinned byte: cheapest replacement path
        (RDMA refetch from the pool vs recomputing the block's prefill)
        weighted by observed reuse. Lowest score evicts first."""
        refetch = self.transfer.plane.cost(entry.nbytes)
        recompute = self.block * self.recompute_cost_per_token_s
        return (1 + entry.hits) * min(refetch, recompute) \
            / _slab_bytes(entry.nbytes)

    def _demote_now(self, engine: str, key: str, entry: _HBMEntry) -> None:
        """Write one dirty block back to the pooled tier (RDMA charge +
        pool put); the entry stays resident, now clean."""
        assert entry.dirty and entry.payload is not None
        self.transfer.demote(entry.payload)
        self.pool.put(key, entry.payload, self.ns)
        entry.dirty = False
        self.demote_blocks += 1
        self.demote_bytes += entry.nbytes

    def _drain_demotes(self, limit: Optional[int] = None) -> int:
        """Service the async write-back queue. Entries may have been
        demoted early (eviction under pressure) or dropped with their
        engine — those are skipped, not errors."""
        drained = 0
        budget = len(self._demote_q) if limit is None else limit
        while self._demote_q and budget > 0:
            budget -= 1
            engine, key = self._demote_q.popleft()
            entry = self._hbm.get(engine, {}).get(key)
            if entry is None or not entry.dirty:
                continue
            self._demote_now(engine, key, entry)
            drained += 1
        return drained

    def _hbm_insert(self, engine: str, key: str, entry: _HBMEntry) -> None:
        tier = self._tier(engine)
        old = tier.pop(key, None)
        if old is not None:
            self._hbm_used[engine] -= _slab_bytes(old.nbytes)
            entry.hits = max(entry.hits, old.hits)
        alloc = _slab_bytes(entry.nbytes)
        while self._hbm_used[engine] + alloc > self.hbm_capacity_bytes \
                and tier:
            victim = min(tier, key=lambda k: self._evict_score(tier[k]))
            ve = tier.pop(victim)
            if ve.dirty:            # never drop unwritten bytes
                self._demote_now(engine, victim, ve)
            self._hbm_used[engine] -= _slab_bytes(ve.nbytes)
            self.hbm_evictions += 1
        tier[key] = entry
        self._hbm_used[engine] += alloc

    def _find_dirty(self, key: str) -> Optional[Tuple[str, _HBMEntry]]:
        """Locate a block that exists only as a dirty HBM copy so far."""
        for engine, tier in self._hbm.items():
            entry = tier.get(key)
            if entry is not None and entry.dirty:
                return engine, entry
        return None

    # -- probes (non-mutating: never touch the pool's LRU order) ------------
    def match_prefix(self, tokens: Sequence[int]) -> Tuple[int, List[str]]:
        keys = self._keys(tokens)
        matched: List[str] = []
        for k in keys:
            if k in self._index:
                matched.append(k)
            else:
                break
        return len(matched) * self.block, matched

    def engine_residency(self, engine: str, keys: Sequence[str]) -> int:
        """Hit depth of ``keys`` in one engine's device tier: the number
        of *leading* keys resident there (payload or pin). The decode
        router's affinity signal — derived from the shared service, so it
        cannot drift from reality the way advisory router memory could."""
        tier = self._hbm.get(engine)
        if not tier:
            return 0
        depth = 0
        for k in keys:
            if k not in tier:
                break
            depth += 1
        return depth

    # -- data path ----------------------------------------------------------
    def fetch(self, keys: Sequence[str],
              engine: Optional[str] = None) -> List[np.ndarray]:
        """Resolve blocks through the hierarchy: engine HBM (free) →
        pooled tier (UB pool read + RDMA promote into HBM) → graceful
        miss. Returns the longest resolvable prefix of ``keys``."""
        self._drain_demotes(self.DEMOTE_BATCH)
        tag = engine if engine is not None else "shared"
        tier = self._tier(tag)
        out: List[np.ndarray] = []
        for k in keys:
            entry = tier.get(k)
            if entry is not None and entry.payload is not None:
                entry.hits += 1
                tier.move_to_end(k)
                self.hbm_hits += 1
                out.append(entry.payload)
                continue
            owner = self._find_dirty(k)
            if owner is not None:
                # Another engine holds the only copy, still unwritten:
                # complete the write-back now so the pooled tier can serve.
                self._demote_now(owner[0], k, owner[1])
            v = self.pool.get(k)
            if v is None:
                # Pool evicted behind the index (or the index was stale):
                # graceful miss + repair, caller recomputes the suffix.
                if k in self._index:
                    del self._index[k]
                    self.index_repairs += 1
                self.fetch_misses += 1
                break
            self.pool_hits += 1
            self.transfer.promote(v)
            self.promote_blocks += 1
            self.promote_bytes += v.nbytes
            hits = 1 if entry is None else entry.hits + 1
            self._hbm_insert(tag, k, _HBMEntry(v.nbytes, v, False, hits))
            out.append(v)
        return out

    def store(self, tokens: Sequence[int], kv_blocks: Sequence[np.ndarray],
              engine: Optional[str] = None) -> int:
        """Write-back store: blocks land dirty in the storing engine's HBM
        tier, are indexed (and so dedup'd) pool-wide immediately, and reach
        the pooled tier asynchronously via the demote queue."""
        self._drain_demotes(self.DEMOTE_BATCH)
        tag = engine if engine is not None else "shared"
        keys = self._keys(tokens)
        stored = 0
        for k, payload in zip(keys, kv_blocks):
            if k in self._index:
                self.dedup_skipped += 1
                continue
            arr = np.asarray(payload)
            self._index[k] = arr.nbytes
            self._hbm_insert(tag, k, _HBMEntry(arr.nbytes, arr, True, 0))
            # Capacity pressure inside this very loop can demote the block
            # early; the drain skips entries that are already clean.
            self._demote_q.append((tag, k))
            stored += 1
            self.stored_blocks += 1
        return stored

    # -- engine lifecycle ---------------------------------------------------
    def pin(self, engine: str, keys: Sequence[str]) -> None:
        """Mark ``keys`` device-resident on ``engine`` without moving
        bytes — the decode-admission affinity signal (the engine's slots
        hold this KV for the request's lifetime). Pins are zero-cost,
        pool-backed, and evict like any other entry."""
        tier = self._tier(engine)
        for k in keys:
            if k in tier:
                tier[k].hits += 1
                tier.move_to_end(k)
            else:
                self._hbm_insert(engine, k,
                                 _HBMEntry(self._index.get(k, 0), None,
                                           False, 1))

    def drop_engine(self, engine: str) -> None:
        """Engine retire/fail: write every dirty block back (cached
        prefixes are *not* lost — the pooled tier keeps them), then drop
        the device tier."""
        tier = self._hbm.get(engine)
        if tier is None:
            return
        for key, entry in list(tier.items()):
            if entry.dirty:
                self._demote_now(engine, key, entry)
        del self._hbm[engine]
        del self._hbm_used[engine]

    def flush(self) -> int:
        """Drain the whole write-back queue; returns #blocks demoted."""
        return self._drain_demotes()

    # -- introspection ------------------------------------------------------
    def ems_stats(self) -> Dict[str, float]:
        lookups = self.hbm_hits + self.pool_hits + self.fetch_misses
        return {
            "indexed_blocks": len(self._index),
            "hbm_engines": len(self._hbm),
            "hbm_resident_blocks": sum(len(t) for t in self._hbm.values()),
            "hbm_used_bytes": sum(self._hbm_used.values()),
            "hbm_hits": self.hbm_hits,
            "pool_hits": self.pool_hits,
            "fetch_misses": self.fetch_misses,
            "hit_rate": (self.hbm_hits + self.pool_hits) / max(1, lookups),
            "promote_blocks": self.promote_blocks,
            "promote_bytes": self.promote_bytes,
            "demote_blocks": self.demote_blocks,
            "demote_bytes": self.demote_bytes,
            "pending_demotes": sum(
                1 for eng, k in self._demote_q
                if (e := self._hbm.get(eng, {}).get(k)) is not None
                and e.dirty),
            "hbm_evictions": self.hbm_evictions,
            "index_repairs": self.index_repairs,
            "dedup_skipped": self.dedup_skipped,
            "stored_blocks": self.stored_blocks,
            "hash_calls": self.hash_calls,
        }
