"""EMS Context Caching (paper §4.4.2): prefix-hashed KV block reuse.

Historical KV caches are organized into paged blocks (default 128 tokens);
each block's key is a content hash chained over the prefix ("augmented with a
prefix hash to enable content-addressable indexing"), so identical prefixes
dedup to one stored copy regardless of which request produced them. The
prefill engine queries the longest cached prefix, loads those blocks over the
UB plane, and computes only the suffix (Fig. 23's reuse-rate mechanics).

Key hashing is memoized per prompt: ``block_keys`` / ``match_prefix`` /
``store`` all resolve through one bounded LRU memo, so a request's sha256
chain is computed once even though the serving loop consults the keys at
routing, admission, reuse, and store time.

:class:`~repro_torch.mempool.ems.EMSService` subclasses this into the shared,
tiered, engine-decoupled cache service; the ``engine=`` keyword on
``fetch``/``store`` is the tier-affinity seam (ignored here).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.mempool.pool import MemoryPool


def _block_keys(tokens: Sequence[int], block: int, model_tag: str) -> List[str]:
    """Prefix-chained content hashes, one per complete block."""
    keys = []
    h = hashlib.sha256(model_tag.encode())
    n_full = len(tokens) // block
    for b in range(n_full):
        chunk = np.asarray(tokens[b * block:(b + 1) * block], np.int32)
        h = hashlib.sha256(h.digest() + chunk.tobytes())
        keys.append("cc:" + h.hexdigest())
    return keys


class ContextCache:
    #: bounded size of the per-prompt key memo (entries, LRU)
    MEMO_ENTRIES = 1024

    def __init__(self, pool: MemoryPool, block_tokens: int = 128,
                 namespace: str = "context", model_tag: str = "model"):
        self.pool = pool
        self.block = block_tokens
        self.ns = namespace
        self.model_tag = model_tag
        self.dedup_skipped = 0
        self.stored_blocks = 0
        self.fetch_misses = 0       # match→fetch eviction races, now graceful
        self.hash_calls = 0         # sha256 chains actually computed
        self._key_memo: "OrderedDict[bytes, List[str]]" = OrderedDict()

    def _keys(self, tokens: Sequence[int]) -> List[str]:
        """Memoized prefix-chained keys: one sha256 chain per distinct
        prompt, however many times the serving loop asks (routing,
        admission probe, match, store)."""
        sig = np.asarray(tokens, np.int32).tobytes()
        hit = self._key_memo.get(sig)
        if hit is not None:
            self._key_memo.move_to_end(sig)
            return hit
        self.hash_calls += 1
        keys = _block_keys(tokens, self.block, self.model_tag)
        self._key_memo[sig] = keys
        if len(self._key_memo) > self.MEMO_ENTRIES:
            self._key_memo.popitem(last=False)
        return keys

    def block_keys(self, tokens: Sequence[int]) -> List[str]:
        """Prefix-chained content keys of every complete block of
        ``tokens`` — the affinity unit for EMS-aware decode-pool routing
        (a request is attracted to the engine whose recent residents
        shared these keys)."""
        return list(self._keys(tokens))

    # -- prefill-side: longest reusable prefix ------------------------------
    def match_prefix(self, tokens: Sequence[int]) -> Tuple[int, List[str]]:
        """Returns (#reusable tokens, keys of matched blocks)."""
        keys = self._keys(tokens)
        matched: List[str] = []
        for k in keys:
            if self.pool.contains(k):
                matched.append(k)
            else:
                break
        return len(matched) * self.block, matched

    def probe_prefix(self, tokens: Sequence[int]) -> int:
        """#tokens a prefill of ``tokens`` could reuse right now — the
        admission-time hit probe (hit-aware gates charge only the
        suffix)."""
        return self.match_prefix(tokens)[0]

    def fetch(self, keys: Sequence[str],
              engine: Optional[str] = None) -> List[np.ndarray]:
        """Payloads of the longest still-resident prefix of ``keys``.

        A block can be evicted between ``match_prefix`` and ``fetch`` (the
        eviction race); rather than asserting, fetch stops at the first
        vanished block and returns what it could load — the caller shrinks
        its reuse to ``len(result) * block`` tokens and recomputes the
        rest. ``engine`` is the device-tier affinity tag, ignored by the
        single-tier base cache."""
        del engine
        out: List[np.ndarray] = []
        for k in keys:
            v = self.pool.get(k)
            if v is None:           # eviction race → graceful miss
                self.fetch_misses += 1
                break
            out.append(v)
        return out

    # -- store computed KV blocks (async in the real system) ----------------
    def store(self, tokens: Sequence[int], kv_blocks: Sequence[np.ndarray],
              engine: Optional[str] = None) -> int:
        """kv_blocks[i] is the KV payload of tokens[i*block:(i+1)*block].
        Deduplicates: already-present blocks are skipped. Returns #stored.
        ``engine`` is the device-tier affinity tag, ignored here."""
        del engine
        keys = self._keys(tokens)
        stored = 0
        for k, payload in zip(keys, kv_blocks):
            if self.pool.contains(k):
                self.dedup_skipped += 1
                continue
            if self.pool.put(k, np.asarray(payload), self.ns):
                stored += 1
                self.stored_blocks += 1
        return stored

    # Decode-side storage policy (paper: reasoning models skip it).
    def should_store_decode(self, is_reasoning_model: bool) -> bool:
        return not is_reasoning_model
