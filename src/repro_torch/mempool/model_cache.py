"""EMS Model Caching (paper §4.4.3): block-sharded model load + switching.

Models are decomposed into blocks stored as KV entries in the disaggregated
pool; a metadata service maps (model, version) -> block keys. Loading:

* cold (miss): one shared OBS fetch fills the pool (2.5 GB/s bucket), then
  every instance pulls blocks over the UB plane — vs. per-instance OBS
  fetches without EMS (the 8× contention in Table 2).
* warm (hit): DRAM -> NPU over UB (~5 s for 671 GB across the pool).

Versioning: block keys embed the version; stale versions age out via LRU.
The benchmark ``benchmarks/model_caching.py`` reproduces Table 2 from this
cost model.

The port's copy of the JAX package's ``mempool/model_cache.py`` (numpy
only), over the port's ``mempool/pool.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.mempool.pool import MemoryPool, OBS_STORE, UB_PLANE, PlaneModel


@dataclasses.dataclass
class ModelMeta:
    name: str
    version: str
    n_blocks: int
    block_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.n_blocks * self.block_bytes

    def block_key(self, i: int) -> str:
        return f"mc:{self.name}@{self.version}:{i}"


class ModelCache:
    def __init__(self, pool: MemoryPool, namespace: str = "model"):
        self.pool = pool
        self.ns = namespace
        self.registry: Dict[Tuple[str, str], ModelMeta] = {}

    def register(self, name: str, version: str, total_bytes: int,
                 block_bytes: int = 64 * 1024 * 1024) -> ModelMeta:
        n_blocks = max(1, -(-total_bytes // block_bytes))
        meta = ModelMeta(name, version, n_blocks, block_bytes)
        self.registry[(name, version)] = meta
        return meta

    def is_cached(self, meta: ModelMeta) -> bool:
        return all(self.pool.contains(meta.block_key(i))
                   for i in range(meta.n_blocks))

    def prefetch(self, meta: ModelMeta, payload: bool = False) -> float:
        """Async OBS->pool fill for missing blocks. Returns simulated seconds
        (one shared fetch — EMS's key saving vs per-instance loads)."""
        t0 = self.pool.clock.elapsed
        for i in range(meta.n_blocks):
            k = meta.block_key(i)
            if not self.pool.contains(k):
                self.pool.clock.charge(OBS_STORE, meta.block_bytes)
                blk = np.zeros(max(1, meta.block_bytes // 8), np.float64) \
                    if payload else np.zeros(1, np.float64)
                # store metadata-sized payload; accounting uses block_bytes
                self.pool.put(k, blk, self.ns)
        return self.pool.clock.elapsed - t0

    def load_to_npu(self, meta: ModelMeta, n_instances: int = 1,
                    plane: PlaneModel = UB_PLANE) -> float:
        """Pool -> NPU-memory transfer for n instances (shared blocks, no
        duplication — the 1× DRAM footprint of Table 2). Returns sim secs."""
        t0 = self.pool.clock.elapsed
        for _ in range(n_instances):
            for i in range(meta.n_blocks):
                if not self.pool.contains(meta.block_key(i)):
                    self.pool.clock.charge(OBS_STORE, meta.block_bytes)
                self.pool.clock.charge(plane, meta.block_bytes)
        return self.pool.clock.elapsed - t0

    def switch_model(self, target: ModelMeta) -> Tuple[float, bool]:
        """Model switch latency: warm (all blocks cached) ≈ UB load; cold
        adds the OBS fill. Returns (sim seconds, was_warm)."""
        warm = self.is_cached(target)
        t0 = self.pool.clock.elapsed
        if not warm:
            self.prefetch(target)
        self.load_to_npu(target, 1)
        return self.pool.clock.elapsed - t0, warm
