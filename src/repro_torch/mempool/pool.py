"""UB-driven disaggregated memory pool (paper §4.4.1) — the EMS substrate.

Host-side subsystem (an H100 reaches its host's DRAM over PCIe only, and
no other host's DRAM over NVLink, so the pool is host memory and the
planes below are modeled) with the paper's three software roles:

* :class:`MPController` — control plane: DHT view, namespaces, metadata.
* :class:`MPServer`     — one per DRAM-contributing node: slab allocator
  (huge-page-style), DRAM↔SSD tiering with LRU, recovery from the SSD tier.
* :class:`MemoryPool`   — the MP-SDK facade: Put/Get key-value API routed by
  global consistent hashing.

A :class:`SimClock` + :class:`PlaneModel` charge every transfer with the
bandwidth/latency of the plane it crosses (UB vs VPC vs SSD vs OBS), using
the paper's published constants (Table 1, §4.4.3), so benchmarks reproduce
Table 2 / Fig. 23 semantics quantitatively.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Transfer cost model (paper Table 1 / §4.4)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlaneModel:
    name: str
    bandwidth: float   # bytes/s, unidirectional effective
    latency: float     # seconds per operation

    def cost(self, nbytes: int) -> float:
        return self.latency + nbytes / self.bandwidth


# NPU<->CPU-DRAM over UB: ~147-151 GB/s, ~1.7 us (paper Table 1).
UB_PLANE = PlaneModel("ub", 147e9, 1.7e-6)
# VPC plane fallback (Fig. 23 comparison): 400 Gbps nominal, higher latency.
VPC_PLANE = PlaneModel("vpc", 12.5e9, 30e-6)
# EVS SSD tier behind each MP server.
SSD_TIER = PlaneModel("ssd", 3e9, 100e-6)
# OBS bucket: 2.5 GB/s shared (paper §4.4.3).
OBS_STORE = PlaneModel("obs", 2.5e9, 1e-3)


class SimClock:
    """Accumulates simulated transfer seconds (wall-independent)."""

    def __init__(self) -> None:
        self.elapsed = 0.0

    def charge(self, plane: PlaneModel, nbytes: int) -> float:
        dt = plane.cost(nbytes)
        self.elapsed += dt
        return dt


def stable_hash(key: str) -> int:
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "big")


# ---------------------------------------------------------------------------
# MP Server: slab allocation + DRAM/SSD tiering
# ---------------------------------------------------------------------------

HUGE_PAGE = 2 * 1024 * 1024  # 2 MiB slabs ("huge pages", §4.4.1)


class MPServer:
    def __init__(self, node_id: int, dram_capacity: int, ssd_capacity: int):
        self.node_id = node_id
        self.dram_capacity = dram_capacity
        self.ssd_capacity = ssd_capacity
        self.dram_used = 0
        self.ssd_used = 0
        # key -> (namespace, nbytes, payload); insertion order = LRU order
        self.dram: "OrderedDict[str, Tuple[str, int, np.ndarray]]" = OrderedDict()
        self.ssd: "OrderedDict[str, Tuple[str, int, np.ndarray]]" = OrderedDict()
        self.evictions = 0
        self.recoveries = 0

    @staticmethod
    def _slabs(nbytes: int) -> int:
        """Allocation rounds up to huge-page slabs (fragmentation control)."""
        return max(1, -(-nbytes // HUGE_PAGE)) * HUGE_PAGE

    def put(self, key: str, ns: str, value: np.ndarray) -> None:
        nbytes = value.nbytes
        alloc = self._slabs(nbytes)
        while self.dram_used + alloc > self.dram_capacity and self.dram:
            self._evict_one()
        self.dram[key] = (ns, nbytes, value)
        self.dram.move_to_end(key)
        self.dram_used += alloc
        # Persistence: all data is also written to the EVS/SSD tier (§4.4.1).
        salloc = self._slabs(nbytes)
        while self.ssd_used + salloc > self.ssd_capacity and self.ssd:
            k, (ns2, nb2, _) = self.ssd.popitem(last=False)
            self.ssd_used -= self._slabs(nb2)
        self.ssd[key] = (ns, nbytes, value)
        self.ssd_used += salloc

    def _evict_one(self) -> None:
        """LRU eviction DRAM -> SSD (data persists in the SSD tier)."""
        key, (ns, nbytes, _) = self.dram.popitem(last=False)
        self.dram_used -= self._slabs(nbytes)
        self.evictions += 1

    def get(self, key: str) -> Optional[Tuple[np.ndarray, str]]:
        """Returns (value, tier) or None. Promotes SSD hits to DRAM."""
        if key in self.dram:
            self.dram.move_to_end(key)
            return self.dram[key][2], "dram"
        if key in self.ssd:
            ns, nbytes, value = self.ssd[key]
            self.recoveries += 1
            self.put(key, ns, value)   # promote
            return value, "ssd"
        return None

    def delete_namespace(self, ns: str) -> None:
        for store, used_attr in ((self.dram, "dram_used"), (self.ssd, "ssd_used")):
            doomed = [k for k, v in store.items() if v[0] == ns]
            for k in doomed:
                _, nbytes, _ = store.pop(k)
                setattr(self, used_attr, getattr(self, used_attr) - self._slabs(nbytes))


# ---------------------------------------------------------------------------
# MP Controller: DHT view + namespaces
# ---------------------------------------------------------------------------


class MPController:
    VNODES = 64  # virtual nodes per server for consistent hashing

    def __init__(self, n_nodes: int):
        self.n_nodes = n_nodes
        self.ring: List[Tuple[int, int]] = sorted(
            (stable_hash(f"node{n}#v{v}"), n)
            for n in range(n_nodes) for v in range(self.VNODES))
        self.namespaces: Dict[str, Dict] = {}

    def locate(self, key: str) -> int:
        """Consistent-hash ring lookup: key -> responsible node id."""
        h = stable_hash(key)
        lo, hi = 0, len(self.ring)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.ring[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        return self.ring[lo % len(self.ring)][1]

    def create_namespace(self, ns: str, quota_bytes: Optional[int] = None) -> None:
        self.namespaces[ns] = {"quota": quota_bytes, "used": 0}

    def charge_namespace(self, ns: str, nbytes: int) -> bool:
        meta = self.namespaces.setdefault(ns, {"quota": None, "used": 0})
        if meta["quota"] is not None and meta["used"] + nbytes > meta["quota"]:
            return False
        meta["used"] += nbytes
        return True


# ---------------------------------------------------------------------------
# MemoryPool: the MP-SDK facade
# ---------------------------------------------------------------------------


class MemoryPool:
    def __init__(self, n_nodes: int = 32, dram_per_node: int = 1 << 32,
                 ssd_per_node: int = 1 << 36, plane: PlaneModel = UB_PLANE):
        self.controller = MPController(n_nodes)
        self.servers = [MPServer(i, dram_per_node, ssd_per_node)
                        for i in range(n_nodes)]
        self.plane = plane
        self.clock = SimClock()
        self.hits = 0
        self.misses = 0

    # -- KV-store style API (paper §4.4.1 "Put and Get") -------------------
    def put(self, key: str, value: np.ndarray, namespace: str = "default") -> bool:
        if not self.controller.charge_namespace(namespace, value.nbytes):
            return False
        node = self.controller.locate(key)
        self.clock.charge(self.plane, value.nbytes)
        self.servers[node].put(key, namespace, value)
        return True

    def get(self, key: str) -> Optional[np.ndarray]:
        node = self.controller.locate(key)
        res = self.servers[node].get(key)
        if res is None:
            self.misses += 1
            return None
        value, tier = res
        self.hits += 1
        if tier == "ssd":
            self.clock.charge(SSD_TIER, value.nbytes)
        self.clock.charge(self.plane, value.nbytes)
        return value

    def contains(self, key: str) -> bool:
        node = self.controller.locate(key)
        return self.servers[node].get(key) is not None

    # -- introspection ------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / max(1, self.hits + self.misses),
            "sim_seconds": self.clock.elapsed,
            "dram_used": sum(s.dram_used for s in self.servers),
            "evictions": sum(s.evictions for s in self.servers),
            "load_balance": self._balance(),
        }

    def _balance(self) -> float:
        used = np.array([s.dram_used for s in self.servers], dtype=np.float64)
        if used.sum() == 0:
            return 1.0
        return float(used.min() / max(used.max(), 1))
