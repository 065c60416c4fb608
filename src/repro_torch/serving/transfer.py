"""Low-interference prefill→decode KV transfer (paper §4.3.3).

Three mechanisms, reproduced:

* **RDMA-plane isolation** — KV handoff is charged to a dedicated plane
  (400 Gbps/NPU, the paper's scale-out plane; on a cluster of H100 hosts
  this is the inter-host network, the ``pod`` axis of ``launch/mesh.py``,
  beside NVLink inside a host) so it never contends with UB-plane decode
  traffic.
* **Deterministic group connection mapping** — the paper's exact formulas
  balancing which prefill TP rank each decode (tp, dp) rank pulls from.
* **Asynchronous scheduling** — the ServingSystem dispatches prefill and the
  transfer from a background logical thread; decode never blocks (modeled by
  charging transfer time to the request's TTFT, not to decode steps).

Fault tolerance: every ``transfer``/``migrate`` carries a payload
fingerprint and, when a fault hook is installed, runs a timeout + capped
exponential-backoff retry loop on the virtual clock. An exhausted op raises
:class:`TransferTimeout` / :class:`TransferCorruption` (both
:class:`TransferError`) carrying the seconds already burned, so callers can
charge the trace and fall back to replay re-prefill instead of propagating
garbage KV. Without a fault hook the data path is bit- and cost-identical
to the fault-free engine.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.mempool.pool import PlaneModel, SimClock
from repro_torch.serving.cache_ops import fingerprint
from repro_torch.tree import array_nbytes, tree_leaves

RDMA_PLANE = PlaneModel("rdma", 50e9, 5e-6)   # 400 Gbps unidirectional / NPU


class TransferError(RuntimeError):
    """An RDMA-plane op failed after exhausting its retries. ``seconds``
    is the virtual time already charged to the clock (timeout windows,
    backoff sleeps, wasted wire time), ``attempts`` the attempts made."""

    def __init__(self, msg: str, *, seconds: float = 0.0, nbytes: int = 0,
                 attempts: int = 0):
        super().__init__(msg)
        self.seconds = seconds
        self.nbytes = nbytes
        self.attempts = attempts


class TransferTimeout(TransferError):
    """Every attempt stalled past the timeout window."""


class TransferCorruption(TransferError):
    """Every attempt delivered a payload whose fingerprint mismatched."""


def prefill_source_rank(prefill_tp: int, decode_tp: int, decode_dp: int,
                        decode_tp_rank: int, decode_dp_rank: int) -> int:
    """Paper §4.3.3 deterministic group connection mapping."""
    ratio = prefill_tp // decode_tp
    group_size = max(1, decode_dp // max(ratio, 1))
    group_id = decode_dp_rank // group_size
    return group_id * decode_tp + decode_tp_rank


def connection_map(prefill_tp: int, decode_tp: int, decode_dp: int
                   ) -> Dict[tuple, int]:
    """Full (tp_rank, dp_rank) -> prefill source rank mapping."""
    return {(t, d): prefill_source_rank(prefill_tp, decode_tp, decode_dp, t, d)
            for t in range(decode_tp) for d in range(decode_dp)}


def live_connection_map(live_ranks: Sequence[int], decode_tp: int,
                        decode_dp: int) -> Dict[tuple, int]:
    """Connection mapping over the *live* prefill roster.

    With pooled spawn/park/retire the prefill ranks are no longer the
    contiguous ``0..tp-1`` the paper's formula assumes: the roster is an
    arbitrary set of instance ids. We apply the deterministic mapping over
    ``len(live_ranks)`` virtual slots, then translate each slot to the
    actual live rank in sorted id order — so the map only ever points at
    live instances and stays deterministic for a given roster.
    """
    order = sorted(set(live_ranks))
    if not order:
        raise ValueError("live_connection_map needs at least one live rank")
    n = len(order)
    base = connection_map(n, decode_tp, decode_dp)
    return {key: order[src % n] for key, src in base.items()}


def transfer_balance(mapping: Dict[tuple, int], prefill_tp: int,
                     live_ranks: Optional[Sequence[int]] = None) -> float:
    """min/max pulls per source rank (1.0 = perfectly balanced).

    Legacy call (``live_ranks=None``) assumes the static contiguous
    ``0..prefill_tp-1`` roster. With pooled spawn/retire that assumption
    lies: pass the live roster and the balance is recomputed over exactly
    those ranks — a mapping still pointing at a retired rank raises
    instead of silently folding its pulls onto a live one.
    """
    if live_ranks is not None:
        order = sorted(set(live_ranks))
        if not order:
            raise ValueError("transfer_balance needs at least one live rank")
        index = {rank: i for i, rank in enumerate(order)}
        counts = np.zeros(len(order), np.int64)
        for src in mapping.values():
            if src not in index:
                raise ValueError(
                    f"stale connection map: source rank {src} is not in the "
                    f"live prefill roster {order}")
            counts[index[src]] += 1
    else:
        counts = np.zeros(prefill_tp, np.int64)
        for src in mapping.values():
            counts[src % prefill_tp] += 1
    nz = counts[counts > 0]
    return float(nz.min() / nz.max()) if len(nz) else 1.0


def cache_nbytes(cache: Any) -> int:
    """Bytes of every array leaf (torch tensor or numpy array) in a cache
    tree, walked in :func:`~repro_torch.tree.tree_leaves`
    order; non-array leaves are skipped."""
    return sum(array_nbytes(x) for x in tree_leaves(cache)
               if hasattr(x, "dtype"))


class KVTransferEngine:
    """Charges each prefill→decode handoff to the RDMA plane.

    ``fault_hook(op) -> None | "timeout" | "corrupt"`` (typically
    :meth:`~repro_torch.serving.faults.FaultInjector.transfer_fault`) is consulted
    once per delivery *attempt*; a faulted attempt charges its cost
    (timeout window, or full wire time for a corrupted delivery), then the
    op backs off ``backoff_base_s · 2^k`` capped at ``backoff_cap_s`` and
    retries, up to ``max_retries`` retries before raising. With no hook
    the fast path is exactly the fault-free engine — one charge, no
    fingerprint work — so fault-free runs stay bit- and cost-identical.
    """

    def __init__(self, clock: SimClock | None = None,
                 plane: PlaneModel = RDMA_PLANE, *,
                 timeout_s: float = 2e-3, max_retries: int = 3,
                 backoff_base_s: float = 2.5e-4, backoff_cap_s: float = 2e-3,
                 fault_hook: Optional[Callable[[str], Optional[str]]] = None):
        if timeout_s <= 0 or max_retries < 0:
            raise ValueError("need timeout_s > 0 and max_retries >= 0")
        if backoff_base_s <= 0 or backoff_cap_s < backoff_base_s:
            raise ValueError("need 0 < backoff_base_s <= backoff_cap_s")
        self.clock = clock or SimClock()
        self.plane = plane
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.fault_hook = fault_hook
        # Hook arity is probed once per hook object: new-style hooks
        # (FaultInjector.transfer_fault) take (op, rid, chunk) so chunked
        # streaming can address faults per (rid, op, chunk); legacy
        # ``lambda op: ...`` hooks keep working unchanged.
        self._hook_probed: Any = None
        self._hook_scoped = False
        self.transfers = 0
        self.bytes_moved = 0
        self.migrations = 0
        self.bytes_migrated = 0
        self.promotes = 0
        self.bytes_promoted = 0
        self.demotes = 0
        self.bytes_demoted = 0
        self.retries = 0
        self.timeouts = 0
        self.corruptions = 0
        self.fingerprint_checks = 0

    def _idle(self, seconds: float) -> float:
        """Charge non-wire virtual time (timeout windows, backoff sleeps)
        to the clock."""
        self.clock.elapsed += seconds
        return seconds

    def _consult_hook(self, op: str, rid: Optional[int],
                      chunk: Optional[int]) -> Optional[str]:
        """Call the fault hook with per-(rid, chunk) scope when it accepts
        it, falling back to the legacy single-argument form otherwise."""
        hook = self.fault_hook
        if hook is not self._hook_probed:
            self._hook_probed = hook
            try:
                params = inspect.signature(hook).parameters
                self._hook_scoped = ("rid" in params and "chunk" in params) \
                    or any(p.kind == inspect.Parameter.VAR_KEYWORD
                           for p in params.values())
            except (TypeError, ValueError):
                self._hook_scoped = False
        if self._hook_scoped:
            return hook(op, rid=rid, chunk=chunk)
        return hook(op)

    def _deliver(self, payload: Any, op: str, rid: Optional[int] = None,
                 chunk: Optional[int] = None) -> Tuple[float, int]:
        """One op through the retry loop. Returns (seconds, nbytes) on a
        fingerprint-verified delivery; raises :class:`TransferError` after
        ``max_retries`` failed retries with the burned seconds attached."""
        nbytes = cache_nbytes(payload)
        if self.fault_hook is None:
            return self.clock.charge(self.plane, nbytes), nbytes
        sent_fp = fingerprint(payload)
        dt, failures = 0.0, 0
        while True:
            fault = self._consult_hook(op, rid, chunk)
            if fault == "timeout":
                # The plane stalls for the full window before the sender
                # gives up on this attempt; no bytes land.
                dt += self._idle(self.timeout_s)
                self.timeouts += 1
                err, what = TransferTimeout, "timed out"
            elif fault == "corrupt":
                # Full wire cost paid, but the delivered fingerprint
                # mismatches — the delivery is discarded, never applied.
                dt += self.clock.charge(self.plane, nbytes)
                self.fingerprint_checks += 1
                self.corruptions += 1
                err, what = TransferCorruption, "arrived corrupted"
            else:
                dt += self.clock.charge(self.plane, nbytes)
                self.fingerprint_checks += 1
                if fingerprint(payload) != sent_fp:
                    # Genuine (non-injected) corruption of the in-memory
                    # payload between send and delivery.
                    raise TransferCorruption(
                        f"{op} payload of {nbytes} B mutated in flight",
                        seconds=dt, nbytes=nbytes, attempts=failures + 1)
                return dt, nbytes
            failures += 1
            if failures > self.max_retries:
                raise err(
                    f"{op} of {nbytes} B {what} on all {failures} attempts "
                    f"({self.max_retries} retries exhausted)",
                    seconds=dt, nbytes=nbytes, attempts=failures)
            self.retries += 1
            dt += self._idle(min(self.backoff_base_s * (1 << (failures - 1)),
                                 self.backoff_cap_s))

    def transfer(self, cache: Any, *, rid: Optional[int] = None,
                 chunk: Optional[int] = None) -> float:
        dt, nbytes = self._deliver(cache, "transfer", rid, chunk)
        self.transfers += 1
        self.bytes_moved += nbytes
        return dt

    def migrate(self, payload: Any, *, rid: Optional[int] = None,
                chunk: Optional[int] = None) -> float:
        """Cross-engine decode KV migration rides the same isolated plane
        as the prefill→decode handoff (it must never contend with decode
        compute traffic), accounted separately so pool rebalancing cost is
        visible in benchmarks."""
        dt, nbytes = self._deliver(payload, "migrate", rid, chunk)
        self.migrations += 1
        self.bytes_migrated += nbytes
        return dt

    def promote(self, payload: Any) -> float:
        """EMS tier promotion (pooled host tier → device HBM): same
        isolated plane, separate books so cache-tier traffic is visible
        next to handoff/migration traffic."""
        dt, nbytes = self._deliver(payload, "promote")
        self.promotes += 1
        self.bytes_promoted += nbytes
        return dt

    def demote(self, payload: Any) -> float:
        """EMS write-back demotion (device HBM → pooled host tier)."""
        dt, nbytes = self._deliver(payload, "demote")
        self.demotes += 1
        self.bytes_demoted += nbytes
        return dt
