"""Multi-instance decode pools with EMS-aware routing and cross-engine KV
migration (paper §4.1; xDeepServe / DeepServe pool-level scheduling).

The paper's peer-to-peer architecture scales the decode pool independently
of prefill and caching, and the UB plane makes *any* decode instance
reachable from the shared KV store. This module adds the pool layer on top
of :class:`~repro_torch.serving.engine.DecodeEngine`:

* :class:`DecodePoolRouter` — pluggable decode-engine routing policy (by
  name: ``least_loaded_slots``, ``round_robin``, ``cache_affinity``).
  Unlike :class:`~repro_torch.serving.scheduler.PrefillRouter` (locality-free by
  design), decode routing MAY use data placement: ``cache_affinity``
  prefers the engine that already holds a request's reusable EMS prefix
  blocks (block keys from ``mempool/context_cache.py``), so the warm KV
  never crosses engines. ``select`` must be *pure* — the pool commits a
  decision via :meth:`DecodePoolRouter.on_admit` only when the request is
  actually placed, so a gated/waiting request never mutates router state
  (decisions stay deterministic across admission retries).
* :class:`DecodePool` — owns N engines (identical model/capacity), steps
  every engine with active slots per serving turn, and performs
  **cross-engine KV migration**: a slot's cache rows are drained through
  :func:`~repro_torch.serving.cache_ops.pack_request` into one contiguous byte
  buffer, charged to the RDMA-plane transfer engine, and re-inserted
  bit-exactly into a peer engine — the mechanism behind hot-pool
  rebalancing and engine retirement.
* :class:`PoolAutoscaler` — deterministic grow/hold/shrink controller for
  the decode pool (the paper's independent decode-pool scaling): between
  decode turns it compares demand (active slots + admission-queue depth)
  against the per-engine batch the TPOT budget admits
  (:meth:`DecodeCostModel.max_batch_for`) and, with hysteresis, asks the
  pool to spawn a fresh engine or retire one via migration-backed
  :meth:`DecodePool.retire_engine`.

The pool distinguishes **live** and **parked** engines: retirement drains
an engine's slots to live peers and parks it (the jitted programs stay
warm), and a later grow revives the lowest parked engine before paying
for a new one — so scale oscillation never re-compiles.

Peer-to-peer PDC completes the picture with the prefill side:

* :class:`PrefillPool` — the same spawn/park/retire/fail lifecycle over
  :class:`~repro_torch.serving.engine.PrefillEngine` instances. Prefill holds no
  resident per-request state between requests, so retirement parks an
  instance immediately (no drain) and failure only loses the instance,
  never a request. Instance ids are stable; the scheduler's
  ``PrefillRouter.resize`` / ``set_prefill_live`` views key on them.
* :class:`JointAutoscaler` — a capacity-conserving controller that shifts
  engines between the prefill and decode roles under one SLO budget
  (DeepServe's serverless joint P/D scaling): TTFT pressure (virtual
  prefill backlog past the TTFT budget) converts a drained decode engine
  into a prefill instance; TPOT pressure (decode demand past the SLO
  batch cap) converts an idle prefill instance into a decode engine.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.scheduler import DecodeCostModel, SlotError
from repro_torch.serving.transfer import TransferError


class DrainError(SlotError):
    """An engine drain moved some requests and then hit an exhausted
    RDMA-plane transfer. ``moved`` holds the migrations that completed
    (those requests live on their destinations); ``failed_rid`` is the
    request whose payload never left the source engine — its slot is
    intact there, so the caller can fall back to replay re-prefill
    instead of propagating possibly-garbage KV."""

    def __init__(self, msg: str, moved: List[Tuple[int, int, float]],
                 failed_rid: int):
        super().__init__(msg)
        self.moved = moved
        self.failed_rid = failed_rid


# ---------------------------------------------------------------------------
# Decode-pool routing policies
# ---------------------------------------------------------------------------


class DecodePoolRouter:
    """Chooses a decode engine for an admitted request.

    ``select`` sees per-engine active/free slot counts plus the request's
    EMS block keys, and must be pure and deterministic; state transitions
    happen only in ``on_admit`` (called when the placement commits).
    ``candidates`` restricts the choice to the pool's *live* engines
    (autoscaling parks retired engines in place, so engine ids are stable
    but not all of them are eligible); omitted means every engine.
    """

    name = "base"
    #: whether the ServingSystem should compute EMS block keys per request
    uses_affinity = False

    def __init__(self, n_engines: int):
        if n_engines < 1:
            raise ValueError("need at least one decode engine")
        self.n = n_engines

    def resize(self, n_engines: int) -> None:
        """The pool spawned engines: ids ``[old_n, n_engines)`` now exist."""
        if n_engines < self.n:
            raise ValueError(
                "pool engine ids never disappear (retired engines are "
                f"parked, not removed): cannot resize {self.n} -> {n_engines}")
        self.n = n_engines

    def _candidates(self,
                    candidates: Optional[Sequence[int]]) -> List[int]:
        cands = list(range(self.n)) if candidates is None else list(candidates)
        if not cands:
            raise ValueError("no live decode engine to route to")
        return cands

    def select(self, active: Sequence[int], free: Sequence[int],
               block_keys: Sequence[str] = (),
               candidates: Optional[Sequence[int]] = None) -> int:
        raise NotImplementedError

    def on_admit(self, engine: int,
                 block_keys: Sequence[str] = ()) -> None:  # pragma: no cover
        """Notification that a routed request was actually placed."""

    def on_retire(self, engine: int) -> None:  # pragma: no cover - hook
        """Notification that ``engine`` left the live set (drained and
        parked, or failed): any placement state pointing at it is stale."""

    def on_migrate(self, engine: int,
                   block_keys: Sequence[str] = ()) -> None:  # pragma: no cover
        """Notification that an in-flight request's KV landed on
        ``engine`` via cross-engine migration. Distinct from ``on_admit``
        on purpose: a migration is not an admission (the round-robin
        cursor must not advance for one), but affinity state must follow
        the bytes."""

    def residency(self, engine: int, block_keys: Sequence[str]) -> int:
        """How many of ``block_keys`` this router believes are resident on
        ``engine`` (0 for locality-free policies) — the rebalancer's signal
        for picking migration victims that will not thrash affinity."""
        return 0


class LeastLoadedSlotsRouter(DecodePoolRouter):
    """Engine with the fewest active slots, preferring engines that have a
    free slot at all (ties → lowest id)."""

    name = "least_loaded_slots"

    def select(self, active: Sequence[int], free: Sequence[int],
               block_keys: Sequence[str] = (),
               candidates: Optional[Sequence[int]] = None) -> int:
        return min(self._candidates(candidates),
                   key=lambda i: (free[i] <= 0, active[i], i))


class PoolRoundRobinRouter(DecodePoolRouter):
    """Strict cyclic assignment in admission order. The cursor advances on
    *commit* (``on_admit``), so a request the gate holds retries the same
    engine — deterministic for a fixed request stream. With parked engines
    the cycle runs over the live ids (first live id at or after the
    cursor)."""

    name = "round_robin"

    def __init__(self, n_engines: int):
        super().__init__(n_engines)
        self._next = 0

    def select(self, active: Sequence[int], free: Sequence[int],
               block_keys: Sequence[str] = (),
               candidates: Optional[Sequence[int]] = None) -> int:
        cands = self._candidates(candidates)
        for i in cands:
            if i >= self._next:
                return i
        return cands[0]                      # wrap past the highest live id

    def on_admit(self, engine: int,
                 block_keys: Sequence[str] = ()) -> None:
        self._next = (engine + 1) % self.n


class CacheAffinityRouter(DecodePoolRouter):
    """EMS-aware placement: prefer the engine already holding the request's
    reusable prefix blocks, falling back to least-loaded-slots. Engines
    with no free slot are deprioritized so affinity never stalls the pool
    while a peer sits idle.

    With an :class:`~repro_torch.mempool.ems.EMSService` bound (``ems=``), the
    residency signal is **derived from the shared EMS index** — the
    hit-depth of the request's leading block keys in each engine's device
    tier (``engine_residency``), with placements/migrations recorded as
    EMS pins and retire/fail dropping the whole tier. Routing and cache
    reality therefore cannot drift: the router reads the same structure
    the cache serves from. Without an EMS the legacy advisory
    key→last-engine map is kept for back-compat (it persists across
    serve() waves; cache affinity is cross-wave by nature)."""

    name = "cache_affinity"
    uses_affinity = True

    def __init__(self, n_engines: int, ems=None):
        super().__init__(n_engines)
        self.ems = ems
        self._resident: Dict[str, int] = {}   # block key -> last engine

    @staticmethod
    def _tag(engine: int) -> str:
        """EMS device-tier tag of a pool decode engine."""
        return f"decode{engine}"

    def score(self, block_keys: Sequence[str]) -> List[int]:
        if self.ems is not None:
            return [self.ems.engine_residency(self._tag(e), block_keys)
                    for e in range(self.n)]
        scores = [0] * self.n
        for k in block_keys:
            e = self._resident.get(k)
            if e is not None:
                scores[e] += 1
        return scores

    def select(self, active: Sequence[int], free: Sequence[int],
               block_keys: Sequence[str] = (),
               candidates: Optional[Sequence[int]] = None) -> int:
        scores = self.score(block_keys)
        return min(self._candidates(candidates),
                   key=lambda i: (free[i] <= 0, -scores[i], active[i], i))

    def on_admit(self, engine: int,
                 block_keys: Sequence[str] = ()) -> None:
        if self.ems is not None:
            self.ems.pin(self._tag(engine), block_keys)
            return
        for k in block_keys:
            self._resident[k] = engine

    def on_retire(self, engine: int) -> None:
        # A parked or failed engine's cache rows are dead: routing future
        # requests toward it by stale residency would fight the live mask.
        # With an EMS the device tier is dropped (dirty blocks demote
        # first), so the pooled tier keeps every cached prefix.
        if self.ems is not None:
            self.ems.drop_engine(self._tag(engine))
            return
        self._resident = {k: e for k, e in self._resident.items()
                          if e != engine}

    def on_migrate(self, engine: int,
                   block_keys: Sequence[str] = ()) -> None:
        if self.ems is not None:
            self.ems.pin(self._tag(engine), block_keys)
            return
        for k in block_keys:
            self._resident[k] = engine

    def residency(self, engine: int, block_keys: Sequence[str]) -> int:
        if self.ems is not None:
            return self.ems.engine_residency(self._tag(engine), block_keys)
        return sum(1 for k in block_keys
                   if self._resident.get(k) == engine)


DECODE_ROUTERS = {r.name: r for r in
                  (LeastLoadedSlotsRouter, PoolRoundRobinRouter,
                   CacheAffinityRouter)}


def make_decode_router(policy: str, n_engines: int,
                       ems=None) -> DecodePoolRouter:
    """Build a decode-pool router by name. ``ems`` (an
    :class:`~repro_torch.mempool.ems.EMSService`, or None) binds affinity-aware
    policies to the shared cache index; locality-free policies ignore it."""
    try:
        cls = DECODE_ROUTERS[policy]
    except KeyError:
        raise ValueError(
            f"unknown decode routing policy {policy!r}; "
            f"available: {sorted(DECODE_ROUTERS)}") from None
    if cls.uses_affinity:
        return cls(n_engines, ems=ems)
    return cls(n_engines)


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------


class DecodePool:
    """N decode engines behind one routing/migration facade.

    Engines must be homogeneous (same model config and KV capacity) so a
    migrated cache payload lands on an identical layout. Compute stays in
    the engines; the pool only routes, steps, and moves KV.

    ``engine_factory`` (seed -> DecodeEngine) enables the autoscaling grow
    path: :meth:`spawn_engine` revives the lowest parked engine when one
    exists (retirement parks engines in place, so engine ids — and every
    per-engine scheduler view keyed on them — stay stable) and otherwise
    constructs a fresh engine mid-wave.
    """

    def __init__(self, engines: Sequence, router: DecodePoolRouter,
                 engine_factory: Optional[Callable] = None):
        engines = list(engines)
        if not engines:
            raise ValueError("need at least one decode engine")
        if router.n != len(engines):
            raise ValueError(
                f"router sized for {router.n} engines, pool has "
                f"{len(engines)}")
        self._assert_homogeneous(engines)
        self.engines = engines
        self.router = router
        self.engine_factory = engine_factory
        self._live = [True] * len(engines)
        # Dead ≠ parked: a parked engine drained its slots and keeps warm
        # device state (revival is free); a dead engine crashed, its KV is
        # lost, and revival means a process restart over the same id.
        self._dead = [False] * len(engines)
        self._request_keys: Dict[int, Tuple[str, ...]] = {}
        self.migrations = 0
        self.migrated_bytes = 0
        self.failures = 0
        self.preemptions = 0

    @staticmethod
    def _assert_homogeneous(engines: Sequence) -> None:
        if len({(e.capacity, e.cfg.name) for e in engines}) != 1:
            raise ValueError(
                "pool engines must share model config and KV capacity "
                "(migration payloads assume an identical cache layout)")

    # -- aggregate views ---------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.engines)

    @property
    def n_live(self) -> int:
        return sum(self._live)

    @property
    def live_ids(self) -> List[int]:
        return [i for i, live in enumerate(self._live) if live]

    @property
    def live_mask(self) -> List[bool]:
        return list(self._live)

    @property
    def n_dead(self) -> int:
        return sum(self._dead)

    @property
    def dead_ids(self) -> List[int]:
        return [i for i, dead in enumerate(self._dead) if dead]

    @property
    def active(self) -> int:
        """Active slots across *live* engines — serveable demand. Parked
        and failed engines hold no work by construction (drain moves it,
        ``fail_engine`` releases it), so excluding them is belt-and-braces
        for the autoscaler's demand math: a non-live engine must never
        count as capacity or as load."""
        return sum(e.active for e, live in zip(self.engines, self._live)
                   if live)

    @property
    def capacity(self) -> int:
        return self.engines[0].capacity

    @property
    def use_mtp(self) -> bool:
        return self.engines[0].use_mtp

    @property
    def slot_mgrs(self) -> List:
        return [e.slot_mgr for e in self.engines]

    def locate(self, rid: int) -> Optional[Tuple[int, int]]:
        """(engine, slot) currently decoding ``rid``, or None."""
        for e, eng in enumerate(self.engines):
            for slot, info in eng.slot_mgr.active_slots():
                if info.rid == rid:
                    return e, slot
        return None

    # -- routing + placement ----------------------------------------------
    def select_engine(self, block_keys: Sequence[str] = ()) -> int:
        return self.router.select([e.active for e in self.engines],
                                  [e.slot_mgr.free for e in self.engines],
                                  block_keys, candidates=self.live_ids)

    def add(self, engine: int, slot: int, req_cache, first_token: int,
            prompt_len: int, result, max_new: int,
            block_keys: Sequence[str] = ()) -> None:
        """Place a prefilled request on ``engine`` and commit the routing
        decision (router state mutates only here)."""
        if not self._live[engine]:
            raise SlotError(f"engine {engine} is parked (retired)")
        self.engines[engine].add(slot, req_cache, first_token, prompt_len,
                                 result, max_new)
        if block_keys:
            self._request_keys[result.rid] = tuple(block_keys)
        self.router.on_admit(engine, block_keys)

    # -- stepping ----------------------------------------------------------
    def step_engine(self, engine: int, continuous: bool = False,
                    refill_pending: bool = False) -> Tuple[list, list]:
        """One host-sync chunk on a single engine (the continuous-batching
        serve loop steps engines individually so freed slots can be
        refilled *between* engine chunks within one decode turn).
        ``continuous``/``refill_pending`` thread through to
        :meth:`~repro_torch.serving.engine.DecodeEngine.step_chunk`'s adaptive
        chunk sizing. Returns ``(finished, iter_log)``."""
        eng = self.engines[engine]
        finished, iter_log = eng.step_chunk(continuous=continuous,
                                            refill_pending=refill_pending)
        for r in finished:
            self._request_keys.pop(r.rid, None)
        return finished, iter_log

    def step_all(self) -> List[Tuple[int, list, list]]:
        """One decode turn across the pool: every live engine with active
        slots runs one host-sync chunk. Returns ``(engine, finished,
        iter_log)`` per stepped engine, in engine order, so the scheduler
        can charge each engine's virtual clock independently."""
        out = []
        for e, eng in enumerate(self.engines):
            if self._live[e] and eng.active:
                finished, iter_log = self.step_engine(e)
                out.append((e, finished, iter_log))
        return out

    # -- engine lifecycle (autoscaling + failure) --------------------------
    def fail_engine(self, engine: int) -> List[Tuple[int, Any, int]]:
        """Crash ``engine``: mark it dead (distinct from parked — its
        device-side KV is lost; revival is a process restart, not a warm
        unpark), release every active slot with conserved accounting
        (``acquired == released + active`` holds across the failure), and
        clear the router's residency for it so post-failure routing never
        scores a dead engine. Returns the in-flight ``(rid, payload,
        cache_len)`` records so the serving layer can recover each request
        by replay re-prefill."""
        if self._dead[engine]:
            raise ValueError(f"engine {engine} is already dead")
        eng = self.engines[engine]
        lost: List[Tuple[int, Any, int]] = []
        for slot, info in list(eng.slot_mgr.active_slots()):
            eng.slot_mgr.release(slot)
            self._request_keys.pop(info.rid, None)
            lost.append((info.rid, info.payload, info.cache_len))
        self._live[engine] = False
        self._dead[engine] = True
        self.failures += 1
        self.router.on_retire(engine)
        return lost

    def evict(self, rid: int) -> Tuple[int, Any, int]:
        """Preempt one in-flight request: release its slot with conserved
        accounting and return ``(engine, payload, cache_len)`` so the
        serving layer can park it (prompt + emitted tokens) for replay
        re-admission. The engine stays live — unlike :meth:`fail_engine`
        its router residency is kept, so a cache-affine re-admission can
        still prefer the engine whose EMS blocks are warm. The freed
        slot's device-side KV is abandoned in place: a later ``add`` on
        the slot overwrites it, exactly like post-failure slot reuse."""
        loc = self.locate(rid)
        if loc is None:
            raise SlotError(f"rid {rid} is not decoding on any engine")
        engine, slot = loc
        info = self.engines[engine].slot_mgr.release(slot)
        self._request_keys.pop(rid, None)
        self.preemptions += 1
        return engine, info.payload, info.cache_len

    def spawn_engine(self) -> Tuple[int, bool]:
        """Grow the pool by one live engine. Returns ``(engine, revived)``:
        the lowest parked engine is revived when one exists (its jitted
        programs are already warm; its drained slots are empty), then the
        lowest dead engine is restarted over its stable id (its slots were
        released at failure, so the stale device state is unreachable),
        otherwise ``engine_factory`` builds a fresh engine whose id extends
        the pool (never reindexing peers)."""
        for e, live in enumerate(self._live):
            if not live and not self._dead[e]:
                self._live[e] = True
                return e, True
        for e, dead in enumerate(self._dead):
            if dead:
                self._dead[e] = False
                self._live[e] = True
                return e, True
        if self.engine_factory is None:
            raise RuntimeError(
                "pool has no engine_factory; cannot spawn a new engine")
        eng = self.engine_factory(self.n)
        self._assert_homogeneous([self.engines[0], eng])
        self.engines.append(eng)
        self._live.append(True)
        self._dead.append(False)
        self.router.resize(self.n)
        return self.n - 1, False

    def retire_engine(self, engine: int, transfer=None
                      ) -> List[Tuple[int, int, float]]:
        """Shrink the pool: atomically drain ``engine`` to its live peers
        and park it (the engine object — and its id — survive for a later
        revival). Returns the drain's ``(rid, dst, seconds)`` moves."""
        if not self._live[engine]:
            raise ValueError(f"engine {engine} is already parked")
        if self.n_live <= 1:
            raise ValueError("cannot retire the last live engine")
        moved = self.drain_engine(engine, transfer)
        self._live[engine] = False
        self.router.on_retire(engine)
        return moved

    # -- cross-engine KV migration ----------------------------------------
    def migrate(self, rid: int, dst_engine: int,
                transfer=None) -> Tuple[int, int, float]:
        """Drain ``rid``'s slot from its current engine into ``dst_engine``
        bit-exactly. Returns (src_engine, dst_slot, transfer_seconds).

        The slot's cache rows, ``cache_len``, current/draft tokens, and
        engine-side payload all move; the drain is charged to the
        RDMA-plane ``transfer`` engine when one is given (the paper's
        scale-out plane — migration never contends with decode compute).
        """
        loc = self.locate(rid)
        if loc is None:
            raise SlotError(f"rid={rid} is not resident in any pool engine")
        src_e, src_slot = loc
        if src_e == dst_engine:
            raise ValueError(
                f"rid={rid} already decodes on engine {dst_engine}")
        if not 0 <= dst_engine < self.n:
            raise ValueError(f"no engine {dst_engine} in a pool of {self.n}")
        if not self._live[dst_engine]:
            raise SlotError(
                f"engine {dst_engine} is parked (retired); cannot migrate "
                f"rid={rid} onto it")
        src, dst = self.engines[src_e], self.engines[dst_engine]
        dst_slot = dst.slot_mgr.free_slot()
        if dst_slot is None:
            raise SlotError(
                f"engine {dst_engine} has no free slot for migration")
        flat, cache_len, cur_tok, draft_tok = src.export_slot(src_slot)
        # The RDMA charge (and its retry loop) runs BEFORE the source slot
        # is released: an exhausted transfer raises here and the request
        # stays intact on the source engine — a failed migration never
        # half-moves a request or propagates an unverified payload.
        seconds = 0.0 if transfer is None else transfer.migrate(flat)
        info = src.slot_mgr.release(src_slot)
        dst.import_slot(dst_slot, flat, cache_len, cur_tok, draft_tok,
                        info.rid, info.payload)
        self.router.on_migrate(dst_engine, self._request_keys.get(rid, ()))
        self.migrations += 1
        self.migrated_bytes += int(flat.nbytes)
        return src_e, dst_slot, seconds

    def rebalance(self, transfer=None
                  ) -> Optional[Tuple[int, int, int, float]]:
        """Migrate one request from the hottest live engine to the coldest
        when the active-slot imbalance is >= 2 and the coldest has room —
        the pool-level rebalancing that keeps per-engine batches (and
        therefore per-engine TPOT) even. Deterministic: lowest engine ids
        win ties. The victim is the hottest engine's lowest-numbered active
        slot **without block residency on that engine** (per the router's
        affinity map): migrating a request off the engine that holds its
        cached prefix blocks would make the ``cache_affinity`` router fight
        the move on the very next shared-prefix admission. Returns
        (rid, src_engine, dst_engine, seconds) or None."""
        live = self.live_ids
        if len(live) < 2:
            return None
        act = [self.engines[i].active for i in range(self.n)]
        hot = min(live, key=lambda i: (-act[i], i))
        cold = min(live, key=lambda i: (act[i], i))
        if act[hot] - act[cold] < 2 \
                or self.engines[cold].slot_mgr.free_slot() is None:
            return None
        slots = list(self.engines[hot].slot_mgr.active_slots())
        _, info = min(slots, key=lambda si: (self.router.residency(
            hot, self._request_keys.get(si[1].rid, ())) > 0, si[0]))
        rid = info.rid
        src_e, _, seconds = self.migrate(rid, cold, transfer)
        return rid, src_e, cold, seconds

    def peer_free_slots(self, engine: int) -> int:
        """Aggregate free slots across ``engine``'s live peers — the
        capacity a drain must fit into to be all-or-nothing."""
        return sum(self.engines[i].slot_mgr.free for i in self.live_ids
                   if i != engine)

    def can_drain(self, engine: int) -> bool:
        return self.engines[engine].active <= self.peer_free_slots(engine)

    def drain_engine(self, engine: int, transfer=None
                     ) -> List[Tuple[int, int, float]]:
        """Retire an engine's load: migrate every active slot to live peers
        with free capacity (least-loaded first). All-or-nothing: aggregate
        peer free capacity is pre-checked, so the drain either moves every
        request or raises :class:`SlotError` having moved none (a raise
        after a partial drain would leave an engine half-retired with no
        way to tell which requests moved)."""
        victims = list(self.engines[engine].slot_mgr.active_slots())
        headroom = self.peer_free_slots(engine)
        if len(victims) > headroom:
            raise SlotError(
                f"cannot drain engine {engine}: {len(victims)} active "
                f"requests but live peers have only {headroom} free slots "
                "(drain is all-or-nothing; nothing was migrated)")
        moved = []
        for _, info in victims:
            peers = [i for i in self.live_ids if i != engine
                     and self.engines[i].slot_mgr.free_slot() is not None]
            dst = min(peers, key=lambda i: (self.engines[i].active, i))
            try:
                _, _, seconds = self.migrate(info.rid, dst, transfer)
            except TransferError as exc:
                # The capacity pre-check held but the RDMA plane gave out
                # mid-drain. Completed moves stand; the failed request is
                # still whole on the source — surface both so the caller
                # can recover it by replay instead of unwinding the drain.
                raise DrainError(
                    f"drain of engine {engine} failed migrating "
                    f"rid={info.rid} after {len(moved)} completed moves: "
                    f"{exc}", moved, info.rid) from exc
            moved.append((info.rid, dst, seconds))
        return moved

    # -- reporting ---------------------------------------------------------
    def engine_stats(self) -> List[Dict[str, int]]:
        return [{"engine": e, "live": self._live[e], "dead": self._dead[e],
                 "active": eng.active,
                 "iters": eng.iters,
                 "live_slot_iters": eng.live_slot_iters,
                 "dead_slot_iters": eng.dead_slot_iters,
                 "slots_acquired": eng.slot_mgr.acquired,
                 "slots_released": eng.slot_mgr.released}
                for e, eng in enumerate(self.engines)]


# ---------------------------------------------------------------------------
# Prefill pool (peer-to-peer PDC: the prefill side scales independently)
# ---------------------------------------------------------------------------


class PrefillPool:
    """N prefill instances behind the decode pool's lifecycle semantics.

    Unlike decode engines, prefill instances are stateless between
    requests (``PrefillEngine.run`` is synchronous and holds no resident
    slots), so the lifecycle is lighter: retirement parks an instance
    immediately — no drain, nothing to migrate — and failure loses only
    the instance, never an in-flight request. What *is* shared with
    :class:`DecodePool` is the stable-id contract: instance ids never
    disappear or reindex, parked instances revive for free (their jitted
    programs stay warm), dead instances restart over their own id, and a
    fresh spawn extends the roster through ``engine_factory``
    (``instance_id -> PrefillEngine``). The scheduler mirrors the roster
    via ``register_prefill_instance`` / ``set_prefill_live``.
    """

    def __init__(self, engines: Sequence,
                 engine_factory: Optional[Callable] = None):
        engines = list(engines)
        if not engines:
            raise ValueError("need at least one prefill instance")
        self._assert_homogeneous(engines)
        self.engines = engines
        self.engine_factory = engine_factory
        self._live = [True] * len(engines)
        self._dead = [False] * len(engines)
        self.spawns = 0
        self.retires = 0
        self.failures = 0

    @staticmethod
    def _assert_homogeneous(engines: Sequence) -> None:
        if len({(e.capacity, e.cfg.name) for e in engines}) != 1:
            raise ValueError(
                "prefill instances must share model config and cache "
                "capacity (handoff payloads assume an identical layout)")

    # -- aggregate views ---------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.engines)

    @property
    def n_live(self) -> int:
        return sum(self._live)

    @property
    def live_ids(self) -> List[int]:
        return [i for i, live in enumerate(self._live) if live]

    @property
    def live_mask(self) -> List[bool]:
        return list(self._live)

    @property
    def n_dead(self) -> int:
        return sum(self._dead)

    @property
    def dead_ids(self) -> List[int]:
        return [i for i, dead in enumerate(self._dead) if dead]

    @property
    def loads(self) -> List[int]:
        """Per-instance in-flight prompt tokens (full roster, stable ids;
        parked instances report 0 by construction)."""
        return [e.load for e in self.engines]

    # -- lifecycle ---------------------------------------------------------
    def spawn_engine(self) -> Tuple[int, bool]:
        """Grow the pool by one live instance. Returns ``(instance,
        revived)`` with the same preference order as the decode pool:
        revive the lowest parked instance (warm programs), restart the
        lowest dead one over its stable id, else build a fresh instance
        whose id extends the roster."""
        for i, live in enumerate(self._live):
            if not live and not self._dead[i]:
                self._live[i] = True
                self.spawns += 1
                return i, True
        for i, dead in enumerate(self._dead):
            if dead:
                self._dead[i] = False
                self._live[i] = True
                self.spawns += 1
                return i, True
        if self.engine_factory is None:
            raise RuntimeError(
                "prefill pool has no engine_factory; cannot spawn a new "
                "instance")
        eng = self.engine_factory(self.n)
        self._assert_homogeneous([self.engines[0], eng])
        self.engines.append(eng)
        self._live.append(True)
        self._dead.append(False)
        self.spawns += 1
        return self.n - 1, False

    def retire_engine(self, instance: int) -> None:
        """Shrink the pool: park ``instance`` (its id — and warm jitted
        programs — survive for a later revival). Prefill holds no resident
        requests, so there is nothing to drain; already-routed work was
        charged to the instance's virtual clock and completes there."""
        if not self._live[instance]:
            raise ValueError(f"prefill instance {instance} is already parked")
        if self.n_live <= 1:
            raise ValueError("cannot retire the last live prefill instance")
        self._live[instance] = False
        self.retires += 1

    def fail_engine(self, instance: int) -> None:
        """Crash ``instance``: dead, not parked (revival is a restart).
        No request is lost — prefill runs to completion synchronously —
        but the roster shrinks until a spawn restarts the id."""
        if self._dead[instance]:
            raise ValueError(f"prefill instance {instance} is already dead")
        self._live[instance] = False
        self._dead[instance] = True
        self.failures += 1

    # -- reporting ---------------------------------------------------------
    def engine_stats(self) -> List[Dict[str, Any]]:
        return [{"instance": i, "live": self._live[i], "dead": self._dead[i],
                 "load": eng.load,
                 "fresh_dispatches": eng.continue_calls,
                 "suffix_dispatches": eng.suffix_calls}
                for i, eng in enumerate(self.engines)]


# ---------------------------------------------------------------------------
# SLO-driven utilization controller
# ---------------------------------------------------------------------------


class PoolAutoscaler:
    """Deterministic grow/hold/shrink controller for the decode pool.

    Evaluated between decode turns on pure control-plane signals — no
    wall clock, no randomness — so a fixed request stream always produces
    the same scale-event sequence:

    * **demand** = pool-wide active slots + admission-queue depth (the
      requests that would decode right now if capacity allowed);
    * **per-engine cap** = the largest batch one engine may carry: its
      slot count, intersected with the batch whose projected per-token
      TPOT meets the budget (:meth:`DecodeCostModel.max_batch_for` — the
      same projection the admission gate enforces).

    Grow when demand exceeds what the live engines can carry at the SLO
    cap (spreading the demand over N engines would push projected TPOT
    past the budget, so the gate is queuing); shrink when N-1 engines
    could absorb the whole demand at the cap and nothing is queued. Both
    need the condition to hold for ``grow_patience`` / ``shrink_patience``
    consecutive turns, and every scale event starts a ``cooldown`` during
    which the controller holds (and its streaks reset) — the hysteresis
    that keeps a demand level sitting exactly on a threshold from flapping
    the pool. Never emits grow and shrink for the same turn by
    construction (one decision per ``decide``; the conditions are
    mutually exclusive for any cap >= 1).
    """

    def __init__(self, cost: DecodeCostModel, n_slots: int,
                 min_engines: int, max_engines: int,
                 tpot_budget_s: Optional[float] = None,
                 grow_patience: int = 1, shrink_patience: int = 3,
                 cooldown: int = 2):
        if n_slots < 1:
            raise ValueError("n_slots must be positive")
        if not 1 <= min_engines <= max_engines:
            raise ValueError(
                f"need 1 <= min_engines <= max_engines, got "
                f"[{min_engines}, {max_engines}]")
        if grow_patience < 1 or shrink_patience < 1 or cooldown < 0:
            raise ValueError("patience must be >= 1 and cooldown >= 0")
        self.engine_cap = n_slots
        if tpot_budget_s is not None:
            self.engine_cap = min(n_slots,
                                  max(1, cost.max_batch_for(tpot_budget_s)))
        self.min_engines = min_engines
        self.max_engines = max_engines
        self.grow_patience = grow_patience
        self.shrink_patience = shrink_patience
        self.cooldown = cooldown
        self.reset()

    def reset(self) -> None:
        """Fresh hysteresis state (one serve() wave = one controller run)."""
        self._grow_streak = 0
        self._shrink_streak = 0
        self._cooldown_left = 0

    def decide(self, n_live: int, active: int, queue_depth: int,
               shrinkable: bool = True) -> str:
        """'grow' | 'hold' | 'shrink' for this decode turn.

        ``shrinkable`` is the pool's atomic-drain pre-check for the would-be
        victim (``DecodePool.can_drain``): a shrink the peers cannot absorb
        is reported as hold (the shrink streak resets; no cooldown is
        spent on it).

        ``n_live`` must be the pool's *live* roster for this turn —
        failed/parked engines excluded — not the constructed engine count:
        a dead engine counts as neither capacity nor demand. When capacity
        loss drops the roster below ``min_engines`` the controller respawns
        immediately, bypassing patience and cooldown: hysteresis exists to
        damp demand noise, not to slow down failure recovery.
        """
        if n_live < self.min_engines:
            self._grow_streak = self._shrink_streak = 0
            self._cooldown_left = 0
            return "grow"
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._grow_streak = self._shrink_streak = 0
            return "hold"
        demand = active + queue_depth
        if demand > n_live * self.engine_cap and n_live < self.max_engines:
            self._shrink_streak = 0
            self._grow_streak += 1
            if self._grow_streak >= self.grow_patience:
                self._grow_streak = 0
                self._cooldown_left = self.cooldown
                return "grow"
            return "hold"
        self._grow_streak = 0
        if (queue_depth == 0 and n_live > self.min_engines
                and demand <= (n_live - 1) * self.engine_cap and shrinkable):
            self._shrink_streak += 1
            if self._shrink_streak >= self.shrink_patience:
                self._shrink_streak = 0
                self._cooldown_left = self.cooldown
                return "shrink"
            return "hold"
        self._shrink_streak = 0
        return "hold"


class JointAutoscaler:
    """Capacity-conserving joint P/D controller: shift engines between the
    prefill and decode roles under one SLO budget.

    Where :class:`PoolAutoscaler` changes the decode pool's *size*, this
    controller changes the *split* of a fixed engine budget between roles
    (the generalization the paper's peer-to-peer architecture implies and
    DeepServe's serverless controller implements). Evaluated between
    decode turns on pure control-plane signals, so a fixed request stream
    always produces the same shift sequence:

    * **TPOT pressure** — decode demand (active slots + admission-queue
      depth) exceeds what the live decode engines carry at the SLO batch
      cap (the same :meth:`DecodeCostModel.max_batch_for` projection the
      admission gate enforces);
    * **TTFT pressure** — the worst live prefill instance's virtual
      backlog (queued prefill seconds, :meth:`Scheduler.prefill_backlog_s`)
      exceeds the TTFT budget.

    ``shift_d2p`` fires when prefill is TTFT-pressured AND the decode pool
    can spare an engine (demand fits on N-1 engines at the cap, the victim
    is drainable, and the clamps allow it): one decode engine drains and
    parks, one prefill instance spawns. ``shift_p2d`` is the mirror image
    for TPOT pressure against an idle prefill pool. Per-direction patience
    plus a shared cooldown give the same flap-damping hysteresis as the
    size controller; the two directions are mutually exclusive within a
    turn by construction (each requires the other role to be unpressured).
    """

    def __init__(self, cost: DecodeCostModel, n_slots: int, *,
                 min_prefill: int, max_prefill: int,
                 min_decode: int, max_decode: int,
                 tpot_budget_s: Optional[float] = None,
                 ttft_budget_s: Optional[float] = None,
                 patience: int = 1, cooldown: int = 2):
        if n_slots < 1:
            raise ValueError("n_slots must be positive")
        for lo, hi, what in ((min_prefill, max_prefill, "prefill"),
                             (min_decode, max_decode, "decode")):
            if not 1 <= lo <= hi:
                raise ValueError(
                    f"need 1 <= min_{what} <= max_{what}, got [{lo}, {hi}]")
        if patience < 1 or cooldown < 0:
            raise ValueError("patience must be >= 1 and cooldown >= 0")
        self.engine_cap = n_slots
        if tpot_budget_s is not None:
            self.engine_cap = min(n_slots,
                                  max(1, cost.max_batch_for(tpot_budget_s)))
        self.min_prefill = min_prefill
        self.max_prefill = max_prefill
        self.min_decode = min_decode
        self.max_decode = max_decode
        self.ttft_budget_s = ttft_budget_s
        self.patience = patience
        self.cooldown = cooldown
        self.reset()

    def reset(self) -> None:
        """Fresh hysteresis state (one serve() wave = one controller run)."""
        self._d2p_streak = 0
        self._p2d_streak = 0
        self._cooldown_left = 0

    def decide(self, n_live_prefill: int, n_live_decode: int, active: int,
               queue_depth: int, prefill_backlog_s: float,
               decode_shrinkable: bool = True) -> str:
        """'shift_d2p' | 'shift_p2d' | 'hold' for this decode turn.

        ``decode_shrinkable`` is the atomic-drain pre-check for the
        would-be decode victim (``DecodePool.can_drain``); a d2p shift the
        peers cannot absorb reports hold and resets the streak, exactly
        like the size controller's shrink path.
        """
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._d2p_streak = self._p2d_streak = 0
            return "hold"
        demand = active + queue_depth
        ttft_pressured = (self.ttft_budget_s is not None
                          and prefill_backlog_s > self.ttft_budget_s)
        tpot_pressured = demand > n_live_decode * self.engine_cap
        # An idle prefill pool has burned through its backlog (well under
        # budget); only then may it donate an instance to decode.
        prefill_idle = prefill_backlog_s <= (self.ttft_budget_s or 0.0) / 2
        if (ttft_pressured and not tpot_pressured and decode_shrinkable
                and n_live_decode > self.min_decode
                and queue_depth == 0
                and demand <= (n_live_decode - 1) * self.engine_cap
                and n_live_prefill < self.max_prefill):
            self._p2d_streak = 0
            self._d2p_streak += 1
            if self._d2p_streak >= self.patience:
                self._d2p_streak = 0
                self._cooldown_left = self.cooldown
                return "shift_d2p"
            return "hold"
        self._d2p_streak = 0
        if (tpot_pressured and not ttft_pressured and prefill_idle
                and n_live_prefill > self.min_prefill
                and n_live_decode < self.max_decode):
            self._p2d_streak += 1
            if self._p2d_streak >= self.patience:
                self._p2d_streak = 0
                self._cooldown_left = self.cooldown
                return "shift_p2d"
            return "hold"
        self._p2d_streak = 0
        return "hold"
