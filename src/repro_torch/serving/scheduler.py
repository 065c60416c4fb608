"""SLO-aware PDC scheduling subsystem (paper §4.1, Table 5).

The paper's headline number is a *trade-off*: 538 tokens/s per NPU **under a
15 ms TPOT budget**, reached by independently scaling prefill, decode, and
caching pools and by sizing the decode batch to the SLO (Table 5: batch
96→24→8 for 50/30/15 ms). This module extracts every scheduling decision out
of ``serving/engine.py`` into small, separately testable pieces:

* :class:`PrefillRouter`      — pluggable prefill routing policy (by name:
  ``least_loaded``, ``round_robin``, ``queue_depth``). All are *stateless
  with respect to data placement* — no cache-affinity term, the paper's
  central contrast with KVCache-centric scheduling.
* :class:`DecodeSlotManager`  — owns decode slot allocation/eviction with
  per-request ``cache_len`` accounting; raises on double assignment or
  capacity overflow instead of silently corrupting batch state.
* :class:`AdmissionGate`      — projects the TPOT of the next decode batch
  from a linear step-time model (t(B) = t_fixed + B·t_per_req, the same
  decomposition ``bench_tpot_slo`` uses) and refuses admissions that would
  push projected TPOT over the configured budget. ``mode="queue"`` holds the
  request until the batch drains; ``mode="shed"`` rejects it immediately.
* :class:`SLOTracker`         — records per-request TTFT/TPOT and exposes
  p50/p99 summaries plus shed accounting.
* :class:`MicrobatchInterleaver` — pairs two decode microbatches through
  ``core/microbatch.py`` so one stream's MoE dispatch/combine communication
  can overlap the other's attention compute (paper §4.2.3).
* :class:`RequestTrace` / :class:`Scheduler` — a structured per-request
  trace (arrival, prefill start/end, transfer seconds, decode iterations and
  seconds) on a deterministic virtual timeline, consumable by benchmarks.

Time model
----------
CPU smoke runs are orders of magnitude off real NPU latencies, so SLO
decisions run on a *virtual* clock: prefill costs ``prefill_token_cost_s``
per **computed** token (EMS-reused prefix tokens are free — context caching
directly buys TTFT), KV handoff is charged by the RDMA-plane
:class:`~repro_torch.serving.transfer.KVTransferEngine`, and each decode iteration
costs ``t_fixed + B·t_per_req`` for the currently active batch ``B``. The
timeline is deterministic given a request stream, which makes SLO behaviour
assertable in tests; on real hardware the same trace schema is stamped from
measured timestamps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.microbatch import microbatched
from repro_torch.launch.roofline import HBM_BW


# ---------------------------------------------------------------------------
# Structured per-request trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RequestTrace:
    """Per-request lifecycle record on the scheduler's virtual timeline."""

    rid: int
    arrival: float = 0.0
    prompt_tokens: int = 0
    slo_class: str = "interactive"   # SLO tier: "interactive" | "batch"
    prefill_instance: int = -1
    prefill_start: float = 0.0
    prefill_end: float = 0.0
    reused_tokens: int = 0
    computed_tokens: int = 0
    cached_tokens: int = 0   # EMS hit-probe at enqueue (hit-aware admission)
    transfer_seconds: float = 0.0
    transfer_chunks: int = 0   # pipelined handoff: chunks shipped (0 = sync)
    overlap_seconds: float = 0.0   # transfer time hidden behind prefill
    decode_admit: float = 0.0
    decode_end: float = 0.0
    decode_iters: int = 0
    decode_tokens: int = 0   # committed decode tokens (MTP: 1+accepted/iter)
    masked_iters: int = 0    # device iterations burned while slot-resident
    #                          but masked (lv[i, j] false): dead slot time
    decode_seconds: float = 0.0
    decode_engine: int = -1  # pool engine currently decoding the request
    migrations: int = 0      # cross-engine KV migrations mid-decode
    migration_seconds: float = 0.0
    recoveries: int = 0      # engine-failure recoveries (replay re-prefill)
    tokens_replayed: int = 0  # already-emitted tokens teacher-forced back
    recovery_seconds: float = 0.0  # failure detection -> KV re-ready
    preemptions: int = 0     # batch-tier evictions under interactive pressure
    preempt_seconds: float = 0.0   # eviction -> replay KV re-ready
    tokens_out: int = 0
    shed: bool = False

    @property
    def ready_at(self) -> float:
        """When the first token + KV could reach the decode pool."""
        return self.prefill_end + self.transfer_seconds

    @property
    def ttft(self) -> float:
        """Time to first token: prefill completion + KV handoff — arrival."""
        return self.ready_at - self.arrival

    @property
    def tpot(self) -> float:
        """Mean time per output *token* over the decode residency.

        Per-token, not per-iteration: an MTP iteration that commits an
        accepted draft token counts twice in the denominator
        (``decode_tokens``, credited per decode iteration by the
        scheduler). Falls back to output tokens minus the prefill-produced
        first token, then to iterations, for traces recorded before the
        per-iteration credit existed.
        """
        denom = self.decode_tokens or (
            self.tokens_out - 1 if self.tokens_out > 1 else self.decode_iters)
        return self.decode_seconds / max(1, denom)

    @property
    def queue_seconds(self) -> float:
        """Time spent waiting between KV-ready and decode admission."""
        return max(0.0, self.decode_admit - self.ready_at)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(ttft=self.ttft, tpot=self.tpot,
                 queue_seconds=self.queue_seconds)
        return d


# ---------------------------------------------------------------------------
# Prefill routing policies
# ---------------------------------------------------------------------------


class PrefillRouter:
    """Chooses a prefill instance for the next request.

    Policies see only instance-level load signals (live in-flight tokens
    plus the scheduler's virtual-backlog token equivalents) — never the
    request content or cache placement (the paper's peer-to-peer,
    locality-free scheduling property). ``select`` must be deterministic
    for a fixed request stream.
    """

    name = "base"

    def __init__(self, n_instances: int):
        if n_instances < 1:
            raise ValueError("need at least one prefill instance")
        self.n = n_instances

    def resize(self, n_instances: int) -> None:
        """The prefill pool spawned instances: ids ``[old_n, n_instances)``
        now exist. Instance ids never disappear (retired instances are
        parked, not removed — the same stable-id rule the decode pool
        enforces), so shrinking is an error."""
        if n_instances < self.n:
            raise ValueError(
                "prefill instance ids never disappear (retired instances "
                f"are parked, not removed): cannot resize {self.n} -> "
                f"{n_instances}")
        self.n = n_instances

    def _candidates(self,
                    candidates: Optional[Sequence[int]]) -> List[int]:
        cands = list(range(self.n)) if candidates is None else list(candidates)
        if not cands:
            raise ValueError("no live prefill instance to route to")
        return cands

    def select(self, loads: Sequence[float],
               candidates: Optional[Sequence[int]] = None) -> int:
        raise NotImplementedError

    def on_complete(self, instance: int) -> None:  # pragma: no cover - hook
        """Notification that a routed request finished its prefill."""


class LeastLoadedRouter(PrefillRouter):
    """Instance with the fewest in-flight prompt tokens (ties → lowest id)."""

    name = "least_loaded"

    def select(self, loads: Sequence[int],
               candidates: Optional[Sequence[int]] = None) -> int:
        return min(self._candidates(candidates), key=lambda i: (loads[i], i))


class RoundRobinRouter(PrefillRouter):
    """Cache-affinity-free cyclic assignment — the purest stateless policy.
    With parked instances the cycle runs over the live ids (first live id
    at or after the cursor)."""

    name = "round_robin"

    def __init__(self, n_instances: int):
        super().__init__(n_instances)
        self._next = 0

    def select(self, loads: Sequence[int],
               candidates: Optional[Sequence[int]] = None) -> int:
        cands = self._candidates(candidates)
        i = next((c for c in cands if c >= self._next), cands[0])
        self._next = (i + 1) % self.n
        return i


class QueueDepthRouter(PrefillRouter):
    """Fewest outstanding *requests* routed-but-not-finished (ties → id).

    Unlike ``least_loaded`` (token-weighted, instantaneous) this balances
    request counts across the routing horizon, which is the better signal
    when prompt lengths are uniform but completion is asynchronous. The
    scheduler reports completion when the request *finishes* (decode end or
    shed), so depth spans the whole PDC residency.
    """

    name = "queue_depth"

    def __init__(self, n_instances: int):
        super().__init__(n_instances)
        self.depth = [0] * n_instances

    def resize(self, n_instances: int) -> None:
        super().resize(n_instances)
        self.depth.extend([0] * (n_instances - len(self.depth)))

    def select(self, loads: Sequence[int],
               candidates: Optional[Sequence[int]] = None) -> int:
        i = min(self._candidates(candidates),
                key=lambda j: (self.depth[j], j))
        self.depth[i] += 1
        return i

    def on_complete(self, instance: int) -> None:
        self.depth[instance] -= 1


ROUTERS = {r.name: r for r in
           (LeastLoadedRouter, RoundRobinRouter, QueueDepthRouter)}


def make_router(policy: str, n_instances: int) -> PrefillRouter:
    try:
        return ROUTERS[policy](n_instances)
    except KeyError:
        raise ValueError(
            f"unknown prefill routing policy {policy!r}; "
            f"available: {sorted(ROUTERS)}") from None


# ---------------------------------------------------------------------------
# Decode slot management
# ---------------------------------------------------------------------------


class SlotError(RuntimeError):
    """Slot bookkeeping invariant violated (double assign / overflow)."""


@dataclasses.dataclass
class SlotInfo:
    rid: int
    cache_len: int
    payload: Any = None   # engine-side per-request state (result, remaining)


class DecodeSlotManager:
    """Owns decode slot allocation/eviction and per-request cache lengths.

    Invariants (enforced, not assumed):
      * a slot is never double-assigned;
      * ``cache_len`` never exceeds the engine's static KV capacity;
      * release of an empty slot is an error.
    """

    def __init__(self, n_slots: int, capacity: int):
        if n_slots < 1 or capacity < 1:
            raise ValueError("n_slots and capacity must be positive")
        self.n_slots = n_slots
        self.capacity = capacity
        self._slots: List[Optional[SlotInfo]] = [None] * n_slots
        # Lifetime conservation counters (pool invariant: acquired ==
        # released + active, per engine and summed across a pool).
        self.acquired = 0
        self.released = 0

    # -- queries -----------------------------------------------------------
    @property
    def active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def free(self) -> int:
        return self.n_slots - self.active

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def get(self, slot: int) -> Optional[SlotInfo]:
        return self._slots[slot]

    def active_slots(self) -> Iterator[Tuple[int, SlotInfo]]:
        for i, s in enumerate(self._slots):
            if s is not None:
                yield i, s

    # -- transitions -------------------------------------------------------
    def allocate(self, rid: int, cache_len: int, payload: Any = None,
                 slot: Optional[int] = None) -> int:
        """Claim a slot (lowest free index unless ``slot`` given)."""
        if slot is None:
            slot = self.free_slot()
            if slot is None:
                raise SlotError("no free decode slot")
        if self._slots[slot] is not None:
            raise SlotError(
                f"slot {slot} already holds rid={self._slots[slot].rid}")
        if cache_len > self.capacity:
            raise SlotError(
                f"rid={rid} needs cache_len={cache_len} > capacity="
                f"{self.capacity}")
        self._slots[slot] = SlotInfo(rid, cache_len, payload)
        self.acquired += 1
        return slot

    def advance(self, slot: int, n: int = 1) -> int:
        info = self._slots[slot]
        if info is None:
            raise SlotError(f"advance on empty slot {slot}")
        if info.cache_len + n > self.capacity:
            raise SlotError(
                f"rid={info.rid} cache_len {info.cache_len}+{n} would exceed "
                f"capacity {self.capacity}")
        info.cache_len += n
        return info.cache_len

    def release(self, slot: int) -> SlotInfo:
        info = self._slots[slot]
        if info is None:
            raise SlotError(f"release of empty slot {slot}")
        self._slots[slot] = None
        self.released += 1
        return info


# ---------------------------------------------------------------------------
# Decode step-time model + admission control
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecodeCostModel:
    """t(B) = t_fixed + B · t_per_req — the Table 5 decomposition.

    ``t_fixed`` ≈ weight-read time (batch-invariant), ``t_per_req`` ≈ per-
    request KV-cache traffic. Defaults are paper-shaped placeholders tuned so
    the interesting SLO regimes (15–50 ms) exercise batch caps of a few to a
    few dozen requests at smoke scale.

    MTP speculative decoding adds an acceptance-rate term: each iteration
    costs ``mtp_iter_factor`` × the plain step (the base+draft verification
    shares one weight stream — paper Fig. 22b measures ~+44%) while
    emitting ``1 + mtp_accept`` tokens (paper α ≈ 0.70 for the trained
    draft head). ``step_time`` charges the per-iteration cost; the
    admission gate projects the *per-token* SLO from both terms.
    """

    #: paper Fig. 22b: ~44% per-iteration latency increase under MTP
    MTP_ITER_FACTOR = 1.44
    #: paper §5.4.2: single-token acceptance of the trained draft head
    MTP_ACCEPT = 0.70

    fixed_s: float = 4e-3
    per_req_s: float = 1e-3
    mtp_iter_factor: float = 1.0   # per-iteration latency multiplier
    mtp_accept: float = 0.0        # expected draft acceptance rate α

    def with_mtp(self, iter_factor: Optional[float] = None,
                 accept: Optional[float] = None) -> "DecodeCostModel":
        """This cost model under MTP speculative decoding (paper defaults,
        or a measured acceptance rate from the bench harness)."""
        return dataclasses.replace(
            self,
            mtp_iter_factor=self.MTP_ITER_FACTOR if iter_factor is None
            else iter_factor,
            mtp_accept=self.MTP_ACCEPT if accept is None else accept)

    @property
    def tokens_per_iter(self) -> float:
        return 1.0 + self.mtp_accept

    @classmethod
    def from_roofline(cls, step_s: float, batch_per_chip: float,
                      kv_read_s: float) -> "DecodeCostModel":
        """Calibrate t(B) = fixed + B·per_req from one roofline point.

        The per-request term is the per-request KV-cache read time (the only
        strictly batch-proportional HBM traffic at decode) and the fixed term
        absorbs the remainder (weight reads + collectives), floored at 20% of
        the recorded step so a KV-dominated record cannot degenerate to
        fixed≈0."""
        per = max(kv_read_s, 1e-9)
        fixed = max(step_s - batch_per_chip * per, 0.2 * step_s)
        return cls(fixed_s=fixed, per_req_s=per)

    def step_time(self, batch: int) -> float:
        """Cost of one decode *iteration* for the active batch."""
        return (self.fixed_s + batch * self.per_req_s) * self.mtp_iter_factor

    def token_time(self, batch: int) -> float:
        """Projected time per committed *token* (TPOT): iteration cost over
        the 1+α tokens an iteration is expected to emit."""
        return self.step_time(batch) / self.tokens_per_iter

    def max_batch_for(self, tpot_budget_s: float) -> int:
        """Largest batch whose projected per-token TPOT meets the budget
        (0 = none). Under MTP the budget buys more batch: the iteration is
        ``mtp_iter_factor`` slower but credits ``1+mtp_accept`` tokens.

        The float quotient is nudged before truncation so budgets that land
        exactly on a step time (t(B) == budget) admit batch B instead of
        B-1."""
        eff = tpot_budget_s * self.tokens_per_iter / self.mtp_iter_factor
        b = int((eff - self.fixed_s) / self.per_req_s + 1e-9)
        return max(0, b)


def decode_cost_from_roofline(record: Optional[Dict[str, Any]],
                              kv_bytes_per_req: float,
                              batch_per_chip: float,
                              hbm_bw: float = HBM_BW) -> DecodeCostModel:
    """DecodeCostModel calibrated from a dry-run roofline record (the
    port's ``python -m repro_torch.launch.dryrun`` writes them to
    ``experiments/dryrun_torch/*.json``) instead of placeholder defaults.

    ``record`` carries ``compute_s`` / ``memory_s`` / ``collective_s`` as
    written by ``launch/dryrun.py``; the serial roofline step time is
    ``max(compute, memory) + collective`` (same formula as
    ``benchmarks.common.step_time_from_record``). Falls back to the
    placeholder defaults when no record exists or the arch has no
    per-request KV traffic to decompose by."""
    if not record or kv_bytes_per_req <= 0 or batch_per_chip <= 0:
        return DecodeCostModel()
    step_s = max(record["compute_s"], record["memory_s"]) \
        + record["collective_s"]
    return DecodeCostModel.from_roofline(step_s, batch_per_chip,
                                         kv_bytes_per_req / hbm_bw)


class AdmissionGate:
    """Sheds or queues prefill→decode admissions that would break the SLO.

    With budget ``None`` the gate is wide open (slot-limited only). With a
    budget, admission keeps the active decode batch at or below the largest
    B with ``t(B) <= budget``; projected TPOT therefore never exceeds the
    budget for any admitted request.

    The gate is class-indexed: ``class_budgets``/``class_modes`` map an SLO
    class (e.g. ``"batch"``) to its own TPOT budget and queue/shed mode;
    classes without an entry fall back to the base budget/mode, so the
    default two-argument construction is exactly the pre-class gate. Batch
    step time is a property of the *whole* batch, not of the joining
    request, so the effective cap for an admission is the strictest cap
    over the joining class AND every class already resident on the target
    engine — a relaxed-budget batch request may not inflate the batch past
    what a co-resident interactive request's budget allows.

    With ``hit_aware=True`` (EMS hit-aware admission) the gate weighs each
    request by its *suffix* charge — the fraction of its prompt the EMS
    probe could not serve from cache — instead of a flat 1.0: the caller
    passes the summed resident ``load`` and the joining request's
    ``charge``, and admissibility becomes ``load + charge <= cap``. A
    mostly-cached request is nearly free, so it can join a batch the
    suffix-blind count-based gate would have held at the cap. With every
    charge at the default 1.0 the rule is exactly ``active < cap`` — the
    hit-aware gate degrades bit-identically to the blind one on cold
    traffic.
    """

    def __init__(self, cost: DecodeCostModel,
                 tpot_budget_s: Optional[float] = None,
                 mode: str = "queue", *,
                 class_budgets: Optional[Dict[str, Optional[float]]] = None,
                 class_modes: Optional[Dict[str, str]] = None,
                 hit_aware: bool = False):
        if mode not in ("queue", "shed"):
            raise ValueError(f"admission mode must be queue|shed, got {mode!r}")
        self.cost = cost
        self.budget_s = tpot_budget_s
        self.mode = mode
        self.hit_aware = hit_aware
        self.class_budgets = dict(class_budgets or {})
        self.class_modes = dict(class_modes or {})
        for cls, m in self.class_modes.items():
            if m not in ("queue", "shed"):
                raise ValueError(
                    f"admission mode for class {cls!r} must be queue|shed, "
                    f"got {m!r}")
        self.max_batch: Optional[int] = None
        if tpot_budget_s is not None:
            self.max_batch = cost.max_batch_for(tpot_budget_s)
            if self.max_batch == 0 and mode == "queue":
                raise ValueError(
                    f"TPOT budget {tpot_budget_s*1e3:.1f} ms is below the "
                    f"fixed decode cost {cost.fixed_s*1e3:.1f} ms — no batch "
                    "size can meet it (use mode='shed' to reject instead)")
        self.class_caps: Dict[str, Optional[int]] = {}
        for cls, budget in self.class_budgets.items():
            cap = None if budget is None else cost.max_batch_for(budget)
            if cap == 0 and self.mode_for(cls) == "queue":
                raise ValueError(
                    f"TPOT budget {budget*1e3:.1f} ms for class {cls!r} is "
                    f"below the fixed decode cost {cost.fixed_s*1e3:.1f} ms "
                    "— no batch size can meet it (use mode='shed' to reject "
                    "instead)")
            self.class_caps[cls] = cap

    def cap_for(self, slo_class: str = "interactive") -> Optional[int]:
        """Largest admissible batch for one class (None = slot-limited)."""
        if slo_class in self.class_caps:
            return self.class_caps[slo_class]
        return self.max_batch

    def mode_for(self, slo_class: str = "interactive") -> str:
        return self.class_modes.get(slo_class, self.mode)

    def admissible(self, active: int, slo_class: str = "interactive",
                   resident_classes: Sequence[str] = (), *,
                   load: Optional[float] = None,
                   charge: float = 1.0) -> bool:
        """May one more request join a batch currently ``active`` deep?

        Hit-aware gates compare ``load + charge`` (suffix-weighted
        occupancy) against the cap; ``load`` defaults to ``active`` so a
        caller that passes no EMS charges gets the blind rule exactly
        (``active + 1.0 <= cap`` ⇔ ``active < cap`` for integer caps)."""
        caps = [self.cap_for(c) for c in {slo_class, *resident_classes}]
        caps = [c for c in caps if c is not None]
        if not caps:
            return True
        cap = min(caps)
        if self.hit_aware:
            base = float(active) if load is None else load
            return base + charge <= cap + 1e-9
        return active < cap

    def decide(self, active: int, has_free_slot: bool,
               slo_class: str = "interactive",
               resident_classes: Sequence[str] = (),
               mode_override: Optional[str] = None, *,
               load: Optional[float] = None,
               charge: float = 1.0) -> str:
        """'admit' | 'wait' | 'shed' for the head-of-queue request.

        ``mode_override`` forces the queue/shed decision regardless of the
        class's configured mode (the brownout ladder sheds whole classes
        this way) — it does not widen admissibility, only what happens to
        an inadmissible request.
        """
        mode = mode_override if mode_override is not None \
            else self.mode_for(slo_class)
        if mode == "shed" and mode_override is not None:
            # Brownout-level shed rejects the class outright: a browned-out
            # class must not trickle in through free slots.
            return "shed"
        if not has_free_slot:
            return "wait"
        if self.admissible(active, slo_class, resident_classes,
                           load=load, charge=charge):
            return "admit"
        return "shed" if mode == "shed" else "wait"


# ---------------------------------------------------------------------------
# SLO tracking
# ---------------------------------------------------------------------------


class SLOTracker:
    """Aggregates finished (and shed) request traces into SLO statistics."""

    def __init__(self) -> None:
        self.finished: List[RequestTrace] = []
        self.shed: List[RequestTrace] = []

    def record(self, trace: RequestTrace) -> None:
        (self.shed if trace.shed else self.finished).append(trace)

    @staticmethod
    def _pct(values: List[float], q: float) -> float:
        if not values:
            return float("nan")
        return float(np.percentile(np.asarray(values), q))

    def _stats(self, finished: List[RequestTrace],
               shed: List[RequestTrace]) -> Dict[str, float]:
        ttfts = [t.ttft for t in finished]
        tpots = [t.tpot for t in finished if t.decode_iters > 0]
        # Queue statistics span finished AND shed traces: a request that
        # queued long and was then shed is exactly the queueing pressure
        # the percentile must not hide (shed traces stamp their queue time
        # at the shed instant).
        queues = [t.queue_seconds for t in finished + shed]
        return {
            "completed": len(finished),
            "shed": len(shed),
            "ttft_p50_s": self._pct(ttfts, 50),
            "ttft_p99_s": self._pct(ttfts, 99),
            "tpot_p50_s": self._pct(tpots, 50),
            "tpot_p99_s": self._pct(tpots, 99),
            "tpot_max_s": max(tpots) if tpots else float("nan"),
            "queue_p99_s": self._pct(queues, 99),
            "queue_p99_shed_s": self._pct([t.queue_seconds
                                           for t in shed], 99),
        }

    def summary(self) -> Dict[str, float]:
        s = self._stats(self.finished, self.shed)
        # Per-class breakdown only when the wave actually carried more than
        # the default class: single-class summaries stay flat (and older
        # consumers that iterate the summary see no nested dict).
        classes = sorted({t.slo_class for t in self.finished + self.shed})
        if classes and classes != ["interactive"]:
            s["classes"] = {
                cls: self._stats(
                    [t for t in self.finished if t.slo_class == cls],
                    [t for t in self.shed if t.slo_class == cls])
                for cls in classes}
        return s


# ---------------------------------------------------------------------------
# Microbatch interleaving (decode two-stream pipeline, paper §4.2.3)
# ---------------------------------------------------------------------------


class MicrobatchInterleaver:
    """Pairs decode microbatches through :func:`core.microbatch.microbatched`.

    Wraps a ``(tokens(B,1), caches, cache_len(B,)) -> (logits, caches)`` step
    into ``n_micro`` data-independent half-batch computations inside one
    jitted step, so XLA's latency-hiding scheduler may overlap µb0's MoE
    dispatch/combine collectives with µb1's attention compute. ``cache_len``
    rides in the token bundle so it is split along batch like the rest.
    """

    def __init__(self, n_micro: int = 2):
        if n_micro < 1:
            raise ValueError("n_micro must be >= 1")
        self.n_micro = n_micro

    def applicable(self, batch: int) -> bool:
        return self.n_micro > 1 and batch % self.n_micro == 0

    def wrap(self, step_fn: Callable, batch: int) -> Callable:
        if not self.applicable(batch):
            return step_fn

        def core(bundle, caches):
            return step_fn(bundle["tok"], caches, bundle["len"])

        mb = microbatched(core, self.n_micro)

        def wrapped(tokens, caches, cache_len):
            return mb({"tok": tokens, "len": cache_len}, caches)

        return wrapped


# ---------------------------------------------------------------------------
# Brownout ladder (deterministic overload degradation)
# ---------------------------------------------------------------------------


class BrownoutLadder:
    """Deterministic overload ladder the scheduler climbs under sustained
    interactive pressure, one rung per ``patience`` consecutive pressured
    turns, and descends one rung per ``cooldown`` consecutive calm turns:

      level 0  healthy — class budgets/modes as configured
      level 1  shed new batch-tier admissions
      level 2  ... and preempt batch-tier decode slots for interactive
      level 3  ... and queue-age-shed queued batch older than the brownout
               threshold
      level 4  ... and shed interactive admissions too (last resort)

    Pure hysteresis state machine on the virtual clock — no randomness, so
    identical pressure sequences produce identical ladders.
    """

    MAX_LEVEL = 4

    def __init__(self, patience: int = 2, cooldown: int = 2):
        if patience < 1 or cooldown < 1:
            raise ValueError("brownout patience/cooldown must be >= 1")
        self.patience = patience
        self.cooldown = cooldown
        self.level = 0
        self._pressured_turns = 0
        self._calm_turns = 0

    def observe(self, pressured: bool) -> Optional[Dict[str, int]]:
        """Feed one turn's pressure signal; returns a transition event
        ``{"from": .., "to": ..}`` when the level changes, else None."""
        if pressured:
            self._pressured_turns += 1
            self._calm_turns = 0
            if (self._pressured_turns >= self.patience
                    and self.level < self.MAX_LEVEL):
                self._pressured_turns = 0
                self.level += 1
                return {"from": self.level - 1, "to": self.level}
        else:
            self._calm_turns += 1
            self._pressured_turns = 0
            if self._calm_turns >= self.cooldown and self.level > 0:
                self._calm_turns = 0
                self.level -= 1
                return {"from": self.level + 1, "to": self.level}
        return None


# ---------------------------------------------------------------------------
# Scheduler: composition + virtual timeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SchedulerConfig:
    policy: str = "least_loaded"
    tpot_budget_ms: Optional[float] = None
    admission: str = "queue"                 # "queue" | "shed"
    prefill_token_cost_s: float = 2e-4
    # Pipelined chunked KV streaming (peer-to-peer PDC handoff): each
    # prefill chunk's KV blocks ship over the RDMA plane while the next
    # chunk computes, so TTFT charges max(prefill, transfer) + the last
    # chunk's wire time instead of prefill + transfer. Token-identical to
    # the synchronous handoff (the decode-side cache is rebuilt from the
    # streamed chunks); archs whose caches are not token-sliceable (SSM /
    # hybrid) fall back to the synchronous path. stream_chunk is the chunk
    # width in tokens (None = 8).
    stream_handoff: bool = False
    stream_chunk: Optional[int] = None
    decode_cost: DecodeCostModel = dataclasses.field(
        default_factory=DecodeCostModel)
    interleave_microbatches: bool = False
    n_micro: int = 2
    # Decode iterations per host sync (model.decode_loop scan length).
    # 1 = per-step decode; >1 trades admission/trace granularity (requests
    # join and the clock is reconciled only at chunk boundaries) for host
    # round-trips amortized over `decode_chunk` tokens.
    decode_chunk: int = 1
    # Continuous batching on the chunked fast path: before each device
    # dispatch the engine shrinks the effective scan width (to a pre-jitted
    # width <= decode_chunk) when min(remaining) across active slots is
    # below the chunk or a gate-held admission could land in a free slot,
    # and the serve loop refills freed slots immediately after each
    # engine's chunk drains (mid-scan refill) instead of once per wave
    # boundary. Token-identical to the wave-shaped loop; admissions land
    # strictly earlier. Control-plane only (no re-jit), so it may be
    # flipped between waves via reconfigure_scheduler.
    continuous_batching: bool = False
    # MTP speculative decoding: charge the virtual clock the paper's ~1.44x
    # per-iteration verification cost while the admission gate credits
    # 1+accept tokens per iteration (a decode_cost with explicit MTP terms
    # overrides the paper defaults).
    use_mtp: bool = False
    # Decode-pool routing policy (serving/pool.py registry). Unlike the
    # prefill policy this MAY be cache-affine: the UB plane makes any
    # engine reachable from the shared KV store, so routing to the engine
    # already holding a request's reusable prefix blocks is pure win.
    decode_policy: str = "least_loaded_slots"
    # When > 0, every N pool decode turns the hottest engine drains one
    # slot's KV to the coldest (cross-engine migration over the RDMA
    # plane) if the active-slot imbalance is >= 2. 0 disables rebalancing.
    decode_rebalance_every: int = 0
    # Decode-pool autoscaling (serving/pool.py PoolAutoscaler): between
    # decode turns a deterministic controller grows the pool (engine spawn)
    # when demand exceeds what the live engines can carry at the SLO batch
    # cap, and shrinks it (migration-backed retirement) when N-1 engines
    # could absorb the load. min/max clamp the live engine count; the
    # patience/cooldown knobs are the hysteresis (turns a condition must
    # hold / turns to sit out after any scale event).
    autoscale: bool = False
    min_engines: int = 1
    max_engines: int = 4
    autoscale_grow_patience: int = 1
    autoscale_shrink_patience: int = 3
    autoscale_cooldown: int = 2
    # Joint P/D autoscaling (serving/pool.py JointAutoscaler): a capacity-
    # conserving controller that SHIFTS engines between the prefill and
    # decode roles under one SLO budget — TTFT pressure (virtual prefill
    # backlog past ttft_budget_ms) moves a drained decode engine into the
    # prefill pool, TPOT pressure (decode demand past the per-engine SLO
    # batch cap) moves an idle prefill instance into the decode pool.
    # min/max_prefill clamp the prefill roster the same way min/max_engines
    # clamp decode; patience/cooldown are per-direction hysteresis.
    joint_autoscale: bool = False
    min_prefill: int = 1
    max_prefill: int = 4
    ttft_budget_ms: Optional[float] = None
    joint_patience: int = 1
    joint_cooldown: int = 2
    # Graceful degradation under capacity loss: when set, a queued (not
    # yet admitted) request whose wait since KV-ready exceeds this many
    # virtual seconds is shed even in queue mode — after an engine failure
    # the shrunken pool sheds its backlog instead of growing an unbounded
    # queue. None keeps queue mode unconditional (the pre-fault behavior).
    # Class-ordered: at equal queue age, batch-tier backlog sheds before
    # any interactive request does.
    degrade_shed_queue_s: Optional[float] = None
    # --- SLO classes (overload control) -----------------------------------
    # Batch-tier overrides for the admission gate. tpot_budget_ms/admission
    # above are the base (interactive) budget/mode; None here means the
    # batch tier shares them (the pre-class behavior). A relaxed batch
    # budget lets batch fill deep batches on its own, but the gate still
    # caps any batch that an interactive request is resident in at the
    # interactive cap (see AdmissionGate).
    batch_tpot_budget_ms: Optional[float] = None
    batch_admission: Optional[str] = None    # "queue" | "shed" | None=base
    # Preempt batch-tier decode slots when a gate-ready interactive request
    # would otherwise wait: the youngest batch slot is evicted (KV parked
    # as prompt + emitted tokens), replay re-prefilled, and re-admitted
    # later — token-identical to the unpreempted run, latency charged to
    # the victim's trace (preempt_seconds).
    preempt_batch: bool = False
    # Brownout ladder: under sustained overload the scheduler climbs a
    # deterministic degradation ladder (shed batch admissions → preempt
    # batch → queue-age-shed batch → shed interactive); transitions are
    # recorded as trace events. Patience/cooldown are the hysteresis in
    # decode turns; brownout_queue_age_s is the level-3 batch queue-age
    # shed threshold.
    brownout: bool = False
    brownout_patience: int = 2
    brownout_cooldown: int = 2
    brownout_queue_age_s: float = 0.05
    # EMS hit-aware admission: charge the gate only the *suffix* cost of a
    # request — (prompt − cached) / prompt, from the EMS match_prefix probe
    # stamped on the trace at enqueue (cached_tokens) — and weigh resident
    # requests the same way. A mostly-cached request is nearly free, so it
    # can join a batch a suffix-blind gate would hold at the cap. Composes
    # with SLO classes (strictest cap still wins) and brownout (overrides
    # still short-circuit). Off = bit-identical to the blind gate.
    hit_aware_admission: bool = False


class Scheduler:
    """Control plane for the PDC serving loop.

    Owns the router, admission gate, SLO tracker, and the virtual timeline;
    the :class:`~repro_torch.serving.engine.ServingSystem` calls the ``on_*`` hooks
    as requests move through prefill → transfer → decode and reads decisions
    back. Compute stays in the engines; every *decision* lives here.
    """

    def __init__(self, n_prefill: int, slot_mgr, config: Optional[SchedulerConfig] = None):
        """``slot_mgr`` is one :class:`DecodeSlotManager` (single decode
        engine) or a sequence of them (one per decode-pool engine); every
        engine gets its own virtual clock and admission view, reconciled
        into a single tracker/trace."""
        self.config = config or SchedulerConfig()
        self.n_prefill = n_prefill
        if isinstance(slot_mgr, DecodeSlotManager):
            self.slot_mgrs = [slot_mgr]
        else:
            self.slot_mgrs = list(slot_mgr)
            if not self.slot_mgrs:
                raise ValueError("need at least one decode slot manager")
        self.slot_mgr = self.slot_mgrs[0]      # single-engine compatibility
        self.n_decode = len(self.slot_mgrs)
        # Liveness mask over decode engines (autoscaling parks retired
        # engines in place). Persists across epochs — engine lifecycle is
        # pool state, not per-wave state. Prefill instances get the same
        # treatment (the joint autoscaler parks/revives them mid-wave).
        self._live = [True] * self.n_decode
        self._prefill_live = [True] * n_prefill
        cost = self.config.decode_cost
        if (self.config.use_mtp and cost.mtp_iter_factor == 1.0
                and cost.mtp_accept == 0.0):
            cost = cost.with_mtp()      # paper defaults unless calibrated
        self.cost = cost
        budget_s = (None if self.config.tpot_budget_ms is None
                    else self.config.tpot_budget_ms * 1e-3)
        self.gate = AdmissionGate(self.cost, budget_s, self.config.admission,
                                  class_budgets=self._class_budgets(),
                                  class_modes=self._class_modes(),
                                  hit_aware=self.config.hit_aware_admission)
        self.begin_epoch()

    def _class_budgets(self) -> Optional[Dict[str, Optional[float]]]:
        if self.config.batch_tpot_budget_ms is None:
            return None
        return {"batch": self.config.batch_tpot_budget_ms * 1e-3}

    def _class_modes(self) -> Optional[Dict[str, str]]:
        if self.config.batch_admission is None:
            return None
        return {"batch": self.config.batch_admission}

    def begin_epoch(self) -> None:
        """Start a fresh scheduling epoch (one ``serve()`` call).

        Router state, traces, SLO statistics, and the virtual timeline are
        all per-epoch, so a ServingSystem can serve successive request waves
        (rids may repeat across waves); ``summary()``/``trace_records()``
        reflect the most recent wave.
        """
        self.router = make_router(self.config.policy, self.n_prefill)
        self.tracker = SLOTracker()
        self.traces: Dict[int, RequestTrace] = {}
        self._instance_free_at = [0.0] * self.n_prefill
        # Token-weighted in-flight prefill load, committed at routing time
        # and released on EVERY completion path (decode finish, prefill-only
        # finish, gate shed, fault loss → recovery → finish/shed). Keyed by
        # rid so a release is idempotent — the pre-fix accounting leaked
        # the load of shed/faulted requests and skewed least_loaded routing
        # toward instances that never served them.
        self._prefill_inflight = [0.0] * self.n_prefill
        self._routed_load: Dict[int, Tuple[int, int]] = {}
        # One virtual clock per decode engine (engines step concurrently in
        # reality; each clock advances by its own batch's step cost).
        self._decode_now = [0.0] * self.n_decode
        self.decode_busy = 0.0      # sum of step costs (excludes idle gaps)
        self.decode_steps = 0
        self.decode_token_count = 0
        self._eng_busy = [0.0] * self.n_decode
        self._eng_steps = [0] * self.n_decode
        self._eng_tokens = [0] * self.n_decode
        # Dead-slot observability: slot-iterations that did work vs slot-
        # iterations burned masked (resident at dispatch, lv false), plus
        # the number of admissions that landed mid-scan (continuous
        # batching refills between engine chunks within one decode turn).
        self.live_slot_iters = 0
        self.masked_slot_iters = 0
        self._eng_masked = [0] * self.n_decode
        self.mid_scan_refills = 0
        self.migrations = 0
        self.migration_seconds = 0.0
        # Autoscale bookkeeping: scale events + the live-engine-count
        # timeline, both on the virtual clock (per-epoch like the trace).
        self.scale_events: List[Dict[str, Any]] = []
        self.engine_count_timeline: List[Tuple[float, int]] = [
            (0.0, sum(self._live))]
        self.prefill_count_timeline: List[Tuple[float, int]] = [
            (0.0, sum(self._prefill_live))]
        # Pipelined-handoff observability (per-epoch): chunks streamed,
        # transfer seconds hidden behind prefill, bytes on the wire, and
        # the largest single chunk in flight.
        self.stream_requests = 0
        self.stream_chunks = 0
        self.stream_overlap_s = 0.0
        self.stream_bytes = 0
        self.stream_max_chunk_bytes = 0
        # Fault-tolerance bookkeeping (per-epoch like everything above).
        # _slowdown persists per-engine straggler factors only within the
        # epoch; the injector re-asserts them every turn anyway.
        self._slowdown = [1.0] * self.n_decode
        self.engine_failures = 0
        self.recoveries = 0
        self.tokens_replayed = 0
        self.recovery_ttfts: List[float] = []
        # SLO-class overload control (per-epoch like the trace): preemption
        # totals plus the brownout ladder and its transition event log.
        self.preemptions = 0
        self.preempt_tokens_replayed = 0
        self.preempt_latencies: List[float] = []
        self._ladder = (BrownoutLadder(self.config.brownout_patience,
                                       self.config.brownout_cooldown)
                        if self.config.brownout else None)
        self.brownout_events: List[Dict[str, Any]] = []
        # RDMA-plane retry counters, synced from the KVTransferEngine by
        # the ServingSystem (the transfer engine's counters are lifetime,
        # the summary's are per-epoch deltas).
        self.transfer_retries = 0
        self.transfer_timeouts = 0
        self.transfer_corruptions = 0

    @property
    def decode_now(self) -> float:
        """Pool frontier: the earliest virtual time any *live* decode
        engine can take new work (single-engine: the engine clock). Parked
        engines' stale clocks must not drag the frontier backwards."""
        clocks = [c for c, live in zip(self._decode_now, self._live) if live]
        return min(clocks) if clocks else min(self._decode_now)

    # -- prefill side ------------------------------------------------------
    def on_arrival(self, rid: int, arrival: float, prompt_tokens: int,
                   slo_class: str = "interactive") -> RequestTrace:
        if rid in self.traces:
            raise ValueError(f"duplicate rid {rid}")
        tr = RequestTrace(rid=rid, arrival=arrival,
                          prompt_tokens=prompt_tokens, slo_class=slo_class)
        self.traces[rid] = tr
        return tr

    def route_prefill(self, trace: RequestTrace, loads: Sequence[int],
                      candidates: Optional[Sequence[int]] = None) -> int:
        """Pick a prefill instance for ``trace``.

        Live engine loads are augmented with each instance's *virtual*
        backlog (queued prefill seconds not yet elapsed at the request's
        arrival, in prompt-token equivalents) plus the scheduler-held
        token-weighted in-flight load (requests routed but not yet finished
        or shed) — in the sequential CPU model live loads are always zero
        by the time the decision is made, so the virtual signals are what
        actually spread load across instances. ``candidates`` restricts
        routing to the live roster (parked/failed instances excluded);
        omitted means every live instance.
        """
        cost = self.config.prefill_token_cost_s
        backlog = [max(0.0, free - trace.arrival) / cost
                   for free in self._instance_free_at]
        effective = [loads[i] + backlog[i] + self._prefill_inflight[i]
                     for i in range(len(loads))]
        if candidates is None:
            candidates = self.live_prefill_ids
        i = self.router.select(effective, candidates=candidates)
        # Commit the token-weighted load; released via _release_prefill on
        # every terminal path (finish / shed / prefill-only).
        self._prefill_inflight[i] += trace.prompt_tokens
        self._routed_load[trace.rid] = (i, trace.prompt_tokens)
        return i

    def _release_prefill(self, rid: int) -> None:
        """Release a routed request's token-weighted in-flight load.
        Idempotent (keyed by rid), so a request that is shed after a fault
        recovery cannot double-decrement."""
        entry = self._routed_load.pop(rid, None)
        if entry is not None:
            instance, tokens = entry
            self._prefill_inflight[instance] -= tokens

    @property
    def prefill_inflight_tokens(self) -> List[float]:
        """Per-instance token-weighted in-flight routed load (the
        least_loaded signal; must return to all-zero when a wave drains)."""
        return list(self._prefill_inflight)

    @property
    def live_prefill_ids(self) -> List[int]:
        return [i for i, live in enumerate(self._prefill_live) if live]

    def on_prefill_done(self, trace: RequestTrace, instance: int,
                        computed_tokens: int, reused_tokens: int) -> None:
        start = max(trace.arrival, self._instance_free_at[instance])
        dur = computed_tokens * self.config.prefill_token_cost_s
        trace.prefill_instance = instance
        trace.prefill_start = start
        trace.prefill_end = start + dur
        trace.computed_tokens = computed_tokens
        trace.reused_tokens = reused_tokens
        self._instance_free_at[instance] = trace.prefill_end

    def on_transfer(self, trace: RequestTrace, seconds: float) -> None:
        trace.transfer_seconds = seconds

    def on_stream_transfer(self, trace: RequestTrace, seconds: float,
                           chunks: int, overlap_s: float, nbytes: int,
                           max_chunk_bytes: int) -> None:
        """Pipelined chunked handoff: ``seconds`` is the tail of the
        transfer pipeline past prefill completion (the only part TTFT
        still pays — ``ready_at`` stays ``prefill_end + transfer_seconds``)
        and ``overlap_s`` the wire time hidden behind prefill compute."""
        trace.transfer_seconds = seconds
        trace.transfer_chunks = chunks
        trace.overlap_seconds = overlap_s
        self.stream_requests += 1
        self.stream_chunks += chunks
        self.stream_overlap_s += overlap_s
        self.stream_bytes += nbytes
        self.stream_max_chunk_bytes = max(self.stream_max_chunk_bytes,
                                          max_chunk_bytes)

    # -- decode side -------------------------------------------------------
    def admission_decision(self, trace: RequestTrace, engine: int = 0,
                           recovered: bool = False) -> str:
        """Gate decision against one engine's batch: projected TPOT depends
        on the batch the request would *join*, which under a pool is the
        target engine's, not the pool-wide count. The decision is class-
        indexed: the strictest cap over the joining class and the classes
        already resident on the engine applies, and the brownout ladder may
        override the class's queue/shed mode. Recovered/preempted
        re-admissions bypass the brownout override (never its caps): they
        already streamed tokens, so shedding them would break replay token
        identity — and a browned-out ladder must not deadlock on them."""
        mgr = self.slot_mgrs[engine]
        resident = {self.traces[info.rid].slo_class
                    for _, info in mgr.active_slots()
                    if info.rid in self.traces}
        override = None if recovered \
            else self.brownout_mode_override(trace.slo_class)
        load = charge = None
        if self.config.hit_aware_admission:
            charge = self.suffix_charge(trace)
            load = sum(self.suffix_charge(self.traces[info.rid])
                       for _, info in mgr.active_slots()
                       if info.rid in self.traces)
        return self.gate.decide(mgr.active, mgr.free > 0, trace.slo_class,
                                resident_classes=resident,
                                mode_override=override,
                                load=load,
                                charge=1.0 if charge is None else charge)

    def suffix_charge(self, trace: RequestTrace) -> float:
        """Hit-aware admission weight: the fraction of the prompt the EMS
        could not serve — ``(prompt − cached) / prompt`` — floored at one
        token's worth (even a fully-cached request recomputes its last
        token and occupies a decode slot). Uses the measured reuse once
        prefill ran, else the enqueue-time probe."""
        pt = max(1, trace.prompt_tokens)
        cached = min(max(trace.reused_tokens, trace.cached_tokens), pt - 1)
        return max(1.0 - cached / pt, 1.0 / pt)

    # -- SLO-class overload control ----------------------------------------
    @property
    def brownout_level(self) -> int:
        """Current brownout ladder rung (0 when brownout is off)."""
        return self._ladder.level if self._ladder is not None else 0

    def brownout_mode_override(self, slo_class: str) -> Optional[str]:
        """Forced admission mode for a class at the current brownout level
        (level >= 1 sheds batch admissions, level >= 4 sheds interactive
        too), or None when the configured mode applies."""
        lvl = self.brownout_level
        if lvl >= 1 and slo_class == "batch":
            return "shed"
        if lvl >= 4 and slo_class == "interactive":
            return "shed"
        return None

    @property
    def preemption_enabled(self) -> bool:
        """Batch-tier preemption is on when configured explicitly or when
        the brownout ladder has climbed to its preemption rung."""
        return self.config.preempt_batch or self.brownout_level >= 2

    def note_overload(self, pressured: bool) -> None:
        """Feed the brownout ladder one decode turn's pressure signal
        (``pressured`` = a gate-ready interactive request is still blocked
        after admission ran). Transitions are stamped on the virtual clock
        and recorded as trace events."""
        if self._ladder is None:
            return
        ev = self._ladder.observe(pressured)
        if ev is not None:
            self.brownout_events.append(
                {"t": self.decode_now, "from": ev["from"], "to": ev["to"]})

    def on_preempt(self, trace: RequestTrace, at: float,
                   tokens_replayed: int, ready_at: float) -> None:
        """A batch-tier request was evicted mid-decode for interactive
        pressure and rebuilt by replay re-prefill; it re-enters the
        admission queue at ``ready_at``. The latency is charged to the
        trace (``preempt_seconds``), separate from decode/recovery time —
        TPOT keeps meaning pure decode residency."""
        dt = ready_at - at
        trace.preemptions += 1
        trace.preempt_seconds += dt
        self.preemptions += 1
        self.preempt_tokens_replayed += tokens_replayed
        self.preempt_latencies.append(dt)

    def on_admit(self, trace: RequestTrace, slot: int, engine: int = 0) -> None:
        trace.decode_admit = max(self._decode_now[engine], trace.ready_at)
        trace.decode_engine = engine
        # Decode idles until the admitted KV arrives; without this bump a
        # long prefill could yield decode_end < decode_admit in the trace.
        self._decode_now[engine] = max(self._decode_now[engine],
                                       trace.decode_admit)

    def on_prefill_only_finish(self, trace: RequestTrace) -> None:
        """Request fully answered by prefill (max_new <= 1): its single
        token is the prefill output, so it never occupies a decode slot."""
        trace.decode_admit = trace.decode_end = trace.ready_at
        self.tracker.record(trace)
        self.router.on_complete(trace.prefill_instance)
        self._release_prefill(trace.rid)

    def on_shed(self, trace: RequestTrace) -> None:
        trace.shed = True
        # Stamp the shed instant so queue statistics see the time this
        # request spent waiting before the gate gave up on it (a gate shed
        # happens at the pool frontier; an up-front capacity reject never
        # prefilled, so its queue time is legitimately zero).
        if trace.prefill_instance >= 0:
            t = max(trace.ready_at, self.decode_now)
        else:
            t = trace.ready_at
        trace.decode_admit = trace.decode_end = t
        self.tracker.record(trace)
        if trace.prefill_instance >= 0:     # capacity rejects never prefill
            self.router.on_complete(trace.prefill_instance)
        # A shed request's routed load must come off its instance too —
        # leaking it here left the engine looking permanently busy and
        # skewed every later least_loaded decision (idempotent: an
        # up-front capacity reject was never routed, so there is nothing
        # to release).
        self._release_prefill(trace.rid)

    def on_decode_step(self, active_rids: Sequence[int],
                       finished_rids: Sequence[int],
                       tokens_by_rid: Optional[Dict[int, int]] = None,
                       masked_rids: Sequence[int] = (),
                       engine: int = 0) -> float:
        """Advance one engine's virtual clock by one decode iteration.

        The clock is charged per *iteration* (MTP: ×``mtp_iter_factor``)
        for the **live** batch — ``active_rids`` are the slots whose
        ``lv[i, j]`` was true — while each request is credited the tokens
        it actually committed — ``tokens_by_rid`` from the engine (MTP:
        1+accepted; omitted: 1 per active request) — so TPOT traces
        honestly reflect speculation. ``masked_rids`` are slots that were
        resident at dispatch but masked this iteration (left-exhausted or
        capacity-frozen): they burned a device iteration without doing
        work, so they count toward ``dead_slot_rate`` but are *not*
        charged batch occupancy on the clock or the trace. An iteration
        whose live set is empty (pure dead tail of a chunk) advances
        nothing but the dead-slot counters.
        """
        if active_rids:
            # Straggler factor 1.0 is the healthy default; multiplying by
            # it is exact in IEEE float, so fault-free timelines are
            # bit-identical to the pre-fault scheduler.
            dt = self.cost.step_time(len(active_rids)) \
                * self._slowdown[engine]
            self._decode_now[engine] += dt
            self.decode_busy += dt
            self.decode_steps += 1
            self._eng_busy[engine] += dt
            self._eng_steps[engine] += 1
        else:
            dt = 0.0
        self.live_slot_iters += len(active_rids)
        self.masked_slot_iters += len(masked_rids)
        self._eng_masked[engine] += len(masked_rids)
        for rid in masked_rids:
            tr = self.traces.get(rid)
            if tr is not None:
                tr.masked_iters += 1
        for rid in active_rids:
            tr = self.traces[rid]
            tr.decode_iters += 1
            tr.decode_seconds += dt
            toks = 1 if tokens_by_rid is None else tokens_by_rid.get(rid, 0)
            tr.decode_tokens += toks
            self.decode_token_count += toks
            self._eng_tokens[engine] += toks
        for rid in finished_rids:
            tr = self.traces[rid]
            tr.decode_end = self._decode_now[engine]
            self.tracker.record(tr)
            self.router.on_complete(tr.prefill_instance)
            self._release_prefill(rid)
        return dt

    def on_migrate(self, trace: RequestTrace, src: int, dst: int,
                   seconds: float) -> None:
        """Cross-engine KV migration: the destination engine cannot resume
        the request before the source clock plus the drain time, so the
        destination clock is bumped (per-request timelines stay monotone —
        ``decode_end`` never precedes ``decode_admit``). The drain charge
        is recorded on the trace (``migration_seconds``), separate from
        ``decode_seconds``, so TPOT keeps meaning pure decode residency."""
        self._decode_now[dst] = max(self._decode_now[dst],
                                    self._decode_now[src] + seconds)
        trace.decode_engine = dst
        trace.migrations += 1
        trace.migration_seconds += seconds
        self.migrations += 1
        self.migration_seconds += seconds

    def engine_clock(self, engine: int) -> float:
        """One engine's virtual clock (the pool frontier is their min)."""
        return self._decode_now[engine]

    def note_mid_scan_refill(self) -> None:
        """An admission landed between engine chunks within one decode
        turn (continuous batching) rather than at a wave boundary."""
        self.mid_scan_refills += 1

    def advance_clock(self, t: float) -> None:
        """Open-loop serving: fast-forward the idle decode pool to the next
        arrival/KV-ready event (never rewinds)."""
        self._decode_now = [max(c, t) for c in self._decode_now]

    def sync_idle_clocks(self, stepped: Sequence[int]) -> None:
        """Engines that sat idle while peers decoded are idle *now*, not at
        their last event: pull their clocks up to the busy frontier (the
        least-advanced stepped engine). Without this, open-loop arrival
        visibility — gated on ``decode_now = min(clocks)`` — would freeze
        at an idle engine's stale clock and serialize the pool into
        bulk-synchronous waves (the idle engine never sees new arrivals
        until the whole pool drains)."""
        busy = [self._decode_now[e] for e in stepped]
        if not busy:
            return
        t = min(busy)
        for e in range(self.n_decode):
            if e not in stepped and self._live[e]:
                self._decode_now[e] = max(self._decode_now[e], t)

    # -- dynamic engine lifecycle (decode-pool autoscaling) ----------------
    def register_engine(self, slot_mgr) -> int:
        """A fresh decode engine joined the pool mid-wave: append its
        admission view and per-engine counters, and warm its virtual clock
        to the busy frontier (the same point ``sync_idle_clocks`` pulls
        idle peers to) — a zero clock would re-serialize open-loop arrival
        visibility onto an engine that did not exist yet."""
        frontier = self.decode_now
        e = self.n_decode
        self.slot_mgrs.append(slot_mgr)
        self.n_decode += 1
        self._live.append(True)
        self._decode_now.append(frontier)
        self._eng_busy.append(0.0)
        self._eng_steps.append(0)
        self._eng_tokens.append(0)
        self._eng_masked.append(0)
        self._slowdown.append(1.0)
        return e

    def set_engine_live(self, engine: int, live: bool) -> None:
        """Park (retired) or revive an existing engine's views. A revived
        engine's clock is warmed to the busy frontier: it comes back *now*,
        not at the stale instant it was parked."""
        if live and not self._live[engine]:
            frontier = self.decode_now
            self._live[engine] = True
            self._decode_now[engine] = max(self._decode_now[engine], frontier)
        else:
            self._live[engine] = live

    # -- dynamic prefill lifecycle (prefill pool / joint autoscaling) ------
    def register_prefill_instance(self) -> int:
        """A fresh prefill instance joined the pool mid-wave: extend its
        virtual clock, in-flight accounting, and the router's id space.
        The new clock starts at the live prefill frontier — a spawned
        instance cannot have been free in the past, and warming it there
        keeps routed TTFTs monotone on the virtual timeline."""
        live_free = [f for f, live in zip(self._instance_free_at,
                                          self._prefill_live) if live]
        frontier = min(live_free) if live_free else 0.0
        i = self.n_prefill
        self.n_prefill += 1
        self._prefill_live.append(True)
        self._instance_free_at.append(frontier)
        self._prefill_inflight.append(0.0)
        self.router.resize(self.n_prefill)
        return i

    def set_prefill_live(self, instance: int, live: bool) -> None:
        """Park (retired) or revive a prefill instance. A revived
        instance's clock is pulled to the live frontier: it comes back
        *now*, not at the stale instant it was parked."""
        if live and not self._prefill_live[instance]:
            live_free = [f for f, on in zip(self._instance_free_at,
                                            self._prefill_live) if on]
            frontier = min(live_free) if live_free else 0.0
            self._prefill_live[instance] = True
            self._instance_free_at[instance] = max(
                self._instance_free_at[instance], frontier)
        else:
            self._prefill_live[instance] = live

    def prefill_backlog_s(self, now: float) -> float:
        """TTFT pressure signal: the worst live instance's queued prefill
        seconds not yet elapsed at ``now`` (0.0 = every live instance is
        free). This is exactly the backlog ``route_prefill`` spreads, so
        the joint autoscaler and the router act on one number."""
        lags = [max(0.0, free - now)
                for free, live in zip(self._instance_free_at,
                                      self._prefill_live) if live]
        return max(lags) if lags else 0.0

    # -- fault tolerance ---------------------------------------------------
    def set_engine_slowdown(self, engine: int, factor: float) -> None:
        """Apply a straggler factor to ``engine``'s step-time charging
        (1.0 = healthy). Asserted by the fault injector every turn, so a
        window expiring between turns heals the engine at the next one."""
        if factor < 1.0:
            raise ValueError("slowdown factor must be >= 1.0")
        self._slowdown[engine] = factor

    def on_engine_failure(self, engine: int) -> None:
        """An engine died. The caller has already parked its views
        (``set_engine_live(engine, False)``); here the failure is counted
        and stamped on the engine-count timeline as a ``fail`` event so
        capacity loss is visible next to grow/shrink decisions."""
        self.engine_failures += 1
        self.record_scale_event("fail", engine)

    def charge_recovery_prefill(self, computed_tokens: int,
                                at: float) -> Tuple[int, float]:
        """Charge a replay re-prefill to the least-backlogged *live*
        prefill instance, starting no earlier than ``at`` (the failure-
        detection instant). Returns ``(instance, completion_time)``;
        concurrent recoveries serialize per instance exactly like arrivals
        do."""
        cands = self.live_prefill_ids or list(range(self.n_prefill))
        i = min(cands, key=lambda j: (self._instance_free_at[j], j))
        start = max(at, self._instance_free_at[i])
        end = start + computed_tokens * self.config.prefill_token_cost_s
        self._instance_free_at[i] = end
        return i, end

    def on_recovery(self, trace: RequestTrace, fail_t: float,
                    tokens_replayed: int, ready_at: float) -> None:
        """A failed engine's in-flight request was rebuilt by replay
        re-prefill and is ready for re-admission at ``ready_at``. The
        latency is charged to the trace (``recovery_seconds``) without
        touching the original prefill/TTFT fields — TTFT already happened;
        recovery is a separate, separately-reported hit."""
        dt = ready_at - fail_t
        trace.recoveries += 1
        trace.tokens_replayed += tokens_replayed
        trace.recovery_seconds += dt
        self.recoveries += 1
        self.tokens_replayed += tokens_replayed
        self.recovery_ttfts.append(dt)

    def on_readmit(self, trace: RequestTrace, engine: int,
                   ready_at: float) -> None:
        """Re-admission of a recovered request. Unlike :meth:`on_admit`
        this must NOT restamp ``decode_admit`` (the original admission is
        what TTFT/queue statistics mean); it only moves the request to its
        new engine and keeps that engine's clock monotone past the
        recovered KV's ready time."""
        trace.decode_engine = engine
        self._decode_now[engine] = max(self._decode_now[engine], ready_at)

    def record_scale_event(self, action: str, engine: int,
                           role: str = "decode") -> None:
        """Stamp a grow/shrink/shift decision on the virtual timeline
        (called after the pool applied it, so the live counts are the new
        ones). ``role`` tags which pool the event's ``engine`` id indexes;
        joint shifts (``shift_p2d`` / ``shift_d2p``) move both counts, so
        both timelines get a point."""
        n_live = sum(self._live)
        n_prefill_live = sum(self._prefill_live)
        t = self.decode_now
        self.scale_events.append({"t": t, "action": action, "engine": engine,
                                  "role": role, "engines_live": n_live,
                                  "prefill_live": n_prefill_live})
        self.engine_count_timeline.append((t, n_live))
        self.prefill_count_timeline.append((t, n_prefill_live))

    def feedback_mtp_acceptance(self) -> Optional[float]:
        """Fold the draft-acceptance rate *measured* by the finished trace
        back into the decode cost model between serve() waves (ROADMAP:
        acceptance-rate feedback into ``DecodeCostModel.mtp_accept``).

        ``decode_tokens`` is credited per iteration as 1 + accepted, so the
        wave's mean acceptance is ``tokens/iters - 1``. The admission gate
        is rebuilt on the calibrated cost: a high-acceptance wave buys a
        larger admitted batch next wave (each iteration now provably emits
        more tokens per unit budget), a low one shrinks it. Returns the
        measured rate, or None when there is nothing to learn or the
        measured rate would make a queue-mode budget unsatisfiable."""
        if not self.config.use_mtp:
            return None
        iters = sum(t.decode_iters for t in self.tracker.finished)
        if iters <= 0:
            return None
        toks = sum(t.decode_tokens for t in self.tracker.finished)
        accept = min(1.0, max(0.0, toks / iters - 1.0))
        new_cost = dataclasses.replace(self.cost, mtp_accept=accept)
        try:
            gate = AdmissionGate(new_cost, self.gate.budget_s,
                                 self.config.admission,
                                 class_budgets=self._class_budgets(),
                                 class_modes=self._class_modes(),
                                 hit_aware=self.config.hit_aware_admission)
        except ValueError:
            return None
        self.cost, self.gate = new_cost, gate
        return accept

    def on_finish(self, trace: RequestTrace, tokens_out: int) -> None:
        trace.tokens_out = tokens_out

    # -- reporting ---------------------------------------------------------
    def trace_records(self) -> List[Dict[str, Any]]:
        """Structured per-request trace, rid-sorted — the benchmark feed."""
        return [self.traces[rid].to_dict() for rid in sorted(self.traces)]

    def summary(self) -> Dict[str, float]:
        s = self.tracker.summary()
        s["decode_steps"] = self.decode_steps
        s["decode_virtual_s"] = self.decode_busy
        s["decode_tokens"] = self.decode_token_count
        if self.decode_steps:
            s["tokens_per_decode_step"] = (self.decode_token_count
                                           / self.decode_steps)
        # Dead-slot observability: fraction of slot-iterations the device
        # spent on resident-but-masked slots (continuous batching exists
        # to drive this toward zero).
        occupied = self.live_slot_iters + self.masked_slot_iters
        s["live_slot_iters"] = self.live_slot_iters
        s["masked_slot_iters"] = self.masked_slot_iters
        s["dead_slot_rate"] = (self.masked_slot_iters / occupied
                               if occupied else 0.0)
        s["mid_scan_refills"] = self.mid_scan_refills
        if self.gate.max_batch is not None:
            s["admitted_batch_cap"] = self.gate.max_batch
        if self.n_decode > 1:
            makespan = max(max(self._decode_now), 1e-12)
            s["decode_engines"] = self.n_decode
            s["engines_live"] = sum(self._live)
            s["migrations"] = self.migrations
            s["engine_decode_steps"] = list(self._eng_steps)
            s["engine_decode_tokens"] = list(self._eng_tokens)
            s["engine_masked_iters"] = list(self._eng_masked)
            s["engine_busy_s"] = [round(b, 9) for b in self._eng_busy]
            s["engine_util"] = [round(b / makespan, 4)
                                for b in self._eng_busy]
        # Fault-tolerance metrics are unconditional: their zeros are the
        # assertion that a run was fault-free, not an absence of data.
        s["engine_failures"] = self.engine_failures
        s["recoveries"] = self.recoveries
        s["tokens_replayed"] = self.tokens_replayed
        s["retries"] = self.transfer_retries
        s["transfer_timeouts"] = self.transfer_timeouts
        s["transfer_corruptions"] = self.transfer_corruptions
        # SLO-class overload control metrics: unconditional zeros, like the
        # fault metrics — "no preemptions" is an assertion, not missing data.
        s["preemptions"] = self.preemptions
        s["preempt_tokens_replayed"] = self.preempt_tokens_replayed
        if self.preempt_latencies:
            s["preempt_p50_s"] = SLOTracker._pct(self.preempt_latencies, 50)
            s["preempt_p99_s"] = SLOTracker._pct(self.preempt_latencies, 99)
        if self.config.brownout:
            s["brownout_level"] = self.brownout_level
            s["brownout_transitions"] = len(self.brownout_events)
            s["brownout_peak_level"] = max(
                (e["to"] for e in self.brownout_events), default=0)
            s["brownout_timeline"] = [
                [round(e["t"], 9), e["from"], e["to"]]
                for e in self.brownout_events]
        if self.recovery_ttfts:
            s["recovery_ttft_p50_s"] = SLOTracker._pct(self.recovery_ttfts, 50)
            s["recovery_ttft_p99_s"] = SLOTracker._pct(self.recovery_ttfts, 99)
        if self.config.stream_handoff or self.stream_requests:
            s["stream_requests"] = self.stream_requests
            s["stream_chunks"] = self.stream_chunks
            s["stream_overlap_s"] = self.stream_overlap_s
            s["stream_bytes"] = self.stream_bytes
            s["stream_max_chunk_bytes"] = self.stream_max_chunk_bytes
        if self.n_prefill > 1 or self.config.joint_autoscale:
            s["prefill_instances"] = self.n_prefill
            s["prefill_live"] = sum(self._prefill_live)
        if self.config.autoscale or self.config.joint_autoscale \
                or self.scale_events:
            # An autoscale wave with zero events is a legitimate all-hold
            # run — still report the (flat) timeline rather than looking
            # like autoscale was off.
            s["scale_events"] = len(self.scale_events)
            s["scale_grows"] = sum(e["action"] == "grow"
                                   for e in self.scale_events)
            s["scale_shrinks"] = sum(e["action"] == "shrink"
                                     for e in self.scale_events)
            s["engine_count_timeline"] = [[round(t, 9), n] for t, n
                                          in self.engine_count_timeline]
        if self.config.joint_autoscale or any(
                e["action"].startswith("shift_") for e in self.scale_events):
            s["shifts_d2p"] = sum(e["action"] == "shift_d2p"
                                  for e in self.scale_events)
            s["shifts_p2d"] = sum(e["action"] == "shift_p2d"
                                  for e in self.scale_events)
            s["prefill_count_timeline"] = [[round(t, 9), n] for t, n
                                           in self.prefill_count_timeline]
        return s
