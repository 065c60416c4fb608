"""Deterministic fault injection for the serving plane.

Production MaaS treats failure recovery as a first-class scheduler concern
(DeepServe; paper §4.1's independently scaled pools only pay off if the
plane survives component loss). This module supplies the *deterministic*
half of that story: faults are **scheduled, not sampled at run time**. A
:class:`FaultPlan` is a list of :class:`FaultEvent`\\ s pinned either to
the virtual clock (engine crashes, slow-engine stragglers) or to
RDMA-plane operation ordinals (transfer timeouts / payload corruption),
so a fixed plan + request stream reproduces the identical failure
sequence — and therefore the identical recovery trace — every run. The
seeded :meth:`FaultPlan.random` generator derives a plan from a single
integer, which is what ``serve.py --fault-plan random --fault-seed N``
and the fault soak use.

Event kinds
-----------
``engine_crash``     — decode engine ``engine`` dies when *its own*
                       virtual clock reaches ``at`` (detected at the next
                       chunk boundary; in-flight requests are recovered by
                       replay re-prefill, see ``ServingSystem``).
``transfer_timeout`` — the next ``count`` RDMA ops of kind ``op``
                       (``transfer`` | ``migrate`` | ``any``) at or after
                       attempt ordinal ``after`` stall for the transfer
                       engine's timeout window and must be retried.
``transfer_corrupt`` — same addressing, but the payload arrives with a
                       mismatched fingerprint (full wire cost paid, the
                       delivery is discarded and retried).
``slow_engine``      — engine ``engine`` (or every engine, ``engine=-1``)
                       runs ``factor``× slower while its clock is inside
                       ``[at, at + duration)``.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Any, Dict, List, Optional, Sequence

FAULT_KINDS = ("engine_crash", "transfer_timeout", "transfer_corrupt",
               "slow_engine")
TRANSFER_OPS = ("transfer", "migrate", "any")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. Field relevance depends on ``kind`` (see the
    module docstring); irrelevant fields keep their defaults."""

    kind: str
    engine: int = -1                 # crash / straggler target (-1 = all,
    #                                  stragglers only; crashes need an id)
    at: float = 0.0                  # virtual seconds on the engine clock
    op: str = "any"                  # transfer faults: which RDMA op
    after: int = 0                   # transfer faults: skip the first N
    #                                  matching attempts
    count: int = 1                   # transfer faults: attempts affected
    factor: float = 1.0              # slow_engine: step-time multiplier
    duration: float = float("inf")   # slow_engine: window length
    # Transfer faults under pipelined chunked streaming: one request's
    # handoff is now MANY transfer ops, so a plan written against op
    # ordinals alone silently retargets a different chunk when chunking
    # changes. rid/chunk >= 0 scope the event to one request and/or one
    # chunk; the `after` ordinal then counts only that (rid, op, chunk)'s
    # own attempts. -1 (the default) keeps the legacy op-scope addressing,
    # so pre-streaming plans stay valid for unchunked ops.
    rid: int = -1                    # transfer faults: target request
    chunk: int = -1                  # transfer faults: target stream chunk

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"available: {FAULT_KINDS}")
        if self.op not in TRANSFER_OPS:
            raise ValueError(f"unknown transfer op {self.op!r}; "
                             f"available: {TRANSFER_OPS}")
        if self.kind == "engine_crash" and self.engine < 0:
            raise ValueError("engine_crash needs an explicit engine id")
        if self.count < 1 or self.after < 0:
            raise ValueError("need count >= 1 and after >= 0")
        if self.rid < -1 or self.chunk < -1:
            raise ValueError("rid/chunk must be >= 0, or -1 for unscoped")
        if self.factor < 1.0:
            raise ValueError("slow_engine factor must be >= 1.0 (a straggler"
                             " never speeds an engine up)")
        if self.at < 0.0 or self.duration <= 0.0:
            raise ValueError("need at >= 0 and duration > 0")

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if d["duration"] == float("inf"):
            d["duration"] = None        # JSON-safe
        return d


@dataclasses.dataclass
class FaultPlan:
    """An ordered, finite fault schedule (order breaks transfer-fault ties:
    the first matching event claims an attempt)."""

    events: List[FaultEvent] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self.events = [e if isinstance(e, FaultEvent) else FaultEvent(**e)
                       for e in self.events]

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse a JSON plan: either a bare event list or
        ``{"events": [...]}``. ``duration: null`` means unbounded."""
        data = json.loads(text)
        if isinstance(data, dict):
            data = data.get("events", [])
        events = []
        for raw in data:
            raw = dict(raw)
            if raw.get("duration") is None:
                raw.pop("duration", None)
            events.append(FaultEvent(**raw))
        return cls(events)

    @classmethod
    def load(cls, spec: str, *, seed: int = 0, n_engines: int = 2,
             horizon_s: float = 0.5) -> "FaultPlan":
        """CLI entry: ``@path`` reads a JSON file, the literal ``random``
        derives a seeded plan, anything else is inline JSON."""
        if spec == "random":
            return cls.random(seed, n_engines=n_engines, horizon_s=horizon_s)
        if spec.startswith("@"):
            with open(spec[1:], "r", encoding="utf-8") as fh:
                return cls.parse(fh.read())
        return cls.parse(spec)

    @classmethod
    def random(cls, seed: int, *, n_engines: int, horizon_s: float,
               n_crashes: int = 1, n_transfer_faults: int = 1,
               n_stragglers: int = 1) -> "FaultPlan":
        """Seeded plan generator: everything below derives from ``seed``
        through one ``random.Random`` stream, so the same seed always
        yields the same plan (the acceptance criterion's ≥1 mid-decode
        crash + ≥1 transfer timeout is guaranteed by construction)."""
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        for _ in range(n_crashes):
            events.append(FaultEvent(
                "engine_crash", engine=rng.randrange(max(1, n_engines)),
                at=rng.uniform(0.1, 0.9) * horizon_s))
        for i in range(n_transfer_faults):
            kind = "transfer_timeout" if i == 0 else rng.choice(
                ("transfer_timeout", "transfer_corrupt"))
            events.append(FaultEvent(
                kind, op=rng.choice(("transfer", "migrate", "any")),
                after=rng.randrange(4), count=rng.randrange(1, 3)))
        for _ in range(n_stragglers):
            start = rng.uniform(0.0, 0.5) * horizon_s
            events.append(FaultEvent(
                "slow_engine", engine=rng.randrange(max(1, n_engines)),
                at=start, factor=1.0 + rng.uniform(0.5, 3.0),
                duration=rng.uniform(0.1, 0.5) * horizon_s))
        return cls(events)

    def __add__(self, other: "FaultPlan") -> "FaultPlan":
        """Compose two plans into one schedule (self's events first —
        order is the tie-break for transfer-fault claims, so composition
        is deterministic and associative but not commutative). Lets the
        workload soak cross a crash plan with a straggler/transfer plan
        without regenerating either."""
        if not isinstance(other, FaultPlan):
            return NotImplemented
        return FaultPlan(list(self.events) + list(other.events))

    def to_json(self) -> str:
        return json.dumps({"events": [e.to_dict() for e in self.events]})


class FaultInjector:
    """Consumes a :class:`FaultPlan` against the serving loop.

    Stateful but deterministic: every query either reads pure plan state
    (``slowdown``) or consumes scheduled events in plan order
    (``due_crashes``, ``transfer_fault``). ``seed`` is provenance only —
    it labels the injector when the plan came from :meth:`FaultPlan.random`
    so traces/benches can report which seeded schedule ran.
    """

    def __init__(self, plan: FaultPlan, seed: int = 0):
        self.plan = plan
        self.seed = seed
        self._crash_events = [e for e in plan.events
                              if e.kind == "engine_crash"]
        self._crash_fired = [False] * len(self._crash_events)
        self._slow_events = [e for e in plan.events if e.kind == "slow_engine"]
        self._transfer_events = [
            e for e in plan.events
            if e.kind in ("transfer_timeout", "transfer_corrupt")]
        self._consumed = [0] * len(self._transfer_events)
        # Per-event matching-attempt counters: event i has seen _seen[i]
        # attempts inside its own scope (op alone for legacy events;
        # op + rid/chunk for scoped ones), so `after` always means "skip
        # the first N attempts THIS event could have claimed". For
        # unscoped events this is arithmetically identical to the old
        # global per-op / per-any ordinals — pre-streaming plans keep
        # firing on the very same attempts.
        self._seen = [0] * len(self._transfer_events)
        # Observability counters (mirrored into bench fault sections).
        self.crashes_fired = 0
        self.timeouts_injected = 0
        self.corruptions_injected = 0

    # -- engine crashes ----------------------------------------------------
    def due_crashes(self, clocks: Sequence[float]) -> List[int]:
        """Engines whose scheduled crash time has been reached by *their
        own* virtual clock. Each crash event fires exactly once; firing is
        recorded even for an engine id outside ``clocks`` (a plan written
        for a bigger pool must not re-arm forever)."""
        due: List[int] = []
        for i, ev in enumerate(self._crash_events):
            if self._crash_fired[i]:
                continue
            if ev.engine >= len(clocks):
                self._crash_fired[i] = True
                continue
            if clocks[ev.engine] >= ev.at:
                self._crash_fired[i] = True
                self.crashes_fired += 1
                due.append(ev.engine)
        return sorted(set(due))

    # -- stragglers --------------------------------------------------------
    def slowdown(self, engine: int, now: float) -> float:
        """The step-time multiplier ``engine`` suffers at virtual time
        ``now`` (1.0 = healthy; overlapping windows take the worst)."""
        factor = 1.0
        for ev in self._slow_events:
            if ev.engine not in (-1, engine):
                continue
            if ev.at <= now < ev.at + ev.duration:
                factor = max(factor, ev.factor)
        return factor

    # -- transfer faults ---------------------------------------------------
    def transfer_fault(self, op: str, rid: Optional[int] = None,
                       chunk: Optional[int] = None) -> Optional[str]:
        """Per-attempt hook for ``KVTransferEngine``: returns ``"timeout"``
        / ``"corrupt"`` when a scheduled fault claims this attempt, else
        None. Addressing for legacy (unscoped) events is by attempt
        *ordinal* within the event's op scope (``op="any"`` scopes over
        all RDMA attempts) — bit-compatible with pre-streaming plans. An
        event carrying ``rid``/``chunk`` >= 0 instead claims only attempts
        for that request/chunk, with ``after`` counted against that
        ``(rid, op, chunk)``'s own attempts — chunked streaming multiplies
        transfer ops per request, and scoped addressing is what keeps a
        plan aimed at one chunk from silently retargeting another. In both
        schemes retries of a faulted op count as fresh attempts, so a
        ``count=k`` event fails the op ``k`` consecutive times (how
        backoff and retry exhaustion get exercised)."""
        a_rid = -1 if rid is None else rid
        a_chunk = -1 if chunk is None else chunk
        # Count the attempt against EVERY event whose scope it falls in
        # (even events that will not claim it): an event's ordinal stream
        # must be independent of which other event fires first, or plan
        # composition would stop being deterministic.
        ordinals: Dict[int, int] = {}
        for i, ev in enumerate(self._transfer_events):
            if ev.op not in (op, "any"):
                continue
            if ev.rid >= 0 and ev.rid != a_rid:
                continue
            if ev.chunk >= 0 and ev.chunk != a_chunk:
                continue
            ordinals[i] = self._seen[i]
            self._seen[i] += 1
        for i, ordinal in ordinals.items():
            ev = self._transfer_events[i]
            if ordinal >= ev.after and self._consumed[i] < ev.count:
                self._consumed[i] += 1
                if ev.kind == "transfer_timeout":
                    self.timeouts_injected += 1
                    return "timeout"
                self.corruptions_injected += 1
                return "corrupt"
        return None

    # -- reporting ---------------------------------------------------------
    def summary(self) -> Dict[str, int]:
        return {"seed": self.seed,
                "planned_events": len(self.plan.events),
                "crashes_fired": self.crashes_fired,
                "timeouts_injected": self.timeouts_injected,
                "corruptions_injected": self.corruptions_injected}
