from repro_torch.serving.engine import (  # noqa: F401
    DecodeEngine,
    PrefillEngine,
    Request,
    RequestResult,
    ServingSystem,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    ROUTERS,
    AdmissionGate,
    BrownoutLadder,
    DecodeCostModel,
    DecodeSlotManager,
    LeastLoadedRouter,
    MicrobatchInterleaver,
    PrefillRouter,
    QueueDepthRouter,
    RequestTrace,
    RoundRobinRouter,
    Scheduler,
    SchedulerConfig,
    SlotError,
    SLOTracker,
    decode_cost_from_roofline,
    make_router,
)
from repro_torch.serving.pool import (  # noqa: F401
    DECODE_ROUTERS,
    CacheAffinityRouter,
    DecodePool,
    DecodePoolRouter,
    DrainError,
    JointAutoscaler,
    LeastLoadedSlotsRouter,
    PoolAutoscaler,
    PoolRoundRobinRouter,
    PrefillPool,
    make_decode_router,
)
from repro_torch.serving.workload import (  # noqa: F401
    ARRIVAL_SHAPES,
    multi_turn_sessions,
    poisson_requests,
    production_requests,
)
from repro_torch.serving.transfer import (  # noqa: F401
    KVTransferEngine,
    TransferCorruption,
    TransferError,
    TransferTimeout,
    connection_map,
    live_connection_map,
    prefill_source_rank,
    transfer_balance,
)
from repro_torch.serving.faults import (  # noqa: F401
    FaultEvent,
    FaultInjector,
    FaultPlan,
)

