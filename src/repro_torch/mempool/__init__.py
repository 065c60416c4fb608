from repro_torch.mempool.pool import (  # noqa: F401
    MemoryPool,
    MPController,
    MPServer,
    OBS_STORE,
    PlaneModel,
    SSD_TIER,
    UB_PLANE,
    VPC_PLANE,
)
