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
from repro_torch.mempool.context_cache import ContextCache  # noqa: F401
from repro_torch.mempool.ems import EMSService  # noqa: F401
from repro_torch.mempool.model_cache import ModelCache, ModelMeta  # noqa: F401
