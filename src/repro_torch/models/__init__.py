from repro_torch.models.attention import KVCache  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    Model,
    build_plan,
    cache_batch_axes,
    decode_loop,
    decode_loop_mtp,
    decode_ready_caches,
    decode_step,
    embed_inputs,
    forward,
    init_params,
    lm_loss,
    make_caches,
    prefill,
    prefill_continue,
)
from repro_torch.models.mamba2 import (  # noqa: F401
    SSMState,
    mamba_decode,
    mamba_prefill,
    make_ssm_state,
    ssd_chunked,
    ssd_reference,
)
