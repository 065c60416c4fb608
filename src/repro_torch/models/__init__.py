from repro_torch.models.model import (  # noqa: F401
    Model,
    build_plan,
    cache_batch_axes,
    decode_loop,
    decode_step,
    init_params,
    make_caches,
    prefill,
    prefill_continue,
)
