"""INT8 quantization (paper §4.5)."""
from repro_torch.quant.int8 import (  # noqa: F401
    INT8_PATHS,
    KEEP_PATHS,
    QuantizedLinear,
    adaptive_scale_search,
    block_clip_search,
    calibrate_linear,
    equalization_scales,
    error_compensation,
    k_major,
    quantize_act_per_token,
    quantize_param_tree,
    quantize_weight_per_channel,
    quantized_matmul,
    should_quantize,
)
