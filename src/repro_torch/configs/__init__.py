"""Architecture configs. Importing this package registers every config
ported so far (the paper's own DeepSeek-R1 and Mamba2-780m; the other
families arrive with their slices of the port)."""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    get_shape,
    list_configs,
    smoke_variant,
)

# Registration side effects.
from repro_torch.configs import deepseek_r1, mamba2_780m  # noqa: F401
