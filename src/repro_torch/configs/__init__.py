"""Architecture configs. Importing this package registers every config of
the JAX package: the paper's own DeepSeek-R1, the dense and GQA-MoE
families (Qwen3-8B, Qwen2.5-3B, Granite-3-2B, Phi-3-medium, OLMoE-1B-7B,
Kimi K2), Mamba2-780m, the Zamba2 hybrid and the two frontends
(InternVL2-2B's patch prefix, HuBERT-XLarge's audio frames)."""
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
from repro_torch.configs import (  # noqa: F401
    deepseek_r1,
    granite_3_2b,
    hubert_xlarge,
    internvl2_2b,
    kimi_k2_1t_a32b,
    mamba2_780m,
    olmoe_1b_7b,
    phi3_medium_14b,
    qwen2_5_3b,
    qwen3_8b,
    zamba2_1_2b,
)
