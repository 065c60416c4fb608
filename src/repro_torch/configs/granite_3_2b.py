"""Granite-3.0-2B — dense GQA. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.configs.base import ModelConfig, register


@register
def granite_3_2b() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        family="dense",
        source="hf:ibm-granite/granite-3.0-2b-base",
        num_layers=40,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=49155,
        rope_theta=10_000.0,
        tie_embeddings=True,
        sliding_window=8192,
    )
