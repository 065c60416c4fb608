"""Zamba2-1.2B — hybrid Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig, register


@register
def zamba2_1_2b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        source="arXiv:2411.15242",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,              # FFN of the shared attention block
        vocab_size=32000,
        ssm_state=64,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=128,
        attn_every=6,           # one shared attention block every 6 layers
        rope_theta=10_000.0,
        sliding_window=8192,    # attention layers use SWA at 500k; mamba native
        tie_embeddings=True,
    )
