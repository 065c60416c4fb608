"""Phi-3-medium-14B — dense GQA, RoPE + SwiGLU. [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig, register


@register
def phi3_medium_14b() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        source="arXiv:2404.14219",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        vocab_size=100352,
        rope_theta=10_000.0,
        sliding_window=8192,
    )
