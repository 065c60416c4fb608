"""Qwen2.5-3B-class — dense GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B family]"""
from repro_torch.configs.base import ModelConfig, register


@register
def qwen2_5_3b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b",
        family="dense",
        source="hf:Qwen/Qwen2.5-0.5B (family card; assigned 3B-scale variant)",
        num_layers=36,
        d_model=2048,
        num_heads=16,
        num_kv_heads=2,
        head_dim=128,
        d_ff=11008,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        sliding_window=8192,
    )
