"""Qwen3-8B — dense GQA with qk-norm. [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ModelConfig, register


@register
def qwen3_8b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        family="dense",
        source="hf:Qwen/Qwen3-8B",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        sliding_window=8192,  # serving-only SWA variant for long_500k (DESIGN.md §3)
    )
