"""OLMoE-1B-7B — 64-expert top-8 MoE. [arXiv:2409.02060]"""
from repro_torch.configs.base import ModelConfig, register


@register
def olmoe_1b_7b() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        source="arXiv:2409.02060",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1024,              # per-expert FFN width
        vocab_size=50304,
        num_experts=64,
        num_experts_per_tok=8,
        num_shared_experts=0,
        qk_norm=True,
        rope_theta=10_000.0,
        sliding_window=8192,
    )
