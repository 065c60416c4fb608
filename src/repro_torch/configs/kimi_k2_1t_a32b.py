"""Kimi K2 — trillion-param MoE, 384 experts top-8 (paper-table scale). [arXiv:2501.kimi2]

Assigned config uses GQA (64H, kv=8) per the public pool table; 1 shared
expert per Kimi K2's card. This is the closest stand-in in the assigned pool
for the paper's DeepSeek-R1 deployment (EP320, one expert per die).
"""
from repro_torch.configs.base import ModelConfig, register


@register
def kimi_k2_1t_a32b() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        source="arXiv:2501.kimi2 (paper-table)",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=2048,              # per-expert FFN width
        vocab_size=163840,
        num_experts=384,
        num_experts_per_tok=8,
        num_shared_experts=1,
        first_k_dense=1,
        rope_theta=50_000.0,
        sliding_window=8192,
    )
