"""DeepSeek-R1 proxy — the paper's own workload: MLA + 256-expert MoE.

[arXiv:2412.19437 (V3) / arXiv:2501.12948 (R1)] 671B total / 37B active.
This is the reference architecture the paper's CloudMatrix-Infer deployment
(EP320, MLA DP, MTP) targets; included alongside the 10 assigned archs.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def deepseek_r1() -> ModelConfig:
    return ModelConfig(
        name="deepseek-r1",
        family="moe",
        source="arXiv:2412.19437 / arXiv:2501.12948",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,        # MLA: latent cache shared; heads expanded on the fly
        head_dim=192,            # qk_nope(128) + qk_rope(64)
        d_ff=2048,               # per-expert FFN width
        vocab_size=129280,
        attention_kind="mla",
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        num_experts=256,
        num_experts_per_tok=8,
        num_shared_experts=1,
        first_k_dense=3,
        rope_theta=10_000.0,
        sliding_window=8192,
    )
