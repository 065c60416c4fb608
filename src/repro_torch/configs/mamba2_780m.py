"""Mamba2-780m — attention-free SSM using SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, register


@register
def mamba2_780m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        source="arXiv:2405.21060",
        num_layers=48,
        d_model=1536,
        num_heads=0,            # attention-free
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,                 # Mamba2 blocks subsume the FFN
        vocab_size=50280,
        attention_kind="none",
        ssm_state=128,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=128,
        tie_embeddings=True,
    )
