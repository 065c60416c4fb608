"""InternVL2-2B — InternViT + InternLM2 backbone. [arXiv:2404.16821]

Frontend carve-out: the ViT + projector are a stub; ``input_specs`` provides
precomputed patch embeddings prepended to the token stream.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def internvl2_2b() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        source="arXiv:2404.16821",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        rope_theta=1_000_000.0,
        frontend="vision_patches",
        num_prefix_embeddings=256,   # one 448px tile => 256 visual tokens
        sliding_window=8192,
    )
