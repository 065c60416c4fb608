"""HuBERT-XLarge — encoder-only audio transformer. [arXiv:2106.07447]

Frontend carve-out: the conv feature extractor is a stub; ``input_specs``
provides precomputed frame embeddings of shape (batch, frames, d_model).
Encoder-only => no decode shapes.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def hubert_xlarge() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        source="arXiv:2106.07447",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        attention_kind="bidirectional",
        rope_theta=10_000.0,
        frontend="audio_frames",
    )
