"""Model / input-shape configuration system.

One :class:`ModelConfig` dataclass covers every architecture family assigned to
this paper (dense GQA, MoE, SSM, hybrid, audio-encoder, VLM) plus the paper's
own DeepSeek-R1-style MLA+MoE model. Each ``configs/<arch>.py`` module
registers exactly one full-size config; ``smoke_variant`` derives the reduced
CPU-testable configuration required by the per-arch smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    source: str                      # citation for the config (paper / model card)
    num_layers: int
    d_model: int
    num_heads: int                   # 0 => attention-free
    num_kv_heads: int
    head_dim: int
    d_ff: int                        # dense FFN width (per-expert width for MoE)
    vocab_size: int

    # --- attention options -------------------------------------------------
    attention_kind: str = "causal"   # causal | bidirectional | mla | none
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    # Serving variant for long-context decode of full-attention archs
    # (beyond-paper extension; see DESIGN.md §3). None => full attention only.
    sliding_window: Optional[int] = None

    # --- MLA (DeepSeek-style latent attention) -----------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    first_k_dense: int = 0           # leading dense layers in MoE models
    router_aux_loss_coef: float = 0.001
    # capacity factor for static dispatch buffers (paper Eq. 1-2)
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128             # SSD chunk length

    # --- hybrid (Zamba2-style) ----------------------------------------------
    attn_every: int = 0              # one shared attention block every N ssm layers

    # --- modality frontend stubs --------------------------------------------
    frontend: Optional[str] = None   # audio_frames | vision_patches
    num_prefix_embeddings: int = 0   # patches / frames provided by the stub

    # --- numerics -----------------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm_state > 0 and self.attn_every == 0 and self.num_heads == 0

    @property
    def is_hybrid(self) -> bool:
        return self.ssm_state > 0 and self.attn_every > 0

    @property
    def is_encoder_only(self) -> bool:
        return self.attention_kind == "bidirectional"

    @property
    def ssm_heads(self) -> int:
        if self.ssm_state == 0:
            return 0
        return (self.d_model * self.ssm_expand) // self.ssm_head_dim

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder_only

    def supports_long_context(self) -> bool:
        """Sub-quadratic path available for 500k decode?"""
        if self.is_ssm or self.is_hybrid:
            return True
        return self.sliding_window is not None

    # Parameter count (for roofline MODEL_FLOPS = 6*N*D; MoE: active params).
    def param_count(self, active_only: bool = False) -> int:
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        for li in range(self.num_layers):
            total += self._layer_params(li, active_only)
        return total

    def _layer_params(self, layer_idx: int, active_only: bool) -> int:
        d = self.d_model
        p = 2 * d  # two RMSNorm gains
        is_ssm_layer = self.ssm_state > 0 and not (
            self.attn_every and (layer_idx + 1) % self.attn_every == 0
        )
        if self.ssm_state > 0 and is_ssm_layer:
            din = d * self.ssm_expand
            nheads = self.ssm_heads
            # in_proj: z, x, B, C, dt
            p += d * (2 * din + 2 * self.ssm_state + nheads)
            p += din * self.ssm_conv          # conv
            p += 2 * nheads                    # A_log, D
            p += din * d                       # out proj
            p += din                           # gated norm
        elif self.attention_kind == "mla":
            p += d * self.q_lora_rank + self.q_lora_rank * self.num_heads * (
                self.qk_nope_head_dim + self.qk_rope_head_dim)
            p += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            p += self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)
            p += self.num_heads * self.v_head_dim * d
        elif self.num_heads > 0:
            q = d * self.num_heads * self.head_dim
            kv = 2 * d * self.num_kv_heads * self.head_dim
            o = self.num_heads * self.head_dim * d
            p += q + kv + o
        # FFN
        if self.is_moe and layer_idx >= self.first_k_dense:
            e_active = self.num_experts_per_tok if active_only else self.num_experts
            p += (e_active + self.num_shared_experts) * 3 * d * self.d_ff
            p += d * self.num_experts  # router
        elif not (self.ssm_state > 0 and is_ssm_layer):
            p += 3 * d * self.d_ff
        return p


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # Import side-effect registration.
        from repro_torch import configs as _c  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> List[str]:
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Reduced smoke variant (2 layers, d_model<=512, <=4 experts) per assignment.
# ---------------------------------------------------------------------------


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    d = min(cfg.d_model, 256)
    heads = 0 if cfg.num_heads == 0 else min(cfg.num_heads, 4)
    kv = 0 if cfg.num_heads == 0 else min(cfg.num_kv_heads, heads)
    head_dim = 64 if cfg.num_heads else 0
    upd: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        dtype="float32",
    )
    if cfg.is_moe:
        upd.update(
            num_experts=min(cfg.num_experts, 4),
            num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
            num_shared_experts=min(cfg.num_shared_experts, 1),
            first_k_dense=min(cfg.first_k_dense, 1),
        )
    if cfg.attention_kind == "mla":
        upd.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                   qk_rope_head_dim=16, v_head_dim=32, head_dim=48)
    if cfg.ssm_state > 0:
        upd.update(ssm_state=min(cfg.ssm_state, 16), ssm_head_dim=32, ssm_chunk=32)
        if cfg.attn_every:
            upd.update(attn_every=2)
    if cfg.sliding_window:
        upd.update(sliding_window=min(cfg.sliding_window, 64))
    if cfg.num_prefix_embeddings:
        upd.update(num_prefix_embeddings=min(cfg.num_prefix_embeddings, 16))
    return dataclasses.replace(cfg, **upd)
