from repro_torch.kernels.mla_attention.ops import mla_decode_attention  # noqa: F401
