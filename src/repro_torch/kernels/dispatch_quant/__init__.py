from repro_torch.kernels.dispatch_quant.ops import dispatch_quantize  # noqa: F401
