from repro_torch.kernels.int8_gemm.ops import int8_matmul  # noqa: F401
