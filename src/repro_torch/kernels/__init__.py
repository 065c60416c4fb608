"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of the
JAX package:

* ``mla_attention`` -- absorbed-MLA decode attention over the latent cache
  (replaces ``repro/kernels/mla_attention/mla_attention.py``'s Pallas kernel).
* ``dispatch_quant`` -- per-row INT8 quantization of the expert-parallel
  dispatch buffer and of activations, optionally packing each row's f32
  scale into its last 4 bytes (replaces ``repro/kernels/dispatch_quant/
  dispatch_quant.py``).
* ``int8_gemm`` -- int8 x int8 -> int32 GEMM with the per-token x
  per-channel rescale (replaces ``repro/kernels/int8_gemm/int8_gemm.py``).
* ``ssd_scan`` -- the Mamba2 SSD chunked scan with a ragged last chunk
  (replaces ``repro/kernels/ssd_scan/ssd_scan.py``).

Each kernel package has ``ref.py`` (the same function in plain PyTorch) and
``ops.py`` (the wrapper: the plain version for a CPU tensor, the kernel for
a CUDA tensor, and a launch count). Sources live in ``csrc/``;
``build.py`` compiles them with ``nvcc`` at first use.
"""
