"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of the
JAX package that the port has reached so far:

* ``mla_attention`` -- absorbed-MLA decode attention over the latent cache
  (replaces ``repro/kernels/mla_attention/mla_attention.py``'s Pallas kernel).

Each kernel package has ``ref.py`` (the same function in plain PyTorch) and
``ops.py`` (the wrapper: the plain version for a CPU tensor, the kernel for
a CUDA tensor, and a launch count). Sources live in ``csrc/``;
``build.py`` compiles them with ``nvcc`` at first use.
"""
