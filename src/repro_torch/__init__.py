"""PyTorch/CUDA port of the CloudMatrix-Infer reproduction.

The package mirrors the JAX package's layout (``configs/``, ``models/``,
``kernels/``, ``serving/``, ``mempool/``, ``core/``, ``quant/``) so each
module has its counterpart under the same path. It imports ``torch``, numpy and the
standard library only. Entry points run on the card (``device="cuda"``) unless
the caller passes ``device="cpu"``; they never fall back to the CPU on their
own. On a CUDA tensor every kernel wrapper launches its hand-written kernel
or raises.
"""
