"""PyTorch / CUDA port of the TAPAS serving stack.

Mirrors the module layout of the JAX package ``repro`` (the reference) and
imports only ``torch``, numpy and the standard library.  The hot attention
kernels are hand-written CUDA C++ for Hopper (``csrc/``); on CPU tensors the
same entry points run their plain PyTorch versions.
"""
