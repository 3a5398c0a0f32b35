"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions;
``ops`` routes CPU tensors to the plain versions and CUDA tensors to the
kernels."""
