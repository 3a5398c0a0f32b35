"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions;
``ops`` registers each kernel as a ``torch.library`` op whose dispatcher
sends CPU tensors to the plain version and CUDA tensors to the kernel."""
