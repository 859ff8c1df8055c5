"""dpBento on PyTorch and CUDA: the port of the JAX package ``repro`` to one NVIDIA H100."""
