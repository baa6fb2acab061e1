"""Hand-written CUDA kernels for the port (``csrc/``), each with its
wrapper, its plain PyTorch version and a launch count."""
