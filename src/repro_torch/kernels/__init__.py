"""Deploy-matmul kernels: hand-written CUDA for Hopper (``csrc/``), their
plain PyTorch versions (``ref``) and the QTensor dispatch (``ops``)."""
