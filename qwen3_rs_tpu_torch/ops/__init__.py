"""Tensor operations of the port: plain PyTorch ops and the kernel wrappers
under ``ops/kernels``."""
