"""The port's hand-written CUDA kernels: one module per kernel, each with
its ctypes wrapper (launch counter ``launches``) and its plain PyTorch
version."""
