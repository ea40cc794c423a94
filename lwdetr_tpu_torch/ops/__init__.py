"""Operators of the PyTorch/CUDA port: plain tensor code and the CUDA kernel wrappers."""
