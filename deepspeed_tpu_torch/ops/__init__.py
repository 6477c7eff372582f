"""Operators of the PyTorch port: masks, the CUDA kernels and their build."""
