"""Packed hyperplane LSH hashing (CUDA kernel + plain version)."""
