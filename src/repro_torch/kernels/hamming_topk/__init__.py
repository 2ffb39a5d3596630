"""Packed-code Hamming top-k (CUDA kernel + plain version)."""
