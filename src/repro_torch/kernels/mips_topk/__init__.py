"""Maximum-inner-product top-k (CUDA kernel + plain version)."""
