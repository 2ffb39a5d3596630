"""Two-stage quantized retrieval: LSH sign-bit coarse scan, then an exact
fp32 rescore."""
