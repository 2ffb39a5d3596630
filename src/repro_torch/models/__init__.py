"""The LM family: layers, the dense decoder-only transformer, and the
weight bridge from the JAX package's parameter pytree."""
