"""EraRAG in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

Laid out module for module like the JAX package ``repro``: the same
public names and contracts, held against it by the differential tests
in ``tests/test_torch_*.py``.  This package imports ``torch``, numpy and
the standard library only — never ``jax`` and nothing under ``repro.``.

Entry points (``EraRAG``, ``VectorStore``, ``HyperplaneLSH``, the kernel
ops) run on ``cuda`` unless the caller passes ``device="cpu"``; without
CUDA and without that request they raise, never falling back.

Precision: TF32 is switched off for both matmuls and cuDNN here, at
import, so every fp32 product in the package (the plain reference
versions the kernels are compared against included) runs in full fp32,
as the JAX reference does.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
