"""Assigned architecture configs (``--arch <id>``).

Importing this package registers all 10 architectures of the JAX
package, under its names, + the paper's own EraRAG config defaults.
"""
from repro_torch.configs import (  # noqa: F401
    dcn_v2,
    deepfm,
    deepseek_moe_16b,
    dien,
    gatedgcn,
    llama3_8b,
    llama4_maverick,
    mind,
    phi3_medium,
    qwen2_7b,
)
from repro_torch.configs.erarag import ERARAG_DEFAULT  # noqa: F401
