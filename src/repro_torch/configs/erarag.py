"""The paper's own system config (EraRAG hyper-parameters).

``ERARAG_DEFAULT`` is the main path: a flat store, no LM, no quantized
scan, no cache — the configuration ``chip_smoke.py`` drives on the card.
"""
from repro_torch.common.config import EraRAGConfig

ERARAG_DEFAULT = EraRAGConfig(
    n_hyperplanes=12,
    s_min=4,
    s_max=12,
    max_layers=4,
    embed_dim=256,
    chunk_tokens=64,
    top_k=8,
    token_budget=2048,
)
