"""gatedgcn [arXiv:2003.00982; paper].

16L d_hidden=70, gated aggregator (Benchmarking-GNNs configuration).
"""
from repro_torch.common.config import GNNConfig
from repro_torch.common.registry import register_arch
from repro_torch.configs.shapes import GNN_SHAPES


@register_arch("gatedgcn")
def gatedgcn() -> GNNConfig:
    return GNNConfig(
        name="gatedgcn",
        family="gnn",
        source="arXiv:2003.00982; paper",
        shapes=GNN_SHAPES,
        n_layers=16,
        d_hidden=70,
        aggregator="gated",
        n_classes=47,
    )
