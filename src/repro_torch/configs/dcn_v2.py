"""dcn-v2 [arXiv:2008.13535; paper].

13 dense + 26 sparse fields, embed_dim=16, 3 cross layers,
MLP 1024-1024-512 (criteo production config).
"""
from repro_torch.common.config import RecSysConfig
from repro_torch.common.registry import register_arch
from repro_torch.configs.shapes import RECSYS_SHAPES

VOCABS = tuple([10_000] * 13 + [1_000_000] * 13)


@register_arch("dcn-v2")
def dcn_v2() -> RecSysConfig:
    return RecSysConfig(
        name="dcn-v2",
        family="recsys",
        source="arXiv:2008.13535; paper",
        shapes=RECSYS_SHAPES,
        n_dense=13,
        n_sparse=26,
        embed_dim=16,
        vocab_sizes=VOCABS,
        mlp_dims=(1024, 1024, 512),
        n_cross_layers=3,
        interaction="cross",
    )
