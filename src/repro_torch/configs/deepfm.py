"""deepfm [arXiv:1703.04247; paper].

39 sparse fields, embed_dim=10, MLP 400-400-400, FM interaction.
Vocab sizes are not in the paper table; we use a criteo/avazu-style
mix (13 small / 13 medium / 13 large fields, 14.3M rows total).
"""
from repro_torch.common.config import RecSysConfig
from repro_torch.common.registry import register_arch
from repro_torch.configs.shapes import RECSYS_SHAPES

VOCABS = tuple([1_000] * 13 + [100_000] * 13 + [1_000_000] * 13)


@register_arch("deepfm")
def deepfm() -> RecSysConfig:
    return RecSysConfig(
        name="deepfm",
        family="recsys",
        source="arXiv:1703.04247; paper",
        shapes=RECSYS_SHAPES,
        n_sparse=39,
        embed_dim=10,
        vocab_sizes=VOCABS,
        mlp_dims=(400, 400, 400),
        interaction="fm",
    )
