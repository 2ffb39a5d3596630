"""dien [arXiv:1809.03672; unverified].

embed_dim=18 seq_len=100 gru_dim=108 MLP 200-80, AUGRU interaction.
Single 1M-item id space (target + behavior history index one table).
"""
from repro_torch.common.config import RecSysConfig
from repro_torch.common.registry import register_arch
from repro_torch.configs.shapes import RECSYS_SHAPES


@register_arch("dien")
def dien() -> RecSysConfig:
    return RecSysConfig(
        name="dien",
        family="recsys",
        source="arXiv:1809.03672; unverified",
        shapes=RECSYS_SHAPES,
        n_sparse=1,
        embed_dim=18,
        vocab_sizes=(1_000_000,),
        mlp_dims=(200, 80),
        seq_len=100,
        gru_dim=108,
        interaction="augru",
    )
