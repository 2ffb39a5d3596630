"""mind [arXiv:1904.08030; unverified].

embed_dim=64, 4 interest capsules, 3 routing iterations,
multi-interest retrieval over a 1M-item space.
"""
from repro_torch.common.config import RecSysConfig
from repro_torch.common.registry import register_arch
from repro_torch.configs.shapes import RECSYS_SHAPES


@register_arch("mind")
def mind() -> RecSysConfig:
    return RecSysConfig(
        name="mind",
        family="recsys",
        source="arXiv:1904.08030; unverified",
        shapes=RECSYS_SHAPES,
        n_sparse=1,
        embed_dim=64,
        vocab_sizes=(1_000_000,),
        seq_len=50,
        n_interests=4,
        capsule_iters=3,
        interaction="multi-interest",
    )
