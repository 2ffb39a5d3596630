"""llama3-8b [arXiv:2407.21783; unverified].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from repro_torch.common.config import LMConfig
from repro_torch.common.registry import register_arch
from repro_torch.configs.shapes import LM_SHAPES


@register_arch("llama3-8b")
def llama3_8b() -> LMConfig:
    return LMConfig(
        name="llama3-8b",
        family="lm-dense",
        source="arXiv:2407.21783; unverified",
        shapes=LM_SHAPES,
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500000.0,
        max_seq_len=524288,
    )
