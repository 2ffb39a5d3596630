"""phi3-medium-14b [arXiv:2404.14219; unverified].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352, RoPE+SwiGLU.
40 q heads over 10 kv heads: GQA groups of 4, d_head = 128.
"""
from repro_torch.common.config import LMConfig
from repro_torch.common.registry import register_arch
from repro_torch.configs.shapes import LM_SHAPES


@register_arch("phi3-medium-14b")
def phi3_medium_14b() -> LMConfig:
    return LMConfig(
        name="phi3-medium-14b",
        family="lm-dense",
        source="arXiv:2404.14219; unverified",
        shapes=LM_SHAPES,
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        rope_theta=10000.0,
        max_seq_len=524288,
    )
