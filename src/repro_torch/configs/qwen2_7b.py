"""qwen2-7b [arXiv:2407.10671; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, QKV bias.
"""
from repro_torch.common.config import LMConfig
from repro_torch.common.registry import register_arch
from repro_torch.configs.shapes import LM_SHAPES


@register_arch("qwen2-7b")
def qwen2_7b() -> LMConfig:
    return LMConfig(
        name="qwen2-7b",
        family="lm-dense",
        source="arXiv:2407.10671; hf",
        shapes=LM_SHAPES,
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1000000.0,
        max_seq_len=524288,
    )
