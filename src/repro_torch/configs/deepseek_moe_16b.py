"""deepseek-moe-16b [arXiv:2401.06066; hf].

28L d_model=2048 16H (kv=16, i.e. MHA) d_ff=1408 vocab=102400,
2 shared + 64 routed experts, top-6 fine-grained.
"""
from repro_torch.common.config import LMConfig, MoEConfig
from repro_torch.common.registry import register_arch
from repro_torch.configs.shapes import LM_SHAPES


@register_arch("deepseek-moe-16b")
def deepseek_moe_16b() -> LMConfig:
    return LMConfig(
        name="deepseek-moe-16b",
        family="lm-moe",
        source="arXiv:2401.06066; hf",
        shapes=LM_SHAPES,
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        rope_theta=10000.0,
        max_seq_len=524288,
        moe=MoEConfig(
            n_experts=64,
            top_k=6,
            n_shared=2,
            d_ff_expert=1408,
        ),
    )
