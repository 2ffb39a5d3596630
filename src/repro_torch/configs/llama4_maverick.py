"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-*; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
(+1 shared expert), dense/MoE layers interleaved 1:1 (moe_every=2 --
matches the released model's ~400B total / ~17B active split; each
block is [dense, moe]).
"""
from repro_torch.common.config import LMConfig, MoEConfig
from repro_torch.common.registry import register_arch
from repro_torch.configs.shapes import LM_SHAPES


@register_arch("llama4-maverick-400b-a17b")
def llama4_maverick() -> LMConfig:
    return LMConfig(
        name="llama4-maverick-400b-a17b",
        family="lm-moe",
        source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
        shapes=LM_SHAPES,
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        rope_theta=500000.0,
        max_seq_len=524288,
        moe_every=2,
        moe=MoEConfig(
            n_experts=128,
            top_k=1,
            n_shared=1,
            d_ff_expert=8192,
        ),
    )
